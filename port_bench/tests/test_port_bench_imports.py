"""Nothing the benchmark imports is JAX or the JAX package, compared by
whole top-level module name: the port, whose name begins with the JAX
package's, passes."""

import ast
import subprocess
import sys

from bench_fixture import REPO

BANNED = {"jax", "jaxlib", "flax", "ggml_cuda_experiments_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_in_the_sources():
    found = {}
    for path in (REPO / "port_bench").rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        if tops & BANNED:
            found[str(path)] = tops & BANNED
    assert not found
    # the rule compares whole names: the port's own name passes
    assert "ggml_cuda_experiments_tpu_torch".split(".")[0] not in BANNED


def test_no_jax_once_loaded():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run\n"
        "from port_bench.lib import context, judge, reference, system, "
        "trace, traffic, work\n"
        "import ggml_cuda_experiments_tpu_torch.models.llama\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set(%r)))\n"
        "print(run.jax_loaded())\n"
        % (str(REPO / "port_bench"), str(REPO), sorted(BANNED)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.split() == ["[]", "[]"]
