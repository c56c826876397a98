"""Port's ``Engine`` against the JAX package's ``Engine``, greedy, on the
debug preset with weights crossed by ``params_from_jax``: the admission
cases of tests/test_engine.py (a single request, concurrent requests,
scarce pages, int8 / fp8 pools); the scheduling cases are in
test_torch_engine_sched.py. The engine must give the JAX engine's tokens
exactly, and the bf16 one the port's own ``generate`` tokens.

The prompts are seeded. The head's output is rounded to bf16, so at vocab
512 two logits can tie at the top, and then summation order picks the
token: the concurrent case's prompts of seed 2 have such a tie at step 2
(tokens 333 and 453 both at 2.890625), so seed 12 is used. An int8 / fp8
pool turns a one-ulp bf16 difference in K or V into a whole quantization
step, so their seed (15) is one where no greedy step sits that close."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import engine as je
from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import (
    ModelConfig as TModelConfig)
from ggml_cuda_experiments_tpu_torch.models import engine as te
from ggml_cuda_experiments_tpu_torch.models import llama as tl

CFG = dataclasses.replace(PRESETS["debug"], fuse_mlp=False, fuse_attn=False,
                          fuse_layer=False)
TCFG = TModelConfig(**dataclasses.asdict(CFG))      # the port's twin


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=11)
    return jp, convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), TCFG, device="cpu")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in sizes]


def _serve(engine_cls, p, prompts, new, **kw):
    eng = engine_cls(p, TCFG if engine_cls is te.Engine else CFG, **kw)
    rids = [eng.add_request(pr, max_new_tokens=new) for pr in prompts]
    out = eng.run_to_completion()
    assert len(eng.allocator.free) == kw["n_pages"] - 1, "pages leaked"
    return [out[r] for r in rids]


def _both(params, prompts, new, **kw):
    jp, tp = params
    got = _serve(te.Engine, tp, prompts, new, **kw)
    want = _serve(je.Engine, jp, prompts, new, **kw)
    assert got == want, f"port {got} vs jax {want}"
    return got


def _generate(tp, prompt, steps):
    return tl.generate(tp, TCFG, torch.tensor([prompt]), steps)[0].tolist()


KW = dict(max_batch=2, page_size=32, n_pages=64, max_seq_len=256)


def test_single_request(params):
    (prompt,) = _prompts(1, [12])
    (got,) = _both(params, [prompt], 6, **KW)
    assert got == _generate(params[1], prompt, 6)


def test_concurrent_requests(params):
    prompts = _prompts(12, [5, 12, 9])
    got = _both(params, prompts, 5, **dict(KW, max_batch=4))
    assert got == [_generate(params[1], p, 5) for p in prompts]


def test_admission_when_pages_scarce(params):
    """5 requests, 2 usable pages of 32: later requests wait, pages
    recycle, every request completes."""
    prompts = _prompts(3, [8] * 5)
    got = _both(params, prompts, 4, max_batch=2, page_size=32, n_pages=3,
                max_seq_len=32)
    assert got == [_generate(params[1], p, 4) for p in prompts]


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_pool(params, fmt):
    (prompt,) = _prompts(15, [10])
    (got,) = _both(params, [prompt], 5, quantized_kv=fmt, **KW)
    assert len(got) == 5


def test_eos_stops_a_request(params):
    """With ``eos_id`` the engine fetches every step and ends a request at
    the first EOS it decodes (kept in its tokens; the prefill's token is
    not checked), as the JAX engine does."""
    prompts = _prompts(12, [5, 12])
    free_run = _serve(te.Engine, params[1], prompts, 6, **KW)
    eos = free_run[0][2]
    got = _both(params, prompts, 6, eos_id=eos, **KW)
    assert got[0] == free_run[0][:free_run[0].index(eos, 1) + 1]


def test_unported_options_raise(params):
    # the native scheduler is ported (tests/test_torch_native_sched.py);
    # a decode window with it is not, as in the reference
    with pytest.raises(ValueError, match="decode_window"):
        te.Engine(params[1], TCFG, scheduler="native", decode_window=4,
                  **KW)
    # mesh= is ported (tests/test_torch_engine_tp.py); chunked prefill with
    # a mesh is not, as in the reference
    with pytest.raises(ValueError, match="mesh"):
        te.Engine(params[1], TCFG, mesh=object(), prefill_chunk=32, **KW)
