"""The probe modes of ``tools/profile_decode.py`` on the CPU: each mode's
``--cpu`` plan and bounds, the argument checks, and the parts of each mode
that compute rather than time, held against the JAX package: the decode
``full`` variant against the port's ``decode_step`` (bitwise), each block
ablation's one-layer output against the same composition of the JAX
package's functions (its ``tools/layer_marginal.py``), each non-layer
stage's forced token against the JAX stage (its
``tools/nonlayer_probe.py``), and ``q4k_gemm``'s phases, whose plain
version takes "all" only. No time here is a device metric."""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pd

SEED = 3
# K = 4096 on wqkv and w_gu, so x_quant8 takes the int8-activation matvec
# there (wo's K = 512 and w_down's K = 256 stay exact): 4 heads of 128
ABL = dataclasses.replace(PRESETS["debug"], dim=4096, n_heads=4,
                          n_kv_heads=4, head_dim=128, intermediate=256,
                          n_layers=1)
POS = 5                         # the decode position of the ablation step


def _port(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _both(cfg, seed, quantize_head=True):
    jp = jl.init_weights(cfg, seed=seed)
    dn = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    tp = convert.params_from_jax(dn, _port(cfg), device="cpu")
    return (jl.quantize_params(jp, "q4_k", quantize_head=quantize_head),
            tl.quantize_params(tp, "q4_k", quantize_head=quantize_head))


@pytest.fixture(scope="module")
def ablation_params():
    return _both(ABL, SEED, quantize_head=False)     # one layer, no head


@pytest.fixture(scope="module")
def debug_params():
    cfg = dataclasses.replace(PRESETS["debug"], x_quant8=True)
    return (cfg,) + _both(cfg, SEED)


# ------------------------------------------------------------- the plans

PLANS = {
    "ladder": (["--ladder"], ["unfused (fuse_attn=False, fuse_mlp=False)",
                              "layer kernel (hperm + fuse_layer)"]),
    "layer-marginal": (["--layer-marginal", "--ablate"],
                       ["full layer", "attn_nofd layer", "mlp_mat layer",
                        "non-layer (the head)"]),
    "nonlayer": (["--nonlayer", "--head-fmt", "q6_k"],
                 ["scan", "head [q6_k head]", "argmax"]),
    "blocks": (["--blocks"], ["fused_mlp", "unfused attention"]),
    "embed": (["--embed", "512"], ["one-hot bf16 product",
                                   "row copies (a graph)"]),
    # 2 T N K at 989 TFLOP/s
    "pipe": (["--pipe"], ["K 4096, 8192 -> 24576 rows: dequant",
                          "bound    104.2257 us (operations)",
                          "K 12288, 4096 -> 12288 rows: torch.matmul"]),
    # 12288 x 4096 x 0.578125 bytes + x and y at 3.35 TB/s
    "s6": (["--enc", "s6"], ["linear wqkv [12288 x 4096] s6",
                             "bound      8.6957 us",
                             "int8 matvec K 4096, 8192 -> 32768 rows s6"]),
    "host": (["--host"], ["each extra launch of the chain"]),
}


@pytest.mark.parametrize("mode", sorted(PLANS))
def test_each_mode_plans_on_the_cpu(mode, capsys):
    argv, want = PLANS[mode]
    assert pd.main(["--cpu", "--model", "llama2-7b", *argv]) == 0
    out = capsys.readouterr().out
    assert "time not measured" in out
    for line in want:
        assert line in out, (line, out)


def test_the_plans_import_no_jax():
    """The tool, every mode's plan in one process: nothing of JAX."""
    code = (
        "import sys\n"
        "from ggml_cuda_experiments_tpu_torch.tools import profile_decode "
        "as pd\n"
        f"for argv in {[a for a, _ in PLANS.values()]!r}:\n"
        "    assert pd.main(['--cpu', '--model', 'llama2-7b', *argv]) == 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('ggml_cuda_experiments_tpu.')"
        " or m == 'ggml_cuda_experiments_tpu']\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("argv", [
    ["--ladder", "--pipe"], ["--prefill", "512", "--nonlayer"],
    ["--embed", "16", "--enc", "s6"], ["--ablate"],
    ["--nonlayer", "--ablate"], ["--head-fmt", "q6_k"],
    ["--pipe", "--fmt", "q8_0"], ["--enc", "s6", "--fmt", "q4_0"],
    ["--blocks", "--fmt", "q6_k"], ["--pipe", "--t", "32"],
    ["--embed", "-1"], ["--layer-marginal", "--batch", "2"],
    ["--blocks", "--dim", "1000"], ["--blocks", "--len", "1024"],
    ["--host", "--n", "0"], ["--pipe", "--pairs", "0"],
    ["--layer-marginal", "--model", "debug-1layer"]])
def test_parse_refuses_bad_combinations(argv):
    with pytest.raises(SystemExit):
        pd.parse(["--cpu", *argv])


def test_parse_names_the_mode():
    assert pd.parse([]).mode is None
    assert pd.parse(["--enc", "s6"]).mode == "enc"
    assert pd.parse(["--embed", "64"]).mode == "embed"
    assert pd.parse(["--layer-marginal", "--ablate"]).mode == \
        "layer_marginal"


# ------------------------------------------------- the decode variants

def test_the_full_decode_variant_is_decode_step(debug_params):
    cfg, _, tq = debug_params
    tc = _port(cfg)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        1, cfg.vocab_size, (1, 6)))
    a = tl.KVCache.create(tc, 1, 64, device="cpu")
    logits, a = tl.prefill(tq, tc, prompt, a)
    b = dataclasses.replace(a, k=a.k.clone(), v=a.v.clone(),
                            lengths=a.lengths.clone())
    tok = torch.argmax(logits, -1).to(torch.int32)
    want, a = tl.decode_step(tq, tc, tok, a)
    got = pd.decode_variant(tq, tc, tok, b, "full")
    assert torch.equal(got, want)
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    assert torch.equal(a.lengths, b.lengths)


def _jax_ablated_layer(layer, cfg, h, cache, li, positions, mode):
    """JAX ``tools/layer_marginal.py``'s ablations (``attn_ablate``,
    ``mlp_mat``), composed of the JAX package's functions as it does."""
    if mode == "mlp_mat":
        x = jl.rms_norm(h, layer["mlp_norm"], cfg.rms_eps)
        gate, up = jl.gate_up_proj(layer, x, xq8=cfg.x_quant8)
        return h + jl.apply_linear(up + 1e-6 * gate, layer["w_down"],
                                   xq8=cfg.x_quant8), cache
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = jl.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = jl.qkv_proj(layer, x, cfg)
    q = q.reshape(B, T, Hq, D)
    if mode == "attn_nofd":
        k = k.reshape(B, T, Hkv, D)
        q = jl.rope(q, positions, cfg.rope_theta)
        k = jl.rope(k, positions, cfg.rope_theta)
        kt = k.transpose(0, 2, 1, 3)
        vt = v.reshape(B, T, Hkv, D).transpose(0, 2, 1, 3)
        pos0 = positions[:, 0]
        cache = dataclasses.replace(
            cache, k=jl._write_cache_layer(cache.k, li, kt, pos0),
            v=jl._write_cache_layer(cache.v, li, vt, pos0))
    o = (q + 1e-6 * jnp.sum(v)).reshape(B, T, Hq * D)
    return h + jl.apply_linear(o.astype(h.dtype), layer["wo"],
                               xq8=cfg.x_quant8), cache


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


@pytest.mark.parametrize("xq8", [False, True])
@pytest.mark.parametrize("mode", pd.ABLATIONS)
def test_each_ablation_layer_matches_the_jax_composition(
        ablation_params, mode, xq8):
    jq, tq = ablation_params
    jc = dataclasses.replace(ABL, x_quant8=xq8)
    tc = _port(jc)
    h = np.random.default_rng(SEED + 1).normal(
        size=(1, 1, ABL.dim)).astype(np.float32)
    jh = jnp.asarray(h, jnp.bfloat16)
    th = torch.from_numpy(h).to(torch.bfloat16)
    jcache = jl.KVCache.create(jc, 1, 64)
    tcache = tl.KVCache.create(tc, 1, 64, device="cpu")
    jpos = jnp.full((1, 1), POS, jnp.int32)
    tpos = torch.full((1, 1), POS, dtype=torch.int32)
    want, jcache = _jax_ablated_layer(jq["layers"][0], jc, jh, jcache, 0,
                                      jpos, mode)
    got = pd._ablated_layer(tq["layers"][0], tc, th, tcache, 0, tpos, mode,
                            decode=True)
    tol = 3e-2 if xq8 else 2e-2          # the JAX int8-activation bound
    _close(got.float().numpy(), want, tol)
    if mode == "attn_nofd":             # the roped k and v it wrote
        for j, t in ((jcache.k, tcache.k), (jcache.v, tcache.v)):
            _close(t[0, 0, :, POS].float().numpy(), np.asarray(
                j[0, 0, :, POS], np.float32), tol)
            assert not t[0, 0, :, :POS].any()


# ------------------------------------------------- the non-layer stages

def _jax_stage(nl, cfg, tok, stage, head):
    """JAX ``tools/nonlayer_probe.py``'s step up to ``stage``: the next
    token."""
    V = cfg.vocab_size
    if stage == "scan":
        return (tok + 1) % V
    h = nl["embed"][tok[:, None]]
    if stage == "embed":
        s = jnp.sum(h.astype(jnp.float32))
        return (tok + 1 + s.astype(jnp.int32)) % V
    h = jl.rms_norm(h, nl["final_norm"], cfg.rms_eps)
    if stage == "norm":
        s = jnp.sum(h.astype(jnp.float32))
        return (tok + 1 + s.astype(jnp.int32)) % V
    logits = jl.apply_linear(h[:, -1], head, xq8=cfg.x_quant8)
    if stage == "head":
        s = jnp.sum(logits.astype(jnp.float32))
        return (tok + 1 + s.astype(jnp.int32)) % V
    return jnp.argmax(logits, -1).astype(jnp.int32)


@pytest.mark.parametrize("stage", pd.STAGES)
def test_each_nonlayer_stage_forces_the_jax_stages_token(debug_params,
                                                         stage):
    cfg, jq, tq = debug_params
    tc = _port(cfg)
    for t0 in (0, 77, 300, cfg.vocab_size - 1):
        tok = torch.tensor([t0], dtype=torch.int32)
        lengths = torch.zeros((1,), dtype=torch.int32)
        pd.stage_step(tq, tc, tok, lengths, stage, tq["lm_head"])
        want = _jax_stage(jq, cfg, jnp.asarray([t0], jnp.int32), stage,
                          jq["lm_head"])
        assert int(tok[0]) == int(want[0]), (stage, t0)
        assert int(lengths[0]) == 1


# ------------------------------------------------------ the GEMM phases

def test_the_gemm_phases_plain_version_takes_all_only():
    rng = np.random.default_rng(SEED)
    ql = tqm.quantize(torch.from_numpy(rng.normal(size=(64, 512)).astype(
        np.float32)), "q4_k")
    x = torch.from_numpy(rng.normal(size=(40, 512)).astype(
        np.float32)).to(torch.bfloat16)
    assert torch.equal(tqm.q4k_gemm(x, ql, phase="all"), tqm.q4k_gemm(x, ql))
    before = dict(tqm.LAUNCHES)
    for phase in ("dequant", "dot", "stream", "both"):
        with pytest.raises(ValueError):
            tqm.q4k_gemm(x, ql, phase=phase)
    assert tqm.LAUNCHES == before
    assert set(tqm.GEMM_PHASES) == {"all", "dequant", "dot", "stream"}
