"""The port's MoE layer (``models/moe.py``) and the MoE branches of its model,
oracle and checkpoint reader, against the JAX package's, on the CPU (JAX's
Pallas kernels interpreted, the port's wrappers on their plain versions).

Tolerances: ``router_topk`` 1e-6 with the same kept set; ``moe_mlp`` on
f32 dense experts 2e-4 (tests/test_moe.py's bound against its oracle); on
q4_k experts quantized identically in both packages, one row (the
matvecs, f32 activations) 1e-3 * max and eight rows (the bf16 GEMM)
2e-2 * max; the oracle forward 1e-5 * max (f32 NumPy in both, summation
order only); a 2-layer ``moe-debug`` model on f32 weights token for token
against JAX ``generate``, its logits within 1e-4 * max on f32 caches."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models import moe as jm
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.oracle import model as jom
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu.utils import gguf as jg
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models import moe as tm
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm
from ggml_cuda_experiments_tpu_torch.oracle import model as tom
from ggml_cuda_experiments_tpu_torch.utils import gguf as tg

CFG = PRESETS["moe-debug"]
TCFG = ModelConfig(**dataclasses.asdict(CFG))
EXPERTS = ("w_gate", "w_up", "w_down")


def _np_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


@pytest.fixture(scope="module")
def f32_params():
    """(JAX f32 MoE tree, the port's f32 tree of the same weights)."""
    jp = jm.init_moe_weights(CFG, seed=3, dtype=jnp.float32)
    return jp, convert.params_from_jax(_np_tree(jp), TCFG, device="cpu",
                                       dtype=torch.float32)


def test_router_topk(rng):
    logits = rng.normal(size=(3, 5, CFG.n_experts)).astype(np.float32)
    want = np.asarray(jm.router_topk(jnp.asarray(logits), 2))
    got = tm.router_topk(torch.from_numpy(logits), 2).numpy()
    assert np.array_equal(got > 0, want > 0)
    assert np.all((got > 0).sum(-1) == 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)


def test_init_moe_weights_tree():
    p = tm.init_moe_weights(TCFG, seed=1, device="cpu")
    E, d, inter = CFG.n_experts, CFG.dim, CFG.intermediate
    for layer in p["layers"]:
        assert tuple(layer["router"].shape) == (E, d)
        assert tuple(layer["w_gate"].shape) == (E, inter, d)
        assert tuple(layer["w_up"].shape) == (E, inter, d)
        assert tuple(layer["w_down"].shape) == (E, d, inter)
        assert layer["w_gate"].dtype == torch.bfloat16
    again = tm.init_moe_weights(TCFG, seed=1, device="cpu")
    assert torch.equal(again["layers"][1]["w_down"], p["layers"][1]["w_down"])


def test_moe_mlp_dense_matches_jax(rng, f32_params):
    jp, tp = f32_params
    x = rng.normal(size=(2, 4, CFG.dim)).astype(np.float32)
    want = np.asarray(jm.moe_mlp(jp["layers"][0], CFG, jnp.asarray(x)))
    got = tm.moe_mlp(tp["layers"][0], TCFG, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    oracle = tm.moe_mlp_oracle(tp["layers"][0], TCFG, x)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def q4k_layer(f32_params):
    """Layer 0's experts quantized to q4_k expert by expert and stacked, in
    both packages (``quantize`` + ``stack_expert_quant``)."""
    jp, tp = f32_params
    jlay, tlay = dict(jp["layers"][0]), dict(tp["layers"][0])
    for key in EXPERTS:
        jlay[key] = jm.stack_expert_quant(
            [jqm.quantize(np.asarray(w, np.float32), "q4_k")
             for w in jp["layers"][0][key]])
        tlay[key] = tm.stack_expert_quant(
            [tqm.quantize(w, "q4_k") for w in tp["layers"][0][key]])
    return jlay, tlay


def test_stacked_quant_linear(q4k_layer):
    jlay, tlay = q4k_layer
    w = tlay["w_down"]
    E = CFG.n_experts
    assert w.shape == (CFG.dim, CFG.intermediate)
    assert w.array_shape == (CFG.dim, CFG.intermediate)
    assert tuple(w.qs.shape) == (E, CFG.dim, CFG.intermediate // 2)
    assert tm.n_local_experts(w) == E
    total = 0
    for e in range(E):
        s = tm._expert_slice(w, e)
        assert s.qs.dim() == 2 and s.qs.is_contiguous()
        assert s.qs.data_ptr() == w.qs[e].data_ptr()     # a view
        tqm._check_ql(s, s.qs.device)                    # what kernels take
        total += s.nbytes
        want = np.asarray(jqm.dequantize_jnp(jm._expert_slice(
            jlay["w_down"], e)))
        assert np.array_equal(tqm.dequantize(s).numpy(), want)
    assert total == w.nbytes
    with pytest.raises(ValueError):                       # the stack itself
        tqm._check_ql(w, w.qs.device)
    with pytest.raises(ValueError):
        tm.stack_expert_quant([tqm.quantize(torch.zeros(8, 256), "q4_k"),
                               tqm.quantize(torch.zeros(8, 256), "q8_0")])


@pytest.mark.parametrize("rows,tol", [(1, 1e-3), (8, 2e-2)],
                         ids=["matvec", "gemm"])
def test_moe_mlp_q4k_matches_jax(rng, q4k_layer, rows, tol):
    jlay, tlay = q4k_layer
    x = rng.normal(size=(rows, CFG.dim)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jm.moe_mlp(jlay, CFG, xb), np.float32)
    got = tm.moe_mlp(tlay, TCFG, torch.from_numpy(x).to(torch.bfloat16))
    got = got.float().numpy()
    assert got.shape == want.shape == (rows, CFG.dim)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


def test_oracle_forward_matches_jax(rng, f32_params, q4k_layer):
    jp, tp = f32_params
    tokens = rng.integers(0, CFG.vocab_size, (2, 6)).astype(np.int32)
    want = jom.forward_logits(jp, CFG, tokens)
    got = tom.forward_logits(tp, TCFG, torch.from_numpy(tokens))
    assert got.shape == (2, 6, CFG.vocab_size)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    # stacked quantized experts: the port's oracle dequantizes each expert;
    # the JAX oracle takes only dense stacks (its moe_mlp_oracle indexes
    # the leaf), so it gets JAX's dequantization of the same experts
    jlay = dict(q4k_layer[0])
    for key in EXPERTS:
        jlay[key] = np.stack([
            np.asarray(jqm.dequantize_jnp(jm._expert_slice(jlay[key], e)))
            for e in range(CFG.n_experts)])
    jq = dict(jp, layers=[jlay, *jp["layers"][1:]])
    tq_ = dict(tp, layers=[q4k_layer[1], *tp["layers"][1:]])
    want = jom.forward_logits(jq, CFG, tokens)
    got = tom.forward_logits(tq_, TCFG, torch.from_numpy(tokens))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_generate_matches_jax_and_scan(rng, f32_params):
    """The 2-layer moe-debug model on f32 weights: greedy ``generate``
    (batch 2, 8-token prompts, 4 steps) token for token against JAX's, the
    prefill and decode logits within 1e-4 * max on f32 caches;
    ``generate_scan`` equal to ``generate``."""
    jp, tp = f32_params
    prompt = rng.integers(0, CFG.vocab_size, (2, 8)).astype(np.int32)
    want = np.asarray(jl.generate(jp, CFG, jnp.asarray(prompt), steps=4))
    got = tl.generate(tp, TCFG, torch.from_numpy(prompt).long(), steps=4)
    assert np.array_equal(got, want)
    cache = tl.KVCache.create(TCFG, 2, 64, device="cpu")
    scan = tl.generate_scan(tp, TCFG, torch.from_numpy(prompt).long(), cache,
                            4)
    assert np.array_equal(scan, got)

    # f32 caches: the two decode attentions differ in where they round to
    # bf16 (about 1e-3 of max on a bf16 cache)
    jc = jl.KVCache.create(CFG, 2, 64, dtype=jnp.float32)
    tc = tl.KVCache.create(TCFG, 2, 64, dtype=torch.float32, device="cpu")
    jlog, jc = jl.prefill(jp, CFG, jnp.asarray(prompt), jc)
    tlog, tc = tl.prefill(tp, TCFG, torch.from_numpy(prompt).long(), tc)
    for step in range(3):
        j, t = np.asarray(jlog), tlog.numpy()
        assert np.abs(t - j).max() <= 1e-4 * np.abs(j).max(), step
        tok = want[:, step]
        jlog, jc = jl.decode_step(jp, CFG, jnp.asarray(tok), jc)
        tlog, tc = tl.decode_step(tp, TCFG, torch.from_numpy(tok), tc)


def test_quantize_params_refuses_moe(f32_params):
    """The reference fails on MoE layers (it unpacks a stacked weight):
    the port refuses them and names the way to quantized experts."""
    _, tp = f32_params
    with pytest.raises(NotImplementedError, match="stack_expert_quant"):
        tl.quantize_params(tp, "q4_k")


# ---------------------------------------------------------------------------
# a MoE GGUF file
# ---------------------------------------------------------------------------

_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v", "wo": "attn_output",
          "attn_norm": "attn_norm", "mlp_norm": "ffn_norm",
          "router": "ffn_gate_inp", "w_gate": "ffn_gate_exps",
          "w_up": "ffn_up_exps", "w_down": "ffn_down_exps"}


def _stacked_blocks(w, fmt):
    """Per-expert oracle blocks of w [E, N, K], stacked field by field into
    one [E, N, K] block tensor (what a GGUF writer takes)."""
    parts = [tqm.quantize_blocks(we, fmt) for we in w]
    return dataclasses.replace(parts[0], shape=tuple(w.shape), **{
        f.name: torch.stack([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(parts[0]) if f.name != "shape"})


# each layer's expert stacks' formats (None: f32)
_EXPERT_FMTS = ({"w_gate": "q4_k", "w_up": "q4_k", "w_down": "q4_k"},
                {"w_gate": "q6_k", "w_up": None, "w_down": "q8_0"})


def test_load_gguf_moe(tmp_path, f32_params):
    """A moe-debug file: layer 0's experts q4_k stacks, layer 1's a q6_k,
    an f32 and a q8_0 stack, the router and every other tensor f32. The
    port loads every quantized expert bit-equal to the same expert
    quantized directly and the f32 stack as dense bf16, and the model
    runs (its prefill within 2e-2 * max of the oracle forward on the loaded
    weights); JAX's reader fails on the quantized stacks (ROADMAP
    C.3.11)."""
    _, tp = f32_params
    tensors = {"token_embd.weight": tp["embed"],
               "output_norm.weight": tp["final_norm"],
               "output.weight": tp["lm_head"]}
    for i, layer in enumerate(tp["layers"]):
        for key, w in layer.items():
            if key in EXPERTS and _EXPERT_FMTS[i][key]:
                w = _stacked_blocks(w, _EXPERT_FMTS[i][key])
            elif key in ("wq", "wk"):
                w = tg.permute_qk(w, CFG.n_heads if key == "wq"
                                  else CFG.n_kv_heads)
            tensors[f"blk.{i}.{_NAMES[key]}.weight"] = w
    md = {**tg._llama_metadata(TCFG), "llama.expert_count": CFG.n_experts,
          "llama.expert_used_count": CFG.n_active_experts}
    path = str(tmp_path / "moe.gguf")
    tg.write_gguf(path, tensors, md)

    params, cfg = tg.load_gguf(path, device="cpu")
    assert cfg.n_experts == CFG.n_experts and cfg.is_moe
    for i, (got, src) in enumerate(zip(params["layers"], tp["layers"])):
        assert got["router"].dtype == torch.bfloat16
        assert torch.equal(got["router"].float(),
                           src["router"].to(torch.bfloat16).float())
        for key in EXPERTS:
            w, fmt = got[key], _EXPERT_FMTS[i][key]
            assert tm.n_local_experts(w) == CFG.n_experts
            if fmt is None:
                assert w.dtype == torch.bfloat16
                assert torch.equal(w, src[key].to(torch.bfloat16))
                continue
            assert w.fmt == fmt
            for e in range(CFG.n_experts):
                want = tqm.quantize(src[key][e], w.fmt)
                have = tm._expert_slice(w, e)
                for f in ("qs", "es", "em", "qh", "d"):
                    a, b = getattr(have, f), getattr(want, f)
                    assert (a is None) == (b is None), f
                    assert a is None or torch.equal(a, b), (i, key, e, f)
    tokens = torch.arange(1, 9)[None]
    want = tom.forward_logits(params, cfg, tokens)[:, -1]
    got, _ = tl.prefill(params, cfg, tokens,
                        tl.KVCache.create(cfg, 1, 64, device="cpu"))
    assert np.abs(got.numpy() - want).max() <= 2e-2 * np.abs(want).max()
    with pytest.raises(ValueError):
        jg.load_gguf(path)
