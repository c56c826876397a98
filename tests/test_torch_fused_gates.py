"""Gate parity: for every ``ModelConfig`` flag combination (x_quant8,
fuse_attn, fuse_mlp, fuse_layer, hperm) at the debug, tinyllama-1.1b,
llama2-7b, llama3-8b and llama2-70b shapes, the port's batch-1 decode
step takes the JAX package's branch: the same fused kernels, or the same
unfused products, in the same order.

Decided from shapes, no kernel runs: both packages' ``quantize_params``
run with their quantizer swapped for one that makes an empty weight of the
right shape (the JAX one keeps its ``layout``), and one decode step of
each ``_forward`` runs with its kernel entry points swapped for recorders
that return zeros. The vocabulary is cut to 512 and the depth to one
layer: neither enters a gate. With q4_k's s6 encoding both packages shut
the layer kernel and keep the fused attention and the fused MLP open."""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS as JPRESETS
from ggml_cuda_experiments_tpu.ops import fused_attention as jfa
from ggml_cuda_experiments_tpu.ops import layer_kernel as jlk
from ggml_cuda_experiments_tpu.ops import quant_matmul as jqm
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as tlk
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as tqm

SHAPES = ("debug", "tinyllama-1.1b", "llama2-7b", "llama3-8b", "llama2-70b")
FLAGS = ("x_quant8", "fuse_attn", "fuse_mlp", "fuse_layer", "hperm")


def _cut(cfg):
    return cfg.__class__(**{**vars(cfg), "vocab_size": 512, "n_layers": 1})


def _dense(cfg, zeros):
    """A dense tree of zero views (nothing materialized)."""
    d, hd = cfg.dim, cfg.head_dim
    shapes = {"wq": (cfg.n_heads * hd, d), "wk": (cfg.n_kv_heads * hd, d),
              "wv": (cfg.n_kv_heads * hd, d), "wo": (d, cfg.n_heads * hd),
              "w_gate": (cfg.intermediate, d), "w_up": (cfg.intermediate, d),
              "w_down": (d, cfg.intermediate), "attn_norm": (d,),
              "mlp_norm": (d,)}
    return {"embed": zeros(cfg.vocab_size, d),
            "layers": [{k: zeros(*s) for k, s in shapes.items()}],
            "final_norm": zeros(d), "lm_head": zeros(cfg.vocab_size, d)}


def _rows(w):
    """Output rows of a quantized or dense (the unquantized head) weight."""
    return w.array_shape[0] if hasattr(w, "array_shape") else w.shape[0]


# ------------------------------------------------------------------ JAX

def _np_zeros(*shape):
    return np.broadcast_to(np.float32(0), shape)


def _jax_tree(cfg, monkeypatch, enc="e"):
    def quantize(w, fmt, layout="std"):
        n, k = w.shape
        qs = np.broadcast_to(np.uint8(0), (n, k // 2))
        if enc == "s6":
            return jqm.QuantLinear(
                fmt=fmt, shape=(n, k), layout=layout, enc="s6", qs=qs,
                es=np.broadcast_to(np.int8(0), (n, k // 16)),
                d=_np_zeros(n, k // 128))
        return jqm.QuantLinear(fmt=fmt, shape=(n, k), layout=layout, qs=qs,
                               es=_np_zeros(n, k // 32),
                               em=_np_zeros(n, k // 32))

    def pad(w, widths):
        return _np_zeros(*(s + a + b for s, (a, b) in zip(w.shape, widths)))

    def concatenate(ws, axis=0):
        return _np_zeros(sum(w.shape[0] for w in ws), ws[0].shape[1])

    shim = types.SimpleNamespace(asarray=np.asarray, float32=np.float32,
                                 pad=pad, concatenate=concatenate)
    with monkeypatch.context() as m:
        m.setattr(jl, "quantize", quantize)
        m.setattr(jl, "np", shim)
        m.setattr(jqm, "reorder_gu_rows",
                  lambda g, u: _np_zeros(2 * g.shape[0], g.shape[1]))
        return jl.quantize_params(_dense(cfg, _np_zeros), "q4_k",
                                  quantize_head=False)


def _jax_step(params, cfg, monkeypatch, quantized=False):
    calls = []
    D = cfg.head_dim

    def linear(x, w, xq8=False, x_prepermuted=False):
        n = _rows(w)
        calls.append(("linear", n, bool(xq8)))
        return jnp.zeros(x.shape[:-1] + (n,), x.dtype)

    def record(name, out):
        def fn(*a, **kw):
            calls.append((name,))
            return out()
        return fn

    L, hkv = cfg.n_layers, cfg.n_kv_heads
    with monkeypatch.context() as m:
        m.setattr(jl, "apply_linear", linear)
        m.setattr(jl, "flash_decode", lambda q, *a, **kw: (
            calls.append(("flash_decode",)), jnp.zeros_like(q))[1])
        m.setattr(jfa, "attention_fused", record("attention_fused", lambda: (
            jnp.zeros((1, cfg.dim)), jnp.zeros((hkv, D), jnp.bfloat16),
            jnp.zeros((hkv, D), jnp.bfloat16))))
        m.setattr(jqm, "mlp_fused", record("mlp_fused", lambda: jnp.zeros(
            (1, cfg.dim))))
        m.setattr(jlk, "model_step", record("model_step", lambda: (
            jnp.zeros((1, cfg.dim)), jnp.zeros((L, hkv, D)),
            jnp.zeros((L, hkv, D)))))
        m.setattr(jlk, "layer_step", record("layer_step", lambda: (
            jnp.zeros((1, cfg.dim)), jnp.zeros((hkv, D)),
            jnp.zeros((hkv, D)))))
        cache = jl.KVCache.create(cfg, 1, 256, quantized=quantized)
        jl._forward(params, cfg, jnp.zeros((1, 1), jnp.int32), cache,
                    cache.lengths[:, None], decode=True)
    return calls


# ----------------------------------------------------------------- port

def _t_zeros(*shape):
    return torch.zeros(()).expand(*shape)


def _port_tree(cfg, monkeypatch, enc="e"):
    def quantize(w, fmt="q4_k"):
        n, k = w.shape
        qs = torch.empty((n, k // 2), dtype=torch.uint8)
        if enc == "s6":
            return tqm.QuantLinear(
                fmt=fmt, shape=(n, k), enc="s6", qs=qs,
                es=torch.empty((n, k // 16), dtype=torch.int8),
                d=torch.empty((n, k // 128), dtype=torch.bfloat16))
        return tqm.QuantLinear(fmt=fmt, shape=(n, k), qs=qs,
                               es=torch.empty((n, k // 32),
                                              dtype=torch.bfloat16),
                               em=torch.empty((n, k // 32),
                                              dtype=torch.bfloat16))

    def pad(w, widths):                       # F.pad: last dim first
        widths = tuple(widths) + (0, 0)
        return _t_zeros(w.shape[0] + widths[2] + widths[3],
                        w.shape[1] + widths[0] + widths[1])

    def cat(ws):
        return _t_zeros(sum(w.shape[0] for w in ws), ws[0].shape[1])

    with monkeypatch.context() as m:
        m.setattr(tl, "quantize", quantize)
        m.setattr(tl, "torch", types.SimpleNamespace(cat=cat))
        m.setattr(tl, "F", types.SimpleNamespace(pad=pad))
        params = tl.quantize_params(_dense(cfg, _t_zeros), "q4_k",
                                    quantize_head=False)
    for lay in params["layers"]:              # the kernel table reads these
        lay["attn_norm"] = torch.zeros(cfg.dim, dtype=torch.bfloat16)
        lay["mlp_norm"] = torch.zeros(cfg.dim, dtype=torch.bfloat16)
    return params


def _port_step(params, cfg, monkeypatch, quantized=False):
    calls = []
    D = cfg.head_dim

    def linear(x, w, xq8=False, x_prepermuted=False):
        n = _rows(w)
        calls.append(("linear", n, bool(xq8)))
        return torch.zeros(x.shape[:-1] + (n,), dtype=x.dtype)

    def record(name, out):
        def fn(*a, **kw):
            calls.append((name,))
            return out()
        return fn

    L, hkv = cfg.n_layers, cfg.n_kv_heads
    with monkeypatch.context() as m:
        m.setattr(tl, "apply_linear", linear)
        m.setattr(tl, "flash_decode", lambda q, *a, **kw: (
            calls.append(("flash_decode",)), torch.zeros_like(q))[1])
        m.setattr(tl, "attention_fused", record("attention_fused", lambda: (
            torch.zeros((1, cfg.dim)),
            torch.zeros((hkv, D), dtype=torch.bfloat16),
            torch.zeros((hkv, D), dtype=torch.bfloat16))))
        m.setattr(tl, "mlp_fused", record("mlp_fused", lambda: torch.zeros(
            (1, cfg.dim))))
        m.setattr(tlk, "model_step", record("model_step", lambda: (
            torch.zeros((1, cfg.dim)), torch.zeros((L, hkv, D)),
            torch.zeros((L, hkv, D)))))
        m.setattr(tlk, "layer_step", record("layer_step", lambda: (
            torch.zeros((1, cfg.dim)), torch.zeros((hkv, D)),
            torch.zeros((hkv, D)))))
        cache = tl.KVCache.create(cfg, 1, 256, quantized=quantized,
                                  device="cpu")
        tl._forward(params, cfg, torch.zeros((1, 1), dtype=torch.int64),
                    cache, cache.lengths[:, None].clone(), decode=True)
    return calls


def _trees(shape, monkeypatch, enc="e"):
    """(JAX, port) configs, and the trees by name: quantized, hperm (the
    deploy layout) and per_layer (the per-layer packs, no model pack; not
    for s6, which neither package packs)."""
    jcfg, tcfg = _cut(JPRESETS[shape]), _cut(PRESETS[shape])
    jq = _jax_tree(jcfg, monkeypatch, enc)
    tq = _port_tree(tcfg, monkeypatch, enc)
    jh = jl.permute_hidden_params(jq, jcfg)
    th = tl.permute_hidden_params(tq, tcfg)
    assert ("m_pack" in jh) == ("m_pack" in th)
    if enc == "s6":
        assert "m_pack" not in th
        return jcfg, tcfg, {"quantized": (jq, tq), "hperm": (jh, th)}
    jlay = dict({k: v for k, v in jh.items() if k != "m_pack"}, layers=[
        dict(lay, w_pack=jlk.pack_stream(lay["wqkv"], lay["wo"],
                                         lay["w_gu_f"]))
        if "w_gu_f" in lay else lay for lay in jh["layers"]])
    tlay = dict({k: v for k, v in th.items() if k != "m_pack"}, layers=[
        dict(lay, w_pack=tlk.pack_layers([lay])) for lay in th["layers"]])
    return jcfg, tcfg, {"quantized": (jq, tq), "hperm": (jh, th),
                        "per_layer": (jlay, tlay)}


def _branches(shape, monkeypatch, quantized=False, enc="e"):
    """Every flag combination through both packages' decode step (asserted
    equal); returns the set of branches taken (the calls other than the
    linears)."""
    jcfg, tcfg, trees = _trees(shape, monkeypatch, enc)
    branches = set()
    for values in itertools.product((False, True), repeat=len(FLAGS)):
        flags = dict(zip(FLAGS, values))
        jc = jcfg.__class__(**{**vars(jcfg), **flags})
        tc = tcfg.__class__(**{**vars(tcfg), **flags})
        for name, (jp, tp) in trees.items():
            if name != "quantized" and not flags["hperm"]:
                continue
            want = _jax_step(jp, jc, monkeypatch, quantized)
            got = _port_step(tp, tc, monkeypatch, quantized)
            assert got == want, (shape, flags, name, quantized)
            branches.add(tuple(c[0] for c in want if c[0] != "linear"))
    return branches


@pytest.mark.parametrize("shape", SHAPES)
def test_decode_branches_match_jax(shape, monkeypatch):
    branches = _branches(shape, monkeypatch)
    # dim 4096 reaches all six: unfused, fused MLP, fused attention, both,
    # model_step, layer_step; the small shapes and dim 8192 stay unfused
    assert len(branches) == (6 if PRESETS[shape].dim == 4096 else 1), \
        branches


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_cache_closes_the_fused_gates(fmt, monkeypatch):
    """An int8 / fp8 cache closes the fused attention and the layer kernel
    in both packages (their kernels read a bf16 cache); the fused MLP stays
    open. At llama2-7b's shape every flag combination then takes the
    unfused attention (flash_decode with scales), with or without the
    fused MLP."""
    branches = _branches("llama2-7b", monkeypatch, quantized=fmt)
    assert branches == {("flash_decode",), ("flash_decode", "mlp_fused")}


@pytest.mark.parametrize("shape", ["llama2-7b", "llama3-8b"])
def test_s6_shuts_only_the_layer_kernel(shape, monkeypatch):
    """s6 weights: in both packages no flag combination reaches
    model_step or layer_step (the layer kernel takes Q4_K-E only), while
    the fused attention and the fused MLP open as they do for Q4_K-E."""
    branches = _branches(shape, monkeypatch, enc="s6")
    assert branches == {("flash_decode",), ("flash_decode", "mlp_fused"),
                        ("attention_fused",),
                        ("attention_fused", "mlp_fused")}, branches
    lay = _port_tree(_cut(PRESETS[shape]), monkeypatch, "s6")["layers"][0]
    assert not tlk.fused_layout_ok(lay, 32, PRESETS[shape].n_kv_heads, 128,
                                   torch.bfloat16)
