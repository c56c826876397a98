"""Port's ``rope_pack_prefill`` plain version against the JAX
``rope_pack_prefill`` (Pallas ``_rope_pack_kernel``, interpret mode on the
CPU), and the prefill route through it. Tolerance 2e-2 absolute on bf16
outputs of unit-normal inputs, as tests/test_prefill_fuse.py holds the JAX
kernel against its jnp reference; against the port's own unfused RoPE the
plain version is exact (same f32 tables, same rounding points)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import ModelConfig
from ggml_cuda_experiments_tpu.ops.prefill_fuse import (
    rope_pack_prefill as jrp)
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import (
    PRESETS, ModelConfig as TModelConfig)
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as tpf

# head_dim 128 so that the prefill gate opens; unfused like the port
CFG = ModelConfig(name="pf-test", vocab_size=512, dim=512, n_layers=2,
                  n_heads=4, n_kv_heads=2, intermediate=512, head_dim=128,
                  max_seq_len=512, fuse_mlp=False, fuse_attn=False,
                  fuse_layer=False)
TCFG = TModelConfig(**dataclasses.asdict(CFG))      # the port's twin


def _y(T, nh, nkv, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(T, (nh + 2 * nkv) * 128)).astype(np.float32)


@pytest.mark.parametrize("nh,nkv", [(4, 2), (8, 8)])
@pytest.mark.parametrize("T", [128, 256])
def test_rope_pack_matches_jax(T, nh, nkv):
    y = _y(T, nh, nkv)
    pos = np.arange(T, dtype=np.int32)
    want = jrp(jnp.asarray(y, jnp.bfloat16), jnp.asarray(pos), n_heads=nh,
               n_kv_heads=nkv, head_dim=128)
    got = tpf.rope_pack_prefill(
        torch.from_numpy(y).to(torch.bfloat16), torch.from_numpy(pos),
        n_heads=nh, n_kv_heads=nkv, head_dim=128)
    for g, w, name, h in zip(got, want, "qkv", (nh, nkv, nkv)):
        assert g.dtype == torch.bfloat16 and g.shape == (h, T, 128), name
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()
        assert err < 2e-2, (name, err)


@pytest.mark.parametrize("T,nh,nkv", [(128, 4, 2), (256, 8, 8), (384, 8, 2)])
def test_rope_pack_with_tables_matches_jax(T, nh, nkv):
    """The tables made once (``rope_tables``, as a prefill hands them to
    every layer) give the same bits as the call that makes its own, and
    both match the JAX kernel as the call without them does."""
    y = _y(T, nh, nkv, seed=7)
    pos = np.arange(T, dtype=np.int32)
    want = jrp(jnp.asarray(y, jnp.bfloat16), jnp.asarray(pos), n_heads=nh,
               n_kv_heads=nkv, head_dim=128)
    yt, pt = torch.from_numpy(y).to(torch.bfloat16), torch.from_numpy(pos)
    kw = dict(n_heads=nh, n_kv_heads=nkv, head_dim=128)
    built = tpf.rope_pack_prefill(yt, pt, **kw)
    given = tpf.rope_pack_prefill(yt, pt, **kw,
                                  tables=tpf.rope_tables(pt, 128, 10000.0))
    for b, g, w in zip(built, given, want):
        assert torch.equal(b, g)
        err = np.abs(g.float().numpy() - np.asarray(w, np.float32)).max()
        assert err < 2e-2, err


def test_rope_pack_refuses_tables_of_another_shape():
    y = torch.from_numpy(_y(128, 4, 2)).to(torch.bfloat16)
    pos = torch.arange(128, dtype=torch.int32)
    C, S2 = tpf.rope_tables(pos[:64], 128, 10000.0)
    with pytest.raises(ValueError, match="tables"):
        tpf.rope_pack_prefill(y, pos, n_heads=4, n_kv_heads=2, head_dim=128,
                              tables=(C, S2))


def test_rope_pack_equals_unfused_rope_exactly():
    T, nh, nkv, D = 128, 4, 2, 128
    y = torch.from_numpy(_y(T, nh, nkv, seed=5)).to(torch.bfloat16)
    pos = torch.arange(40, 40 + T, dtype=torch.int32)
    q, k, v = tpf.rope_pack_prefill(y, pos, n_heads=nh, n_kv_heads=nkv,
                                    head_dim=D, rope_theta=500000.0)
    heads = y.reshape(1, T, nh + 2 * nkv, D)
    want = tl.rope(heads[:, :, :nh + nkv], pos[None], 500000.0)[0]
    assert torch.equal(q, want[:, :nh].transpose(0, 1))
    assert torch.equal(k, want[:, nh:].transpose(0, 1))
    assert torch.equal(v, heads[0, :, nh + nkv:].transpose(0, 1))


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=9)
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), TCFG, device="cpu")
    return jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")


def test_prefill_takes_rope_pack_at_t128_only(params, monkeypatch):
    """The reference's gate (B = 1, T % 128 == 0, D = 128, fused wqkv):
    one rope_pack per layer at T = 128, none at T = 8; the T = 128 logits
    agree with the JAX prefill, which takes its own fused kernel there."""
    jq, tq = params
    calls = []

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return tpf.rope_pack_prefill(*a, **kw)

    monkeypatch.setattr(tl, "rope_pack_prefill", spy)
    prompt = np.random.default_rng(1).integers(
        1, CFG.vocab_size, size=(1, 128)).astype(np.int32)
    got, _ = tl.prefill(tq, TCFG, torch.from_numpy(prompt),
                        tl.KVCache.create(TCFG, 1, 256, device="cpu"))
    assert len(calls) == CFG.n_layers
    want, _ = jl.prefill(jq, CFG, jnp.asarray(prompt),
                         jl.KVCache.create(CFG, 1, 256))
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err
    calls.clear()
    tl.prefill(tq, TCFG, torch.from_numpy(prompt[:, :8]),
               tl.KVCache.create(TCFG, 1, 256, device="cpu"))
    assert not calls
    tl.prefill(tq, TCFG, torch.from_numpy(
        np.concatenate([prompt, prompt])),
        tl.KVCache.create(TCFG, 2, 256, device="cpu"))
    assert not calls                     # B = 2 stays unfused


def test_prefill_builds_the_rope_tables_once(monkeypatch):
    """A 128-token prefill of the debug model (head_dim 128, so that the
    gate opens; 3 layers) makes the RoPE tables once and hands them to each
    layer's rope_pack, one a layer; a decode step and an 8-token prompt
    make none."""
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=3, n_heads=2,
                              n_kv_heads=2, head_dim=128)
    params = tl.quantize_params(tl.init_weights(cfg, seed=0, device="cpu"),
                                "q4_k")
    calls = []

    def spy(*a, **kw):
        calls.append(kw.get("tables"))
        return tpf.rope_pack_prefill(*a, **kw)

    monkeypatch.setattr(tl, "rope_pack_prefill", spy)
    cache = tl.KVCache.create(cfg, 1, 256, device="cpu")
    before = tpf.BUILDS["rope_tables"]
    logits, cache = tl.prefill(params, cfg, torch.arange(1, 129)[None], cache)
    assert tpf.BUILDS["rope_tables"] == before + 1
    assert len(calls) == cfg.n_layers
    assert all(t is calls[0] and t is not None for t in calls)
    tl.decode_step(params, cfg, logits.argmax(-1).to(torch.int32), cache)
    tl.prefill(params, cfg, torch.arange(1, 9)[None],
               tl.KVCache.create(cfg, 1, 256, device="cpu"))
    assert tpf.BUILDS["rope_tables"] == before + 1
    assert len(calls) == cfg.n_layers
