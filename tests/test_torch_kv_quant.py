"""The port's int8 / fp8 contiguous KV cache against the JAX package's:
``KVCache.create(quantized=)``, the quantized cache writes (bit-equal),
``flash_decode`` with per-token scales against the JAX ``flash_decode``
(Pallas, interpret mode; MHA through ``_decode_kernel_ht``, GQA through
``_decode_kernel``), and ``generate`` on a quantized cache, token-exact.
The fused batch-1 gates that a quantized cache closes are held in
tests/test_torch_fused_gates.py.

Tolerances: flash_decode 2e-2 * max (tests/test_flash_decode.py's bound for
its int8 cache); model logits 2e-2 * max. A quantized cache turns a one-ulp
bf16 difference in K or V into a whole quantization step, so the seeds are
ones where no greedy step sits near a tie (JAX's top-2 logit gap >= 0.125,
asserted)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode as jfd
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as tfd

UNFUSED = dict(fuse_mlp=False, fuse_attn=False, fuse_layer=False)
DEBUG = dataclasses.replace(PRESETS["debug"], **UNFUSED)
QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _port(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _bytes(t):
    """A torch array as NumPy, fp8 as its bytes."""
    t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jbytes(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


@pytest.mark.parametrize("quantized", [True, "int8", "fp8"])
def test_create(quantized):
    cfg = _port(DEBUG)
    c = tl.KVCache.create(cfg, 2, 64, quantized=quantized, device="cpu")
    j = jl.KVCache.create(DEBUG, 2, 64, quantized=quantized)
    fmt = "fp8" if quantized == "fp8" else "int8"
    assert c.quantized and c.quant_fmt == j.quant_fmt == fmt
    assert c.k.dtype == c.v.dtype == QDT[fmt]
    assert tuple(c.k.shape) == j.k.shape == (2, 2, 2, 64, 64)
    assert c.k_scale.dtype == torch.float32
    assert tuple(c.k_scale.shape) == j.k_scale.shape == (2, 2, 2, 64)
    plain = tl.KVCache.create(cfg, 2, 64, device="cpu")
    assert not plain.quantized and plain.quant_fmt is None
    with pytest.raises(ValueError):
        tl.KVCache.create(cfg, 2, 64, quantized="int4", device="cpu")


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_writes_bit_equal(fmt):
    """One layer's fresh bf16 K / V [B, Hkv, T, D] at ragged positions,
    quantized per token and written in place, against the reference's
    _quantize_rowwise + _write_cache_layer."""
    rng = np.random.default_rng(0)
    kt = rng.normal(size=(2, 2, 5, 64)).astype(np.float32)
    vt = rng.normal(size=(2, 2, 5, 64)).astype(np.float32)
    kt[1, 0, 2] = 0.0                                # an all-zero token
    pos = np.array([3, 0], np.int32)
    c = tl.KVCache.create(_port(DEBUG), 2, 16, quantized=fmt, device="cpu")
    k_before = c.k
    tl._write_kv(c, 1, torch.from_numpy(kt).to(torch.bfloat16),
                 torch.from_numpy(vt).to(torch.bfloat16),
                 torch.from_numpy(pos))
    assert c.k is k_before                           # in place
    j = jl.KVCache.create(DEBUG, 2, 16, quantized=fmt)
    want = {}
    for name, x in (("k", kt), ("v", vt)):
        q, s = jl._quantize_rowwise(jnp.asarray(x, jnp.bfloat16), fmt)
        want[name] = jl._write_cache_layer(getattr(j, name), 1, q,
                                           jnp.asarray(pos))
        want[name + "_scale"] = jl._write_cache_layer(
            getattr(j, name + "_scale"), 1, s, jnp.asarray(pos))
    for name, arr in want.items():
        assert np.array_equal(_bytes(getattr(c, name)), _jbytes(arr)), name
    assert float(c.k_scale[1, 1, 0, 2]) == 0.0


L, B, S = 3, 2, 256


def _quant_inputs(seed, hq, hkv, d, fmt):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    k = rng.normal(size=(L, B, hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(L, B, hkv, S, d)).astype(np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    kq, ks = tl._quantize_rowwise(torch.from_numpy(k), fmt)
    vq, vs = tl._quantize_rowwise(torch.from_numpy(v), fmt)
    return qt, kq, vq, ks, vs, np.array([37, 200], np.int32)


def _to_jax(t):
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy()).view(
            jnp.float8_e4m3fn)
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (4, 2, 64)])
@pytest.mark.parametrize("splits", [1, 4])
def test_flash_decode_with_scales_matches_jax(fmt, hq, hkv, d, splits):
    q, kq, vq, ks, vs, lengths = _quant_inputs(hq + splits, hq, hkv, d, fmt)
    want = np.asarray(jfd(
        _to_jax(q), _to_jax(kq), _to_jax(vq), jnp.asarray(lengths),
        k_scale=_to_jax(ks), v_scale=_to_jax(vs), layer=1, kv_splits=splits,
        block_k=64).astype(jnp.float32))
    got = tfd.flash_decode(q, kq, vq, torch.from_numpy(lengths), layer=1,
                           kv_splits=splits, k_scale=ks, v_scale=vs)
    got = got.float().numpy()
    assert got.shape == (B, hq, d)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("hq,hkv", [(8, 8), (4, 2)])
def test_partials_and_merge_compose_with_scales(hq, hkv):
    """flash_decode_partials + lse_merge (the two kernels' plain versions)
    equal flash_decode_ref on a quantized cache; a GQA group rounds
    p * v_scale to bf16, MHA keeps it in f32."""
    q, kq, vq, ks, vs, lengths = _quant_inputs(1, hq, hkv, 64, "int8")
    lens = torch.from_numpy(lengths)
    before = dict(tfd.LAUNCHES)
    parts = tfd.flash_decode_partials(q, kq, vq, lens, scale=0.125,
                                      n_splits=3, layer=2, k_scale=ks,
                                      v_scale=vs)
    ref = tfd.flash_decode_ref(q, kq, vq, lens, scale=0.125, kv_splits=3,
                               layer=2, k_scale=ks, v_scale=vs)
    assert torch.equal(tfd.lse_merge(parts), ref)
    assert tfd.LAUNCHES == before                 # the CPU launches nothing
    with pytest.raises(ValueError):
        tfd.flash_decode(q, kq, vq, lens, layer=2, k_scale=ks)


# weight seeds by KV head count whose greedy steps keep JAX's top-2 logit
# gap >= 0.125 on both caches (a scan of seeds 1-31 found these)
GENERATE_SEEDS = {2: 4, 4: 25}


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("n_kv_heads", [2, 4], ids=["gqa", "mha"])
def test_generate_matches_jax(fmt, n_kv_heads):
    """The debug preset (GQA 4/2, and MHA 4/4) with q4_k layers on a
    quantized cache: prefill over the fresh bf16 K / V, then decode
    through the scale path of flash_decode."""
    cfg = dataclasses.replace(DEBUG, n_kv_heads=n_kv_heads)
    jp = jl.init_weights(cfg, seed=GENERATE_SEEDS[n_kv_heads])
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), _port(cfg), device="cpu")
    jq, tq = jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, 8)).astype(np.int32)
    steps = 5
    jc = jl.KVCache.create(cfg, 1, 256, quantized=fmt)
    tc = tl.KVCache.create(_port(cfg), 1, 256, quantized=fmt, device="cpu")
    jlog, jc = jl.prefill(jq, cfg, jnp.asarray(prompt), jc)
    tlog, tc = tl.prefill(tq, _port(cfg), torch.from_numpy(prompt), tc)
    jlogs, tlogs = [np.asarray(jlog)], [tlog.numpy()]
    for _ in range(steps):
        jtok = jnp.argmax(jlog, -1).astype(jnp.int32)
        ttok = torch.argmax(tlog, -1).to(torch.int32)
        assert int(jtok[0]) == int(ttok[0])
        jlog, jc = jl.decode_step(jq, cfg, jtok, jc)
        tlog, tc = tl.decode_step(tq, _port(cfg), ttok, tc)
        jlogs.append(np.asarray(jlog))
        tlogs.append(tlog.numpy())
    j, t = np.stack(jlogs), np.stack(tlogs)
    top2 = np.sort(j, -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() >= 0.125
    assert np.abs(t - j).max() <= 2e-2 * np.abs(j).max()
    assert tc.k.dtype == QDT[fmt] and tc.lengths.tolist() == [8 + steps]
    # the decode steps wrote quantized rows with their scales
    assert bool((tc.k_scale[:, 0, :, :8 + steps] > 0).all())
    toks = tl.generate(tq, _port(cfg), torch.from_numpy(prompt), steps,
                       cache=tl.KVCache.create(_port(cfg), 1, 256,
                                               quantized=fmt, device="cpu"))
    assert np.array_equal(toks[0], j[:steps].argmax(-1)[:, 0])


def test_quantized_cache_skips_rope_pack(monkeypatch):
    """The reference's fuse_rope gate: a 128-token prompt at head_dim 128
    takes the RoPE + repack kernel over a bf16 cache, not over an int8 one
    (the prefill attends over the fresh bf16 K / V either way)."""
    cfg = _port(dataclasses.replace(DEBUG, n_layers=1, n_heads=2,
                                    n_kv_heads=2, head_dim=128))
    params = tl.quantize_params(tl.init_weights(cfg, seed=0, device="cpu"),
                                "q4_k")
    calls = []
    rope_pack = tl.rope_pack_prefill
    monkeypatch.setattr(tl, "rope_pack_prefill",
                        lambda *a, **kw: calls.append(1) or rope_pack(*a,
                                                                      **kw))
    prompt = torch.arange(1, 129)[None]
    logits = []
    for quantized in (False, "int8"):
        cache = tl.KVCache.create(cfg, 1, 256, quantized=quantized,
                                  device="cpu")
        logits.append(tl.prefill(params, cfg, prompt, cache)[0])
    assert calls == [1]
    assert torch.allclose(logits[0], logits[1], rtol=0, atol=1e-2 * float(
        logits[0].abs().max()))
