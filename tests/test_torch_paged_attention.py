"""Port's ``paged_decode`` plain version against the JAX ``paged_decode``
(Pallas ``_paged_kernel``, interpret mode on the CPU), on the same pools
and page tables: bf16, int8 and fp8 pages; a 4-D pool and a layered 5-D
pool; GQA 8/2 and MHA; pages_per_compute_block 1/2/4; lengths of 1 and of
the whole span; and one case at the 7B engine's heads. Bounds as
tests/test_paged_attention.py: |got - want| <= tol + tol * |want| with tol
2e-3 for bf16 pages and 2e-2 for quantized ones. The quantized pools come
from the oracle's rowwise quantizers, so both sides read identical bytes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.oracle.quant import (
    quantize_fp8_rowwise, quantize_int8_rowwise)
from ggml_cuda_experiments_tpu.ops.paged_attention import (
    paged_decode as jpd)
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as tfd
from ggml_cuda_experiments_tpu_torch.ops import paged_attention as tpa


def _torch(a):
    """NumPy (ml_dtypes fp8 included) -> torch, same bytes."""
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a))


def _pools(rng, L, n_pages, hkv, ps, d, fmt):
    """(jax kwargs, torch kwargs) for k/v pools [L, n_pages, Hkv, ps, D]."""
    kp, vp = (rng.normal(size=(L, n_pages, hkv, ps, d)).astype(np.float32)
              for _ in range(2))
    if fmt == "bf16":
        k = jnp.asarray(kp, jnp.bfloat16)
        v = jnp.asarray(vp, jnp.bfloat16)
        return ((k, v, {}), (_torch(kp).to(torch.bfloat16),
                             _torch(vp).to(torch.bfloat16), {}))
    quant = quantize_int8_rowwise if fmt == "int8" else quantize_fp8_rowwise
    (kq, ks), (vq, vs) = quant(kp), quant(vp)
    ks, vs = ks[..., 0], vs[..., 0]
    jx = (jnp.asarray(kq), jnp.asarray(vq),
          dict(k_scale_pages=jnp.asarray(ks), v_scale_pages=jnp.asarray(vs)))
    tx = (_torch(kq), _torch(vq),
          dict(k_scale_pages=_torch(ks), v_scale_pages=_torch(vs)))
    return jx, tx


def _case(seed, *, B, hq, hkv, d, ps, pps, fmt, layered, ppcb, lengths):
    rng = np.random.default_rng(seed)
    L = 3 if layered else 1
    n_pages = B * pps + 3
    (jk, jv, jkw), (tk, tv, tkw) = _pools(rng, L, n_pages, hkv, ps, d, fmt)
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    pidx = rng.permutation(n_pages)[:B * pps].reshape(B, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    layer = 2 if layered else None
    if not layered:
        jk, jv = jk[0], jv[0]
        tk, tv = tk[0], tv[0]
        jkw = {n: a[0] for n, a in jkw.items()}
        tkw = {n: a[0] for n, a in tkw.items()}
    want = jpd(jnp.asarray(q), jk, jv, jnp.asarray(lens), jnp.asarray(pidx),
               pages_per_compute_block=ppcb, layer=layer, **jkw)
    got = tpa.paged_decode(_torch(q), tk, tv, _torch(lens), _torch(pidx),
                           pages_per_compute_block=ppcb, layer=layer, **tkw)
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    tol = 2e-3 if fmt == "bf16" else 2e-2
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= tol + tol * np.abs(want)), \
        np.abs(got - want).max()


@pytest.mark.parametrize("fmt,layered,hq,hkv", [
    ("bf16", False, 8, 2), ("bf16", True, 4, 4), ("int8", True, 8, 2),
    ("int8", False, 4, 4), ("fp8", True, 8, 2), ("fp8", False, 4, 4)])
def test_paged_matches_jax(fmt, layered, hq, hkv):
    _case(len(fmt) + 10 * hq + layered, B=3, hq=hq, hkv=hkv, d=64, ps=32,
          pps=4, fmt=fmt, layered=layered, ppcb=2, lengths=[1, 77, 128])


@pytest.mark.parametrize("ppcb", [1, 2, 4])
def test_paged_pages_per_compute_block(ppcb):
    _case(ppcb, B=2, hq=8, hkv=2, d=128, ps=16, pps=8, fmt="bf16",
          layered=True, ppcb=ppcb, lengths=[128, 50])


def test_paged_7b_engine_heads():
    """Hq = Hkv = 32, D = 128, page 64, B = 8, ragged lengths, int8 pages."""
    _case(7, B=8, hq=32, hkv=32, d=128, ps=64, pps=4, fmt="int8",
          layered=True, ppcb=4, lengths=[1, 63, 64, 65, 100, 200, 255, 256])


def test_paged_equals_contiguous_flash_decode():
    """A bf16 pool filled from a contiguous cache gives flash_decode's
    result on that cache (port against port, plain versions)."""
    rng = np.random.default_rng(4)
    B, hq, hkv, S, d, ps = 2, 8, 2, 128, 64, 32
    k, v = (torch.from_numpy(rng.normal(size=(B, hkv, S, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.normal(size=(B, hq, d)).astype(np.float32))
    pps = S // ps
    pidx = torch.from_numpy(rng.permutation(B * pps + 1)[:B * pps].reshape(
        B, pps).astype(np.int32))
    kp = torch.zeros((B * pps + 1, hkv, ps, d), dtype=torch.bfloat16)
    vp = torch.zeros_like(kp)
    for b in range(B):
        for p in range(pps):
            kp[pidx[b, p]] = k[b, :, p * ps:(p + 1) * ps]
            vp[pidx[b, p]] = v[b, :, p * ps:(p + 1) * ps]
    lens = torch.tensor([90, 128], dtype=torch.int32)
    got = tpa.paged_decode(q, kp, vp, lens, pidx)
    want = tfd.flash_decode(q, k, v, lens)
    assert torch.allclose(got, want, atol=2e-3, rtol=2e-3)


def test_paged_clamps_page_indices_and_checks_its_arguments():
    rng = np.random.default_rng(5)
    kp = torch.from_numpy(rng.normal(size=(6, 2, 16, 64)).astype(np.float32))
    q = torch.from_numpy(rng.normal(size=(1, 4, 64)).astype(np.float32))
    lens = torch.tensor([40], dtype=torch.int32)
    over = torch.tensor([[0, 1, 99, 99]], dtype=torch.int32)   # -> page 5
    clamped = torch.tensor([[0, 1, 5, 5]], dtype=torch.int32)
    assert torch.equal(tpa.paged_decode(q, kp, kp, lens, over),
                       tpa.paged_decode(q, kp, kp, lens, clamped))
    with pytest.raises(ValueError):                 # 4-D pool with layer
        tpa.paged_decode(q, kp, kp, lens, clamped, layer=0)
    with pytest.raises(ValueError):                 # 5-D pool without one
        tpa.paged_decode(q, kp[None], kp[None], lens, clamped)
    with pytest.raises(ValueError):                 # 4 pages, 3 per block
        tpa.paged_decode(q, kp, kp, lens, clamped,
                         pages_per_compute_block=3)
