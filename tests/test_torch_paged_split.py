"""``paged_decode``'s split of each sequence's keys, on the CPU.

The kernel (``csrc/paged_attention.cu``) cuts a sequence's valid keys into
64-key tiles and gives each of ``kv_splits`` CTAs ceil(tiles / n) of them
(``flash_decode.split_tiles``' rule), and its last CTA merges the splits in
split order. The plain version takes the same partition
(``paged_decode_ref(kv_splits=n)``: the pages gathered, then
``flash_decode._partials_ref`` + ``_merge_ref``, p * v_scale kept in f32).
Held here: kv_splits = 1 equals the single-softmax formula the plain
version computed before it had splits (bf16 output, bit for bit), and
splits {1, 3, 16} against the JAX ``paged_decode`` (Pallas, interpret mode)
at tests/test_torch_paged_attention.py's bounds (|got - want| <= tol + tol
* |want|, tol 2e-3 on bf16 pages and 2e-2 on int8 / fp8), with ragged
lengths including 1 and pages_per_seq * page_size, GQA and MHA, pages of 16
and 64 keys; and the split count ``paged_decode`` picks on the card."""

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
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(a))


def _inputs(seed, *, B, hq, hkv, d, ps, pps, fmt, lengths, L=2):
    rng = np.random.default_rng(seed)
    n_pages = B * pps + 2
    kf, vf = (rng.normal(size=(L, n_pages, hkv, ps, d)).astype(np.float32)
              for _ in range(2))
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    pidx = rng.permutation(n_pages)[:B * pps].reshape(B, pps).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    if fmt == "bf16":
        j = (jnp.asarray(kf, jnp.bfloat16), jnp.asarray(vf, jnp.bfloat16), {})
        t = (_torch(kf).to(torch.bfloat16), _torch(vf).to(torch.bfloat16), {})
    else:
        quant = quantize_int8_rowwise if fmt == "int8" else \
            quantize_fp8_rowwise
        (kq, ks), (vq, vs) = quant(kf), quant(vf)
        ks, vs = ks[..., 0], vs[..., 0]
        j = (jnp.asarray(kq), jnp.asarray(vq),
             dict(k_scale_pages=jnp.asarray(ks),
                  v_scale_pages=jnp.asarray(vs)))
        t = (_torch(kq), _torch(vq),
             dict(k_scale_pages=_torch(ks), v_scale_pages=_torch(vs)))
    return q, pidx, lens, j, t


def _single_softmax(q, k_pages, v_pages, lengths, page_indices, ks, vs,
                    layer):
    """The plain version's formula before it took kv_splits: one f32
    softmax over each sequence's first lengths[b] gathered keys."""
    k_pages, v_pages = k_pages[layer], v_pages[layer]
    B, Hq, D = q.shape
    n_pages, Hkv, ps, _ = k_pages.shape
    pages = page_indices.long().clamp(max=n_pages - 1)
    P = pages.shape[1]

    def seq(pool):
        g = pool[pages].float()
        return g.transpose(1, 2).reshape(B, Hkv, P * ps, *pool.shape[3:])

    s = torch.einsum("bhgd,bhsd->bhgs",
                     q.float().reshape(B, Hkv, Hq // Hkv, D), seq(k_pages))
    scale = float(1.0 / D ** 0.5)
    s = s * (seq(ks[layer]) * scale)[:, :, None, :] if ks is not None \
        else s * scale
    valid = torch.arange(P * ps)[None] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m == -torch.inf, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    if vs is not None:
        p = p * seq(vs[layer])[:, :, None, :]
    o = torch.einsum("bhgs,bhsd->bhgd", p, seq(v_pages)) / torch.where(
        l == 0, 1.0, l)
    return o.reshape(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
def test_one_split_is_the_single_softmax(fmt):
    q, pidx, lens, _, (tk, tv, tkw) = _inputs(
        3, B=3, hq=8, hkv=2, d=64, ps=16, pps=8, fmt=fmt,
        lengths=[1, 77, 128])
    qt = _torch(q).to(torch.bfloat16)
    got = tpa.paged_decode_ref(qt, tk, tv, _torch(lens), _torch(pidx),
                               layer=1, kv_splits=1, **tkw)
    want = _single_softmax(qt, tk, tv, _torch(lens), _torch(pidx),
                           tkw.get("k_scale_pages"),
                           tkw.get("v_scale_pages"), 1)
    assert torch.equal(got, want)


CASES = [  # fmt, hq, hkv, d, ps, pps, lengths
    ("bf16", 8, 2, 64, 16, 16, [1, 256, 100, 17]),
    ("bf16", 4, 4, 128, 64, 4, [256, 1, 65, 200]),
    ("int8", 8, 2, 64, 64, 4, [1, 63, 64, 256]),
    ("int8", 4, 4, 64, 16, 16, [129, 1, 256, 31]),
    ("fp8", 16, 1, 64, 16, 8, [128, 1, 70, 5]),
    ("fp8", 4, 4, 128, 64, 2, [1, 128, 64, 100]),
]


_JAX: dict = {}


@pytest.mark.parametrize("fmt,hq,hkv,d,ps,pps,lengths", CASES)
@pytest.mark.parametrize("n", [1, 3, 16])
def test_splits_match_jax(n, fmt, hq, hkv, d, ps, pps, lengths):
    q, pidx, lens, (jk, jv, jkw), (tk, tv, tkw) = _inputs(
        hq + ps + len(fmt), B=len(lengths), hq=hq, hkv=hkv, d=d, ps=ps,
        pps=pps, fmt=fmt, lengths=lengths)
    key = (fmt, hq, hkv, d, ps, pps, tuple(lengths))
    if key not in _JAX:                 # one JAX run a case, for every n
        _JAX[key] = np.asarray(jpd(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                   jnp.asarray(lens), jnp.asarray(pidx),
                                   layer=1, **jkw), np.float32)
    want = _JAX[key]
    got = tpa.paged_decode_ref(_torch(q).to(torch.bfloat16), tk, tv,
                               _torch(lens), _torch(pidx), layer=1,
                               kv_splits=n, **tkw).float().numpy()
    tol = 2e-3 if fmt == "bf16" else 2e-2
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.all(np.abs(got - want) <= tol + tol * np.abs(want)), \
        np.abs(got - want).max()


def test_splits_past_a_length_weigh_nothing():
    """With more splits than a short sequence has tiles, the empty splits
    are the LSE identity and the merged result is the one-split result."""
    q, pidx, lens, _, (tk, tv, tkw) = _inputs(
        9, B=2, hq=4, hkv=4, d=64, ps=16, pps=16, fmt="bf16",
        lengths=[1, 70])
    args = (_torch(q).to(torch.bfloat16), tk, tv, _torch(lens),
            _torch(pidx))
    one = tpa.paged_decode_ref(*args, layer=0, kv_splits=1)
    many = tpa.paged_decode_ref(*args, layer=0, kv_splits=16)
    assert torch.equal(one[0], many[0])        # one tile: one live split
    assert torch.allclose(one.float(), many.float(), atol=2e-3, rtol=2e-3)


def test_the_card_picks_flash_decodes_split_count():
    """The kernel's n_splits is ``pick_splits`` over the padded span
    pages_per_seq * page_size: one split where B x Hkv fills the card, more
    for few sequences or KV heads."""
    assert tfd.pick_splits(8, 32, 16 * 64, 132) == 1
    assert tfd.pick_splits(8, 8, 16 * 64, 132) == 2
    assert tfd.pick_splits(1, 32, 16 * 64, 132) == 4
