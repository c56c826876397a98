"""The split-KV decode's partition of the valid keys, and the dense GEMM's
routes, on the CPU.

``flash_decode_partials`` cuts each sequence's valid keys [0, len) into
whole 64-key tiles, ceil(tiles / n) to a split (``split_tiles``), and its
plain version ``_partials_ref`` takes the same partition: every key below
the length lies in exactly one split, each split is whole tiles but the
last valid one, and a split with no key is the LSE identity (m = -inf,
s = 0, o = 0). Merged (``_merge_ref``), the partials are held against the
JAX ``flash_decode`` (Pallas, interpret mode, one split) on a bf16 cache
at 1e-2 * max and on an int8 cache with per-token scales at 2e-2 * max
(tests/test_torch_kv_quant.py's bound): bf16 inputs and output, f32 sums
in another order. ``ops.matmul.route`` is held to its rule: bf16 / f16
with strides TMA can describe take "wgmma" in every transpose combination,
int8 only when both operands are K-major, f32 "ffma", the rest "mma"."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode as jfd
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as tfd
from ggml_cuda_experiments_tpu_torch.ops import matmul as mm

TILE = tfd.TILE_KEYS


def _bounds(length: int, n: int):
    """[lo, hi) of each split of one sequence, as the kernel cuts it."""
    span = int(tfd.split_tiles(torch.tensor([length]), n)[0]) * TILE
    return [(min(i * span, length), min((i + 1) * span, length))
            for i in range(n)]


@pytest.mark.parametrize("n", [1, 3, 9, 16])
def test_every_valid_key_in_exactly_one_split(n):
    S = 1024
    lengths = [0, 1, 63, 64, 65, 300, 1024]
    for length in lengths:
        bounds = _bounds(length, n)
        owner = np.zeros(S, np.int64)
        for lo, hi in bounds:
            owner[lo:hi] += 1
        assert (owner[:length] == 1).all() and (owner[length:] == 0).all()
        valid = [(lo, hi) for lo, hi in bounds if hi > lo]
        for j, (lo, hi) in enumerate(valid):
            assert lo % TILE == 0
            assert (hi - lo) % TILE == 0 or (j == len(valid) - 1
                                             and hi == length)
    # the plain partials take that partition: with q = 0 every valid key
    # weighs 1, so s counts a split's keys and o sums their indices
    B, D = len(lengths), 8
    q = torch.zeros((B, 1, D), dtype=torch.bfloat16)
    k = torch.zeros((B, 1, S, D), dtype=torch.bfloat16)
    v = torch.zeros((B, 1, S, D), dtype=torch.bfloat16)
    v[..., 0] = (torch.arange(S) % 64).to(torch.bfloat16)    # exact in bf16
    v[..., 1] = (torch.arange(S) // 64).to(torch.bfloat16)
    p = tfd._partials_ref(q, k, v, torch.tensor(lengths, dtype=torch.int32),
                          1.0, n)
    assert p.o.shape == (B, 1, n, 1, D) and p.m.shape == (B, 1, n, 1, 1)
    for b, length in enumerate(lengths):
        for i, (lo, hi) in enumerate(_bounds(length, n)):
            keys = torch.arange(lo, hi)
            o, m, s = p.o[b, 0, i, 0], p.m[b, 0, i, 0, 0], p.s[b, 0, i, 0, 0]
            if hi == lo:                               # the LSE identity
                assert m == -torch.inf and s == 0 and not o.any()
                continue
            assert m == 0 and s == hi - lo
            assert o[0] == float((keys % 64).sum())
            assert o[1] == float((keys // 64).sum())


def test_length_zero_is_the_identity():
    rng = np.random.default_rng(5)
    bf = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = bf(2, 4, 64), bf(2, 1, 256, 64), bf(2, 1, 256, 64)
    lengths = torch.tensor([0, 0], dtype=torch.int32)
    for n in (1, 3, 9):
        p = tfd._partials_ref(q, k, v, lengths, 0.125, n)
        assert (p.m == -torch.inf).all() and not p.s.any() and not p.o.any()
        assert not tfd._merge_ref(p, torch.bfloat16).float().any()



@pytest.mark.parametrize("n", [3, 4, 16])
def test_a_length_past_the_cache_splits_as_the_cache(n):
    """The kernel splits min(len, S) keys; so does the plain version, split
    for split (unclamped, 1100 or 2000 keys would cut other tiles than
    1024)."""
    rng = np.random.default_rng(7)
    S_ = 1024
    bf = lambda *s: torch.from_numpy(rng.normal(size=s).astype(
        np.float32)).to(torch.bfloat16)
    q, k, v = bf(1, 2, 64), bf(1, 1, S_, 64), bf(1, 1, S_, 64)
    full = tfd._partials_ref(q, k, v, torch.tensor([S_], dtype=torch.int32),
                             0.125, n)
    for length in (1100, 2000):
        p = tfd._partials_ref(q, k, v, torch.tensor([length],
                                                    dtype=torch.int32),
                              0.125, n)
        for a, b in zip(p, full):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype,scaled", [(torch.bfloat16, False),
                                          (torch.int8, True)])
def test_partials_refuse_a_kv_base_off_16_bytes(dtype, scaled):
    """The kernel copies K / V rows 16 bytes at a time: a contiguous view
    whose base is not 16-byte aligned is refused before the launch."""
    b, hkv, s_, d = 1, 2, 64, 64
    q = torch.zeros((b, 4, d), dtype=torch.bfloat16)
    n = b * hkv * s_ * d
    scales = [torch.ones((b, hkv, s_)) for _ in range(2)] if scaled \
        else [None, None]
    lengths = torch.tensor([s_], dtype=torch.int32)
    good = torch.zeros(n, dtype=dtype).view(b, hkv, s_, d)
    assert tfd._check_partials_args(q, good, good, good, lengths, 3,
                                    *scales) == dtype
    bad = torch.zeros(n + 1, dtype=dtype)[1:].view(b, hkv, s_, d)
    assert bad.is_contiguous() and bad.data_ptr() % 16
    for k, v in ((bad, good), (good, bad)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tfd._check_partials_args(q, k, v, k, lengths, 3, *scales)

L, B, S = 2, 3, 256
LENGTHS = np.array([1, 65, 200], np.int32)


@functools.cache
def _case(g: int, fmt: str):
    """(q, k, v, scales, JAX's attention) for G = g (Hkv = 2, D = 64) on a
    bf16 cache, or an int8 cache with per-token scales."""
    rng = np.random.default_rng(10 * g + (fmt == "int8"))
    hkv, d = 2, 64
    q = torch.from_numpy(rng.normal(size=(B, g * hkv, d)).astype(
        np.float32)).to(torch.bfloat16)
    kf, vf = (torch.from_numpy(rng.normal(size=(L, B, hkv, S, d)).astype(
        np.float32)) for _ in range(2))
    jq = jnp.asarray(q.float().numpy(), jnp.bfloat16)
    if fmt == "bf16":
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
        ks = vs = None
        want = jfd(jq, jnp.asarray(k.float().numpy(), jnp.bfloat16),
                   jnp.asarray(v.float().numpy(), jnp.bfloat16),
                   jnp.asarray(LENGTHS), layer=1, block_k=64)
    else:
        (k, ks), (v, vs) = (tl._quantize_rowwise(t, "int8") for t in (kf, vf))
        want = jfd(jq, jnp.asarray(k.numpy()), jnp.asarray(v.numpy()),
                   jnp.asarray(LENGTHS), k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()), layer=1, block_k=64)
    return q, k, v, ks, vs, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("fmt,tol", [("bf16", 1e-2), ("int8", 2e-2)])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("n", [3, 9])
def test_split_partials_merged_match_jax(fmt, tol, g, n):
    q, k, v, ks, vs, want = _case(g, fmt)
    lay = lambda t: None if t is None else t[1]
    parts = tfd._partials_ref(q, k[1], v[1], torch.from_numpy(LENGTHS),
                              64 ** -0.5, n, lay(ks), lay(vs))
    assert parts.o.shape == (B, 2, n, g, 64)
    got = tfd._merge_ref(parts, torch.bfloat16).float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# ---- ops.matmul.route

def _mat(shape, dtype):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_route_16_bit_takes_wgmma_in_every_layout(dtype, ta, tb):
    m, k, n = 64, 128, 96
    x = _mat((k, m) if ta else (m, k), dtype)
    w = _mat((n, k) if tb else (k, n), dtype)
    assert mm.route(x, w, transpose_a=ta, transpose_b=tb) == "wgmma"


@pytest.mark.parametrize("ta,tb,want", [(False, True, "wgmma"),
                                        (False, False, "mma"),
                                        (True, True, "mma"),
                                        (True, False, "mma")])
def test_route_int8_takes_wgmma_only_k_major(ta, tb, want):
    m, k, n = 64, 128, 96
    x = _mat((k, m) if ta else (m, k), torch.int8)
    w = _mat((n, k) if tb else (k, n), torch.int8)
    assert mm.route(x, w, transpose_a=ta, transpose_b=tb) == want


def test_route_f32_and_unaligned_strides_take_the_old_kernels():
    x, w = _mat((64, 128), torch.float32), _mat((128, 96), torch.float32)
    assert mm.route(x, w) == "ffma"
    x, w = _mat((257, 383), torch.bfloat16), _mat((383, 129), torch.bfloat16)
    assert mm.route(x, w) == "mma"
    # a column slice: a leading stride of 520 elements (1040 bytes) and an
    # offset of 16 bytes take TMA; 521 elements do not
    wide = _mat((64, 520), torch.bfloat16)
    assert mm.route(wide[:, 8:264], _mat((256, 96), torch.bfloat16)) \
        == "wgmma"
    odd = _mat((64, 521), torch.bfloat16)
    assert mm.route(odd[:, :256], _mat((256, 96), torch.bfloat16)) == "mma"
    # one stored row needs no stride; a base off 16 bytes is refused
    assert mm.route(_mat((1, 4096), torch.bfloat16),
                    _mat((4096, 4096), torch.bfloat16)) == "wgmma"
    assert mm.route(wide[:, 1:257], _mat((256, 96), torch.bfloat16)) == "mma"


def test_route_does_not_depend_on_block_sizes():
    assert set(inspect.signature(mm.route).parameters) == {
        "x", "w", "transpose_a", "transpose_b"}
    # matmul's CPU path ignores the block sizes as its kernels do
    x, w = torch.ones((3, 5)), torch.ones((5, 2))
    ref = mm.matmul(x, w)
    for bm, bn, bk in ((8, 8, 8), (256, 128, 512), (1, 1, 1)):
        assert torch.equal(mm.matmul(x, w, block_m=bm, block_n=bn,
                                     block_k=bk), ref)
