"""Port's ``flash_attention`` plain version against the JAX
``flash_attention`` (Pallas ``_flash_kernel``, interpret mode on the CPU),
at D = 64 with GQA 4/2 and D = 128 MHA: causal for T = 8 and 128, and with
the engine's additive masks (a length mask with the causal cut, a chunk
mask without it). Tolerance 1e-2 * max: bf16 operands and output, f32
softmax on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops.flash_attention import flash_attention as jfa
from ggml_cuda_experiments_tpu_torch.ops import flash_attention as tfa


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (2, 2, 128)])
@pytest.mark.parametrize("t", [8, 128])
def test_causal_matches_jax(hq, hkv, d, t):
    rng = np.random.default_rng(hq * 1000 + t)
    q = rng.normal(size=(1, hq, t, d)).astype(np.float32)
    k = rng.normal(size=(1, hkv, t, d)).astype(np.float32)
    v = rng.normal(size=(1, hkv, t, d)).astype(np.float32)
    want = np.asarray(jfa(jnp.asarray(q, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16),
                          causal=True).astype(jnp.float32))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tfa.flash_attention(bf(q), bf(k), bf(v), causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, hq, t, d)
    got = got.float().numpy()
    assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()


def test_causal_offset_follows_decode_convention():
    """Sq < Sk: the queries are the last Sq positions, so the last query
    row sees every key and equals full attention for that row."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 2, 4, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 2, 16, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 2, 16, 64)).astype(np.float32))
    causal = tfa.flash_attention(q, k, v, causal=True)
    full = tfa.flash_attention(q, k, v, causal=False)
    assert torch.allclose(causal[:, :, -1], full[:, :, -1], atol=1e-6)
    assert not torch.allclose(causal[:, :, 0], full[:, :, 0], atol=1e-3)


def _bf(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (2, 2, 128)])
@pytest.mark.parametrize("length", [1, 37, 128])
def test_length_mask_with_causal_matches_jax(hq, hkv, d, length):
    """The engine's whole-prompt prefill: a padded prompt of T = 128 rows,
    keys past ``length`` masked by -inf on top of the causal cut; rows of
    the padded tail still see the valid keys."""
    t = 128
    rng = np.random.default_rng(length * 7 + d)
    q, k, v = (rng.normal(size=(1, h, t, d)).astype(np.float32)
               for h in (hq, hkv, hkv))
    mask = np.where(np.arange(t)[None, None, None, :] < length, 0.0,
                    -np.inf).astype(np.float32)
    want = np.asarray(jfa(jnp.asarray(q, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16), jnp.asarray(mask),
                          causal=True).astype(jnp.float32))
    got = tfa.flash_attention(_bf(q), _bf(k), _bf(v), torch.from_numpy(mask),
                              causal=True).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("pos0,length", [(0, 100), (128, 200), (128, 256)])
def test_chunk_mask_without_causal_matches_jax(pos0, length):
    """The engine's chunked prefill: C = 128 query rows at positions
    pos0 + i against S = 256 gathered keys, key j visible iff j <= pos0 + i
    and j < length; no causal flag."""
    c, s, hq, hkv, d = 128, 256, 4, 2, 64
    rng = np.random.default_rng(pos0 + length)
    q = rng.normal(size=(1, hq, c, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, hkv, s, d)).astype(np.float32)
            for _ in range(2))
    kv_pos = np.arange(s)[None, :]
    q_pos = (pos0 + np.arange(c))[:, None]
    mask = np.where((kv_pos <= q_pos) & (kv_pos < length), 0.0,
                    -np.inf).astype(np.float32)[None, None]
    want = np.asarray(jfa(jnp.asarray(q, jnp.bfloat16),
                          jnp.asarray(k, jnp.bfloat16),
                          jnp.asarray(v, jnp.bfloat16),
                          jnp.asarray(mask)).astype(jnp.float32))
    got = tfa.flash_attention(_bf(q), _bf(k), _bf(v),
                              torch.from_numpy(mask)).float().numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()


def test_fully_masked_row_gives_zero():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 64)).astype(
        np.float32)) for _ in range(3))
    mask = torch.zeros((1, 1, 8, 8))
    mask[..., 3, :] = -torch.inf
    got = tfa.flash_attention(q, k, v, mask)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :, 3], torch.zeros_like(got[:, :, 3]))
    assert got[:, :, 2].abs().max() > 0


# --- the lse residual (return_residuals=True) ------------------------------

def _residual_case(kind):
    """(q, k, v, mask, causal) in f32 for the JAX residual comparison:
    causal MHA, GQA 4/2 causal, an additive mask with a whole 128-block
    and scattered keys masked, and that mask with the second 128-row block
    of queries masked whole (the ring's block in the future: every tile
    of those rows is skipped by the JAX kernel, so l = 0 there)."""
    rng = np.random.default_rng({"causal": 1, "gqa": 2, "masked": 3,
                                 "dead_rows": 4}[kind])
    hq, hkv = (4, 2) if kind == "gqa" else (2, 2)
    sq, sk, d = 256, 256, 64
    q = rng.normal(size=(1, hq, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, hkv, sk, d)).astype(np.float32)
            for _ in range(2))
    mask = None
    if kind in ("masked", "dead_rows"):
        mask = np.zeros((1, 1, sq, sk), np.float32)
        mask[..., 128:256] = -np.inf
        mask[..., ::7] = -np.inf
        if kind == "dead_rows":
            mask[..., 128:, :] = -np.inf
    return q, k, v, mask, kind in ("causal", "gqa")


@pytest.mark.parametrize("kind", ["causal", "gqa", "masked", "dead_rows"])
def test_lse_residual_matches_jax(kind):
    """o and lse of the plain version against JAX return_residuals=True
    (f32, Pallas interpreted): o 2e-3, lse 2e-3 relative; a fully masked
    row is o = 0, lse = -inf on both sides."""
    q, k, v, mask, causal = _residual_case(kind)
    jo, jlse = jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   None if mask is None else jnp.asarray(mask),
                   causal=causal, return_residuals=True)
    jo, jlse = np.asarray(jo), np.asarray(jlse)
    t = torch.from_numpy
    o, lse = tfa.flash_attention(t(q), t(k), t(v),
                                 None if mask is None else t(mask),
                                 causal=causal, return_residuals=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    o, lse = o.numpy(), lse.numpy()
    dead = np.isneginf(jlse)
    assert np.array_equal(np.isneginf(lse), dead)
    assert dead.any() == (kind == "dead_rows")
    assert np.isfinite(o).all() and (o[dead] == 0).all()
    assert np.abs(o - jo).max() <= 2e-3 * np.abs(jo).max()
    live = ~dead
    assert np.abs(lse[live] - jlse[live]).max() <= 2e-3 * np.abs(
        jlse[live]).max()


def test_residuals_enable_cross_shard_merge():
    """KV split over two calls, merged with the lse ops from the residuals,
    equals one whole-KV call (the JAX test's contract, 2e-3), for the port
    and against JAX's own one-call output."""
    from ggml_cuda_experiments_tpu_torch.ops.lse import (
        AttnPartial, lse_combine, lse_finalize)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 2, 128, 64)).astype(np.float32)
    k, v = (rng.normal(size=(1, 2, 512, 64)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(jfa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    t = torch.from_numpy
    parts = []
    for sl in (slice(0, 256), slice(256, 512)):
        o, lse = tfa.flash_attention(t(q), t(k[:, :, sl]), t(v[:, :, sl]),
                                     return_residuals=True)
        parts.append(AttnPartial(o.float(), lse[..., None],
                                 torch.ones_like(lse[..., None])))
    merged = lse_finalize(lse_combine(*parts)).numpy()
    assert np.abs(merged - want).max() <= 2e-3 * np.abs(want).max()
    whole = tfa.flash_attention(t(q), t(k), t(v)).numpy()
    assert np.abs(merged - whole).max() <= 2e-3 * np.abs(whole).max()


def test_residuals_counted_apart():
    """On the CPU the plain version runs and nothing is counted; the
    residual's launches have their own key beside flash_attention's."""
    assert set(tfa.LAUNCHES) == {"flash_attention", "flash_attention_lse"}
    before = dict(tfa.LAUNCHES)
    x = torch.zeros((1, 1, 4, 64))
    o, lse = tfa.flash_attention(x, x, x, return_residuals=True)
    assert tfa.LAUNCHES == before
    assert torch.allclose(lse, torch.full_like(lse, float(np.log(4))))


def test_lse_of_a_dead_row_in_a_live_tile():
    """A row with no visible key beside live rows: o = 0, lse = -inf (the
    JAX kernel computes such a tile and gives NaN there; its -inf comes
    only from skipped tiles)."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 8, 64)).astype(
        np.float32)) for _ in range(3))
    mask = torch.zeros((1, 1, 8, 8))
    mask[..., 3, :] = -torch.inf
    o, lse = tfa.flash_attention(q, k, v, mask, return_residuals=True)
    assert torch.equal(o[:, :, 3], torch.zeros_like(o[:, :, 3]))
    assert torch.isneginf(lse[:, :, 3]).all()
    assert torch.isfinite(lse[:, :, [0, 1, 2, 4, 5, 6, 7]]).all()
