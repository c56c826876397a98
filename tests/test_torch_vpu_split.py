"""The split of the port's ``vpu_attention`` over the keys: ``pick_splits``
(whole 64-key tiles covering [0, S), about two waves of the card), and the
plain versions of its two kernels, ``_vpu_merge_ref(_vpu_partials_ref(...))``,
against the JAX ``vpu_attention`` (Pallas ``_vpu_attn_kernel``, interpret
mode on the CPU, as tests/test_vpu_attention.py runs it) on the same numpy
inputs: o within 2e-5 absolute (the JAX test's bound, f32 unit-normal
inputs), lse within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops import vpu_attention as jva
from ggml_cuda_experiments_tpu_torch.ops import vpu_attention as tva


def _inputs(seed, B, H, T, S, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((B, H, T, D), (B, H, S, D), (B, H, S, D))]


@pytest.mark.parametrize("B,H,T,S,sms", [
    (1, 32, 5, 1024, 132), (1, 32, 5, 64, 132), (2, 3, 11, 65, 132),
    (2, 32, 16, 4096, 132), (1, 1, 1, 100000, 132), (8, 64, 40, 300, 132),
    (1, 2, 3, 5000, 16)])
def test_pick_splits_covers_s_in_whole_tiles(B, H, T, S, sms):
    n, span = tva.pick_splits(B, H, T, S, sms)
    assert span % 64 == 0 and span >= 64
    assert (n - 1) * span < S <= n * span             # [0, S), none empty
    if S <= 64:
        assert (n, span) == (1, 64)
    ctas = B * H * -(-T // 8)
    # no whole-tile split gives more CTAs without passing two waves: one
    # tile less per split would overshoot them
    if span > 64 and ctas * n < 2 * sms:
        assert ctas * -(-S // (span - 64)) >= 2 * sms


def test_pick_splits_at_the_verify_window():
    """B 1, H 32, T 5, S 1024 on 132 SMs: 8 splits of 128 keys, 256 CTAs,
    1.94 waves (9 splits would need spans of 114 keys, not whole tiles)."""
    assert tva.pick_splits(1, 32, 5, 1024, 132) == (8, 128)


def _jax(q, k, v, lengths, causal, q0_pos, block_k):
    o, lse = jva._vpu_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), causal=causal,
        scale=float(1.0 / np.sqrt(q.shape[-1])), block_k=block_k,
        q0_pos=q0_pos, interpret=None)
    return np.asarray(o), np.asarray(lse)


# (B, H, T, S, D, lengths, causal, q0_pos, span): 1, 2 and many splits;
# S = 65 (a second split of one key); lengths 0 (the mean of v) and 1; a
# causal frontier inside the first split (every later split the identity)
CASES = [
    (2, 2, 5, 128, 64, (128, 90), True, 123, 128),
    (2, 2, 5, 128, 64, (128, 90), True, 123, 64),
    (2, 2, 16, 256, 40, (256, 200), False, 0, 64),
    (2, 2, 3, 65, 64, (65, 0), True, 62, 64),
    (2, 2, 3, 192, 80, (0, 1), True, 189, 64),
    (1, 2, 9, 256, 128, (256,), True, 10, 64),
]


@pytest.mark.parametrize("B,H,T,S,D,lens,causal,q0_pos,span", CASES)
def test_merged_partials_match_jax(B, H, T, S, D, lens, causal, q0_pos,
                                   span):
    q, k, v = _inputs(S + D, B, H, T, S, D)
    lengths = np.array(lens, np.int32)
    jo, jlse = _jax(q, k, v, lengths, causal, q0_pos, S)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    scale = float(1.0 / np.sqrt(D))
    po, pm, pl = tva._vpu_partials_ref(tq, tk, tv, torch.from_numpy(lengths),
                                       causal, scale, q0_pos, span)
    n = -(-S // span)
    assert po.shape == (B, H, T, n, D) and pm.shape == pl.shape == (
        B, H, T, n)
    ident = torch.isneginf(pm)
    assert not ident[..., 0].any()            # the first split never is
    assert not pl[ident].any() and not po[ident].any()
    o, lse = tva._vpu_merge_ref(po, pm, pl, torch.float32)
    np.testing.assert_allclose(o.numpy(), jo, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), jlse, rtol=1e-5, atol=0)
    # the merge of the split and the unsplit plain version agree as well
    ro, rlse = tva.vpu_attention_ref(tq, tk, tv, torch.from_numpy(lengths),
                                     causal, scale, q0_pos)
    np.testing.assert_allclose(o.numpy(), ro.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), rlse.numpy(), rtol=1e-5, atol=0)


def test_identity_splits_past_the_frontier():
    """A causal frontier inside the first split: every later split of every
    row with a visible key is the identity; a row with none (lengths 0)
    computes every split, m = MASK and l = its keys below S."""
    B, H, T, S, D = 2, 1, 4, 200, 16
    q, k, v = (torch.from_numpy(a) for a in _inputs(5, B, H, T, S, D))
    lengths = torch.tensor([200, 0], dtype=torch.int32)
    o, m, l = tva._vpu_partials_ref(q, k, v, lengths, True, 0.25, 20, 64)
    assert torch.isneginf(m[0, :, :, 1:]).all() and not l[0, :, :, 1:].any()
    assert torch.isfinite(m[0, :, :, 0]).all()
    assert (m[1] == tva.MASK_VALUE).all()
    assert torch.equal(l[1, 0, 0], torch.tensor([64.0, 64.0, 64.0, 8.0]))
    torch.testing.assert_close(o[1, 0, 0, 3], v[1, 0, 192:].sum(0))
