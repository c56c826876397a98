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
