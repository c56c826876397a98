"""Port's causal ``flash_attention`` plain version against the JAX
``flash_attention`` (Pallas ``_flash_kernel``, interpret mode on the CPU),
at D = 64 with GQA 4/2 and D = 128 MHA, for T = 8 and 128. Tolerance
1e-2 * max: bf16 operands and output, f32 softmax on both sides."""

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
