"""Port's LSE combine: the properties tests/test_lse.py pins for the JAX
version (associativity, identity, split equals full, masked block), and
agreement with the JAX lse_combine_stacked / lse_finalize on the same
partials to 1e-6 (f32, the same operations in the same order)."""

import jax.numpy as jnp
import numpy as np
import torch

from ggml_cuda_experiments_tpu.ops import lse as jlse
from ggml_cuda_experiments_tpu.oracle.attention import softmax_ref
from ggml_cuda_experiments_tpu_torch.ops import lse as tlse


def _chunk(scores, v):
    m = np.max(scores, axis=-1, keepdims=True)
    p = np.exp(scores - m)
    return (p @ v, m, np.sum(p, axis=-1, keepdims=True))


def _rand(rng, rows=4, d=8, kv=16):
    return _chunk(rng.normal(size=(rows, kv)).astype(np.float32),
                  rng.normal(size=(kv, d)).astype(np.float32))


def _t(p):
    return tlse.AttnPartial(*(torch.from_numpy(np.asarray(f)) for f in p))


def _close(a, b, tol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=tol,
                                   rtol=tol)


def test_associativity(rng):
    a, b, c = (_t(_rand(rng)) for _ in range(3))
    _close(tlse.lse_combine(tlse.lse_combine(a, b), c),
           tlse.lse_combine(a, tlse.lse_combine(b, c)), 1e-5)


def test_identity(rng):
    a = _t(_rand(rng))
    _close(tlse.lse_combine(a, tlse.lse_identity(a.o.shape)), a, 1e-6)


def test_split_equals_full_softmax(rng):
    rows, kv, d, nb = 4, 64, 16, 4
    scores = rng.normal(size=(rows, kv)).astype(np.float32) * 3.0
    v = rng.normal(size=(kv, d)).astype(np.float32)
    want = softmax_ref(scores) @ v
    bs = kv // nb
    parts = [_t(_chunk(scores[:, i * bs:(i + 1) * bs], v[i * bs:(i + 1) * bs]))
             for i in range(nb)]
    acc = parts[0]
    for p in parts[1:]:
        acc = tlse.lse_combine(acc, p)
    np.testing.assert_allclose(tlse.lse_finalize(acc).numpy(), want,
                               atol=1e-5, rtol=1e-5)
    stacked = tlse.AttnPartial(*(torch.stack(f) for f in zip(*parts)))
    np.testing.assert_allclose(
        tlse.lse_finalize(tlse.lse_combine_stacked(stacked)).numpy(), want,
        atol=1e-5, rtol=1e-5)


def test_masked_block_is_identity_and_finite(rng):
    a = _t(_rand(rng))
    masked = tlse.lse_identity(a.o.shape)
    _close(tlse.lse_combine(masked, a), a, 1e-6)
    out = tlse.lse_finalize(tlse.lse_combine(masked, masked))
    assert torch.isfinite(out).all() and (out == 0).all()


def test_matches_jax_stacked_merge(rng):
    """Five stacked partials (one of them empty) folded along axis 1."""
    parts = [_rand(rng, rows=6, d=8) for _ in range(5)]
    o, m, s = (np.stack(f, axis=1) for f in zip(*parts))
    m[:, 2] = -np.inf
    s[:, 2] = 0.0
    o[:, 2] = 0.0
    want = jlse.lse_combine_stacked(
        jlse.AttnPartial(jnp.asarray(o), jnp.asarray(m), jnp.asarray(s)),
        axis=1)
    got = tlse.lse_combine_stacked(_t((o, m, s)), axis=1)
    _close(got, want, 1e-6)
    np.testing.assert_allclose(
        tlse.lse_finalize(got, out_dtype=torch.float32).numpy(),
        np.asarray(jlse.lse_finalize(want, out_dtype=jnp.float32)),
        atol=1e-6, rtol=1e-6)
