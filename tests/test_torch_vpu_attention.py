"""Port's ``vpu_attention`` (plain version on the CPU) against the JAX
``vpu_attention`` (Pallas ``_vpu_attn_kernel``, interpret mode on the CPU,
as tests/test_vpu_attention.py runs it), on the same numpy inputs: o within
2e-5 absolute (the JAX test's bound, f32 unit-normal inputs), lse within
1e-5 relative of JAX's ``_vpu_attention_fwd_impl``, the gradients within
5e-5 of ``jax.vjp`` (the JAX test's bound), and the backward against
``torch.autograd.gradcheck`` in f64."""

import jax
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


def _jax_fwd(q, k, v, lengths, causal, q0_pos, block_k=128):
    o, lse = jva._vpu_attention_fwd_impl(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), causal=causal,
        scale=float(1.0 / np.sqrt(q.shape[-1])), block_k=block_k,
        q0_pos=q0_pos, interpret=None)
    return np.asarray(o), np.asarray(lse)


def _port_fwd(q, k, v, lengths, causal, q0_pos, block_k=128):
    o, lse = tva._vpu_attention_fwd_impl(
        *(torch.from_numpy(a) for a in (q, k, v, lengths)), causal=causal,
        scale=None, block_k=block_k, q0_pos=q0_pos)
    return o.numpy(), lse.numpy()


# the JAX test's shapes: head dims 40 / 64 / 80 / 128, few queries
@pytest.mark.parametrize("D,T,causal", [(40, 3, False), (64, 5, True),
                                        (80, 16, True), (128, 4, True)])
def test_matches_jax(D, T, causal):
    B, H, S = 2, 3, 256
    q, k, v = _inputs(0, B, H, T, S, D)
    lengths = np.array([S, S - 37], np.int32)
    q0_pos = T - 1 if causal else 0
    jo, jlse = _jax_fwd(q, k, v, lengths, causal, q0_pos)
    want = np.asarray(jva.vpu_attention(
        *(jnp.asarray(a) for a in (q, k, v, lengths)), causal, None, 128,
        q0_pos))
    np.testing.assert_array_equal(jo, want)
    o, lse = _port_fwd(q, k, v, lengths, causal, q0_pos)
    assert o.dtype == np.float32 and o.shape == (B, H, T, D)
    np.testing.assert_allclose(o, jo, rtol=0, atol=2e-5)
    assert lse.shape == (B, H, T)
    np.testing.assert_allclose(lse, jlse, rtol=1e-5, atol=0)
    got = tva.vpu_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            torch.from_numpy(lengths), causal, None, 128,
                            q0_pos)
    np.testing.assert_array_equal(got.numpy(), o)


def test_row_without_keys_gets_mean_of_v():
    """lengths == 0: every score is the mask constant, so the row is the
    mean of v over all S keys and lse = MASK + log(S), as in JAX."""
    B, H, T, S, D = 2, 2, 3, 128, 64
    q, k, v = _inputs(3, B, H, T, S, D)
    lengths = np.array([0, 90], np.int32)
    jo, jlse = _jax_fwd(q, k, v, lengths, True, S - T, block_k=64)
    o, lse = _port_fwd(q, k, v, lengths, True, S - T, block_k=64)
    np.testing.assert_allclose(o, jo, rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse, jlse, rtol=1e-5, atol=0)
    mean_v = np.broadcast_to(v[0].mean(1, keepdims=True), o[0].shape)
    np.testing.assert_allclose(o[0], mean_v, rtol=0, atol=2e-5)
    assert np.all(lse[0] < -1e38)


def test_grads_match_jax_vjp():
    """torch.autograd through the op against jax.vjp of the JAX op, on the
    JAX test's shapes (causal suffix window, lengths 100 of 128)."""
    B, H, T, S, D = 1, 2, 4, 128, 64
    q, k, v = _inputs(1, B, H, T, S, D)
    do = np.random.default_rng(2).normal(size=(B, H, T, D)).astype(
        np.float32)
    lengths = np.array([100], np.int32)

    def fused(q, k, v):
        return jva.vpu_attention(q, k, v, jnp.asarray(lengths), True, None,
                                 128, T - 1)

    jo, vjp = jax.vjp(fused, *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tva.vpu_attention(tq, tk, tv, torch.from_numpy(lengths), True, None,
                          128, T - 1)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=2e-5)
    o.backward(torch.from_numpy(do))
    for got, want, name in zip((tq.grad, tk.grad, tv.grad), jgrads, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=5e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("S,D,block_k", [(128, 136, 128), (200, 64, 128)])
def test_rejects_what_jax_cannot_run(S, D, block_k):
    """D > 128 (JAX's lane pad fails) and S % min(block_k, S) != 0 (JAX
    asserts) raise ValueError."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 1, 1, 2, S, D))
    with pytest.raises(ValueError):
        tva.vpu_attention(q, k, v, torch.tensor([S], dtype=torch.int32),
                          True, None, block_k, S - 2)


@pytest.mark.parametrize("causal", [True, False])
def test_gradcheck_f64(causal):
    """The backward algebra against finite differences of the plain
    forward, in f64 at a tiny size. Every row has a visible key: for a row
    with none, lse = MASK + log(S) rounds to MASK in any float, so the
    reference's P = exp(s - lse) is 1, not 1/S, there (in JAX as here)."""
    rng = np.random.default_rng(5)
    B, H, T, S, D = 2, 1, 3, 8, 4
    q, k, v = (torch.from_numpy(rng.normal(size=shape)).requires_grad_()
               for shape in ((B, H, T, D), (B, H, S, D), (B, H, S, D)))
    lengths = torch.tensor([6, 3], dtype=torch.int32)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tva.vpu_attention(q, k, v, lengths, causal, None, 8,
                                          4),
        (q, k, v), eps=1e-6, atol=1e-6)
