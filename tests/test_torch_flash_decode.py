"""Port's ``flash_decode`` plain version against the JAX ``flash_decode``
(Pallas, interpret mode on the CPU): MHA with Hq = Hkv = 8, D = 128
(``_decode_kernel_ht``) and GQA with Hq = 4, Hkv = 2, D = 64
(``_decode_kernel``), on a stacked cache with a layer index, ragged lengths
(one leaving whole splits empty), and 1 or 4 KV splits. Tolerance
1e-2 * max: bf16 inputs and output, f32 accumulation on both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.ops.flash_decode import flash_decode as jfd
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as tfd

L, B, S = 3, 2, 256


def _inputs(seed, hq, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, hq, d)).astype(np.float32)
    k = rng.normal(size=(L, B, hkv, S, d)).astype(np.float32)
    v = rng.normal(size=(L, B, hkv, S, d)).astype(np.float32)
    lengths = np.array([37, 200], np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (4, 2, 64)])
@pytest.mark.parametrize("splits", [1, 4])
def test_flash_decode_matches_jax(hq, hkv, d, splits):
    q, k, v, lengths = _inputs(hq + splits, hq, hkv, d)
    want = np.asarray(jfd(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths), layer=1,
        kv_splits=splits, block_k=64).astype(jnp.float32))
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tfd.flash_decode(bf(q), bf(k), bf(v), torch.from_numpy(lengths),
                           layer=1, kv_splits=splits).float().numpy()
    assert got.shape == (B, hq, d)
    assert np.abs(got - want).max() < 1e-2 * np.abs(want).max()


def test_splits_do_not_change_the_result():
    """Any split count gives the same attention (the LSE merge is exact up
    to f32 rounding), including splits wholly past the length."""
    q, k, v, lengths = _inputs(0, 4, 2, 64)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    lens = torch.from_numpy(lengths)
    one = tfd.flash_decode(*args, lens, layer=2, kv_splits=1).float()
    for n in (2, 5, 8):
        many = tfd.flash_decode(*args, lens, layer=2, kv_splits=n).float()
        assert (many - one).abs().max() <= 1e-2 * one.abs().max()


def test_partials_and_merge_compose():
    """flash_decode_partials + lse_merge (the two kernels' plain versions)
    equal flash_decode_ref."""
    q, k, v, lengths = _inputs(1, 8, 8, 128)
    args = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    lens = torch.from_numpy(lengths)
    parts = tfd.flash_decode_partials(*args, lens, scale=128 ** -0.5,
                                      n_splits=3, layer=0)
    assert parts.o.shape == (B, 8, 3, 1, 128)
    assert parts.m.shape == parts.s.shape == (B, 8, 3, 1, 1)
    ref = tfd.flash_decode_ref(*args, lens, kv_splits=3, layer=0)
    assert torch.equal(tfd.lse_merge(parts), ref)


def test_pick_splits():
    assert tfd.pick_splits(1, 32, 1024, 132) == 9
    assert tfd.pick_splits(1, 8, 1024, 132) == 16
    assert tfd.pick_splits(1, 32, 64, 132) == 1
    assert tfd.pick_splits(64, 32, 4096, 132) == 1

