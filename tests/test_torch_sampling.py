"""Port's sampling against the JAX package's: greedy equal, the top-k and
top-p masks exactly equal (ties included), draws reproducible from a seed,
and temperature-1 draws distributed as the softmax. The port draws from a
torch.Generator, not JAX's PRNG, so single draws are not compared."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import sampling as js
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models import sampling as ts
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS


def _logits(seed, shape, scale=1.0, ties=False):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    if ties:                                  # coarse grid: many equal values
        x = np.round(x * 2) / 2
    return x.astype(np.float32)


def test_greedy_equals_jax():
    x = _logits(0, (4, 100))
    got = ts.sample(torch.from_numpy(x), None, ts.SamplingParams(0.0))
    want = js.sample(jnp.asarray(x), None, js.SamplingParams(0.0))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_top_k_mask_equals_jax(k, ties):
    x = _logits(k, (6, 64), ties=ties)
    got = ts._mask_top_k(torch.from_numpy(x), k).numpy()
    want = np.asarray(js._mask_top_k(jnp.asarray(x), k))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p", [0.3, 0.8, 0.95])
def test_top_p_mask_equals_jax(p, ties):
    x = _logits(int(p * 100), (8, 100), scale=3.0, ties=ties)
    got = ts._mask_top_p(torch.from_numpy(x), p).numpy()
    want = np.asarray(js._mask_top_p(jnp.asarray(x), p))
    assert np.array_equal(got, want)


def test_same_seed_same_draws():
    x = torch.from_numpy(_logits(3, (16, 50)))
    params = ts.SamplingParams(temperature=0.8, top_k=10, top_p=0.9)

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([ts.sample(x, g, params) for _ in range(5)])

    assert torch.equal(draws(7), draws(7))
    assert not torch.equal(draws(7), draws(8))
    top10 = torch.topk(x, 10).indices
    d = draws(9)
    assert all(bool((top10[b] == d[:, b, None]).any(-1).all())
               for b in range(16))


def test_temperature_one_frequencies_follow_softmax():
    """200,000 draws from one row of 8 logits: every token's frequency
    within 0.005 of its softmax probability (the binomial standard error is
    at most 0.0011, so the bound is 4.5 of them)."""
    x = torch.tensor([[2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 1.5, 0.25]])
    n = 200_000
    toks = ts.sample(x.expand(n, 8), torch.Generator().manual_seed(0),
                     ts.SamplingParams(temperature=1.0))
    freq = torch.bincount(toks.long(), minlength=8).double() / n
    want = torch.softmax(x[0].double(), -1)
    assert float((freq - want).abs().max()) < 5e-3


def test_generate_with_sampling_runs_and_is_reproducible():
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=1)
    params = tl.init_weights(cfg, seed=4, device="cpu")
    prompt = torch.arange(1, 9)[None]
    params_s = ts.SamplingParams(temperature=0.9, top_k=20, top_p=0.9)
    a = tl.generate(params, cfg, prompt, steps=6, sampling=params_s, seed=3)
    b = tl.generate(params, cfg, prompt, steps=6, sampling=params_s, seed=3)
    assert a.shape == (1, 6) and np.array_equal(a, b)
    assert ((a >= 0) & (a < cfg.vocab_size)).all()
    greedy = tl.generate(params, cfg, prompt, steps=6)
    zero_t = tl.generate(params, cfg, prompt, steps=6,
                         sampling=ts.SamplingParams(temperature=0.0))
    assert np.array_equal(greedy, zero_t)
