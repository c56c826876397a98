"""Ragged batches: rows of unequal length decode together (on the CPU; the
JAX package's Pallas kernels run interpreted, the port's wrappers take
their plain versions).

The counterpart of tests/test_model.py::test_ragged_batch_decode (a
two-prompt prefill equals each prompt's own), then the decode path's own
case: B = 2, 4 and 8 rows of the debug model, each prefilled alone to a
different length, copied into one B-row ``KVCache`` (its cache rows and
``lengths``) and decoded together for 4 steps, teacher-forced with each
row's batch-1 greedy tokens. Each row's logits are held against the JAX
package's batch-1 run of that row (its prompt's prefill, then 4 greedy
decode steps of the row alone) within 2e-2 * max, as tests/test_torch_llama.py holds decode; the batch's
greedy token must equal the batch-1 run's, or depart only where that run's
top two logits lie within the same 2e-2 * max (a near-tie, PERF.md §2).
The batch runs the linears' GEMM (its stream route on the card) where the
batch-1 run takes the exact f32 matvec, and ``flash_decode`` splits each
row by its own length."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import llama as tl
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig

CFG = dataclasses.replace(PRESETS["debug"], fuse_mlp=False, fuse_attn=False,
                          fuse_layer=False)
TCFG = ModelConfig(**dataclasses.asdict(CFG))
LENGTHS = (5, 12, 3, 17, 9, 30, 2, 24)      # B = 2, 4, 8: the first B
STEPS = 4
S = 64                                      # cache slots a row


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=21)
    tp = convert.params_from_jax(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp), TCFG,
        device="cpu")
    return jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")


@pytest.fixture(scope="module")
def rows(params):
    """Per row: its prompt, the JAX batch-1 logits [1 + STEPS, V] (the
    prefill's, then each greedy decode step's) and greedy tokens, and the
    port's cache after prefilling the prompt alone. JAX prefills the 8
    prompts as one batch padded at the end to 32 tokens (causal: a row's
    first n positions do not see its padding; one trace for all), then
    decodes each row alone from its own cache row at its own length (one
    trace for all)."""
    jq, tq = params
    rng = np.random.default_rng(22)
    prompts = [rng.integers(0, CFG.vocab_size, size=(1, n)).astype(np.int32)
               for n in LENGTHS]
    padded = np.zeros((len(LENGTHS), 32), np.int32)
    for i, p in enumerate(prompts):
        padded[i, :p.shape[1]] = p[0]
    jall, jc = jl.prefill(jq, CFG, jnp.asarray(padded),
                          jl.KVCache.create(CFG, len(LENGTHS), S),
                          all_logits=True)
    out = []
    for i, (n, prompt) in enumerate(zip(LENGTHS, prompts)):
        c = jl.KVCache(k=jc.k[:, i:i + 1], v=jc.v[:, i:i + 1],
                       lengths=jnp.asarray([n], jnp.int32))
        logs = [np.asarray(jall[i, n - 1])]
        toks = [int(np.argmax(logs[0]))]
        for _ in range(STEPS):
            logits, c = jl.decode_step(
                jq, CFG, jnp.asarray([toks[-1]], jnp.int32), c)
            logs.append(np.asarray(logits[0]))
            toks.append(int(np.argmax(logs[-1])))
        tc = tl.KVCache.create(TCFG, 1, S, device="cpu")
        tlog, tc = tl.prefill(tq, TCFG, torch.from_numpy(prompt), tc)
        out.append(dict(logits=np.stack(logs), tokens=toks, cache=tc,
                        prefill=tlog[0].numpy()))
    return out


def _close(got, want, tol=2e-2):
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


def _greedy_or_near_tie(got, want, tok, tol=2e-2):
    if int(np.argmax(got)) == tok:
        return
    top2 = np.sort(want)[-2:]
    assert top2[1] - top2[0] <= tol * np.abs(want).max(), (
        f"greedy token {int(np.argmax(got))} != {tok}, not at a near-tie")


def test_batch_prefill_matches_single(params):
    """Two prompts prefilled together equal each prompt's own prefill (the
    JAX test's bound: 2e-2 absolute and relative)."""
    _, tq = params
    rng = np.random.default_rng(23)
    t1, t2 = (torch.from_numpy(rng.integers(0, CFG.vocab_size, size=(1, 8)))
              for _ in range(2))
    both, _ = tl.prefill(tq, TCFG, torch.cat([t1, t2]),
                         tl.KVCache.create(TCFG, 2, 256, device="cpu"))
    for i, t in enumerate((t1, t2)):
        one, _ = tl.prefill(tq, TCFG, t,
                            tl.KVCache.create(TCFG, 1, 256, device="cpu"))
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(),
                                   atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("batch", [2, 4, 8])
def test_ragged_rows_decode_as_alone(params, rows, batch):
    _, tq = params
    rs = rows[:batch]
    cache = tl.KVCache.create(TCFG, batch, S, device="cpu")
    for b, r in enumerate(rs):
        _close(r["prefill"], r["logits"][0])
        cache.k[:, b] = r["cache"].k[:, 0]
        cache.v[:, b] = r["cache"].v[:, 0]
        cache.lengths[b] = r["cache"].lengths[0]
    assert cache.lengths.tolist() == list(LENGTHS[:batch])
    for step in range(1, STEPS + 1):
        toks = torch.tensor([r["tokens"][step - 1] for r in rs],
                            dtype=torch.int32)
        logits, cache = tl.decode_step(tq, TCFG, toks, cache)
        assert logits.shape == (batch, CFG.vocab_size)
        for b, r in enumerate(rs):
            got = logits[b].numpy()
            _close(got, r["logits"][step])
            _greedy_or_near_tie(got, r["logits"][step], r["tokens"][step])
    assert cache.lengths.tolist() == [n + STEPS for n in LENGTHS[:batch]]
