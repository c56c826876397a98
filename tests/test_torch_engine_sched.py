"""Port's ``Engine`` scheduling against the JAX package's ``Engine``,
greedy, on the debug preset with weights crossed by ``params_from_jax``:
the cases of tests/test_engine.py:138-197 (a decode window against single
steps, chunked against whole prefill, decode progressing during a long
prefill). Tokens must equal the JAX engine's and the port's own
``generate``'s exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import engine as je
from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import (
    ModelConfig as TModelConfig)
from ggml_cuda_experiments_tpu_torch.models import engine as te
from ggml_cuda_experiments_tpu_torch.models import llama as tl

CFG = dataclasses.replace(PRESETS["debug"], fuse_mlp=False, fuse_attn=False,
                          fuse_layer=False)
TCFG = TModelConfig(**dataclasses.asdict(CFG))      # the port's twin


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=11)
    return jp, convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), TCFG, device="cpu")


def _prompts(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).tolist() for n in sizes]


def _serve(engine_cls, p, prompts, new, **kw):
    eng = engine_cls(p, TCFG if engine_cls is te.Engine else CFG, **kw)
    rids = [eng.add_request(pr, max_new_tokens=new) for pr in prompts]
    out = eng.run_to_completion()
    assert len(eng.allocator.free) == kw["n_pages"] - 1, "pages leaked"
    return [out[r] for r in rids]


def _both(params, prompts, new, **kw):
    jp, tp = params
    got = _serve(te.Engine, tp, prompts, new, **kw)
    want = _serve(je.Engine, jp, prompts, new, **kw)
    assert got == want, f"port {got} vs jax {want}"
    return got


def _generate(tp, prompt, steps):
    return tl.generate(tp, TCFG, torch.tensor([prompt]), steps)[0].tolist()


KW = dict(max_batch=2, page_size=32, n_pages=64, max_seq_len=256)


def test_decode_window_matches_single_step(params):
    prompts = _prompts(5, [5, 12])
    got = _both(params, prompts, 7, decode_window=4, **KW)
    assert got == _serve(te.Engine, params[1], prompts, 7, **KW)
    assert got == [_generate(params[1], p, 7) for p in prompts]


def test_chunked_prefill_matches_whole(params):
    (prompt,) = _prompts(6, [75])
    (got,) = _both(params, [prompt], 5, prefill_chunk=32, **KW)
    assert got == _serve(te.Engine, params[1], [prompt], 5, **KW)[0]


def test_decode_progresses_during_long_prefill(params):
    """While a 120-token prompt is prefilled in chunks of 32, the running
    request advances one token every scheduler step."""
    short, long = _prompts(7, [6, 120])
    eng = te.Engine(params[1], TCFG, prefill_chunk=32, **KW)
    rid_s = eng.add_request(short, max_new_tokens=8)
    eng.step()
    rid_l = eng.add_request(long, max_new_tokens=4)
    short_req = next(r for r in eng.running if r.rid == rid_s)
    start = short_req.n_generated
    out = eng.step()
    nsteps = 1
    assert eng.prefilling
    while eng.prefilling:
        out.update(eng.step())
        nsteps += 1
    assert short_req.n_generated - start == nsteps
    out.update(eng.run_to_completion())
    want = _serve(je.Engine, params[0], [short, long], 8, **KW)
    assert out[rid_s] == want[0] == _generate(params[1], short, 8)
    assert out[rid_l] == _generate(params[1], long, 4) == want[1][:4]
