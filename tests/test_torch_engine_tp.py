"""``Engine(mesh=)`` over 2 gloo ranks on the CPU (a (data=1, model=2)
mesh, each rank the same scheduler over its TP shard), as
tests/test_engine.py holds the JAX tensor-parallel engine: dense bf16
debug weights give the JAX single Engine's tokens exactly (and the port's
single Engine's); q4_0 weights (the port's ``quantize_params_sharded``)
over an int8 pool agree with the JAX Engine on globally encoded q4_0 in at
least 3 of 4 tokens, the JAX test's bound. One ``run_spmd`` runs both; no
jax at the top of this module (the ranks import it)."""

import numpy as np
import pytest

from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.models.engine import Engine
from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
from ggml_cuda_experiments_tpu_torch.parallel import tp
from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd

TCFG = PRESETS["debug"]
KW = dict(max_batch=2, page_size=32, n_pages=64, max_seq_len=256)


def _serve(eng, prompts, gen):
    rids = [eng.add_request(p, max_new_tokens=gen) for p in prompts]
    out = eng.run_to_completion()
    return [out[r] for r in rids]


def _rank(np_params, prompts, qprompt):
    mesh = pm.make_mesh(model=2, data=1)
    params = convert.params_from_jax(np_params, TCFG, device="cpu")
    out = {"single": _serve(Engine(params, TCFG, **KW), prompts, 5)}
    eng = Engine(tp.shard_params(params, mesh), TCFG, mesh=mesh, **KW)
    out["pool_heads"] = eng.pool.k.shape[2]
    out["dense"] = _serve(eng, prompts, 5)
    q = tp.shard_params(tp.quantize_params_sharded(params, "q4_0", 2), mesh)
    eng = Engine(q, TCFG, mesh=mesh, quantized_kv=True, **KW)
    out["q4_0"] = _serve(eng, [qprompt], 4)[0]
    return out


@pytest.fixture(scope="module")
def ranks():
    import jax
    from ggml_cuda_experiments_tpu.models import engine as je
    from ggml_cuda_experiments_tpu.models import llama as jl
    from ggml_cuda_experiments_tpu.models.config import PRESETS as JP
    cfg = JP["debug"]
    params = jl.init_weights(cfg, seed=11)
    rng = np.random.default_rng(1234)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (7, 11)]
    qprompt = rng.integers(0, cfg.vocab_size, size=9).tolist()
    want = _serve(je.Engine(params, cfg, **KW), prompts, 5)
    gq = jl.quantize_params(params, "q4_0", pad_intermediate=False)
    want_q = _serve(je.Engine(gq, cfg, quantized_kv=True, **KW),
                    [qprompt], 4)[0]
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       params)
    return (want, want_q), run_spmd(_rank, 2, "gloo", "cpu", timeout=300,
                                    args=(np_params, prompts, qprompt))


def test_tensor_parallel_engine_matches_single(ranks):
    (want, _), outs = ranks
    for o in outs:
        assert o["pool_heads"] == 1           # 2 KV heads over model = 2
        assert o["dense"] == want, f"{o['dense']} vs JAX {want}"
        assert o["dense"] == o["single"]


def test_tensor_parallel_engine_quantized_weights(ranks):
    (_, want_q), outs = ranks
    for o in outs:
        agree = sum(a == b for a, b in zip(o["q4_0"], want_q))
        assert agree >= 3, f"{o['q4_0']} vs {want_q}"
    assert outs[0]["q4_0"] == outs[1]["q4_0"]


@pytest.mark.parametrize("kw", [dict(prefill_chunk=32),
                                dict(decode_window=4)])
def test_mesh_refuses_chunked_prefill_and_windows(kw):
    from ggml_cuda_experiments_tpu_torch.models import llama
    params = llama.init_weights(TCFG, seed=0, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        Engine(params, TCFG, mesh=object(), **KW, **kw)
