"""The port's C++ scheduler (``utils/native_sched.py``) and
``Engine(scheduler="native")``: the unit decisions of
tests/test_native_sched.py against the JAX package's binding, and the
engine's tokens and allocator state against the port's python scheduler
and the JAX ``Engine(scheduler="native")`` on weights crossed by
``params_from_jax``, in the deferred mode and the eager one (an
``eos_id`` that fires). The native scheduler's limits raise, and so does a
failed build of its library."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu.models import engine as je
from ggml_cuda_experiments_tpu.models import llama as jl
from ggml_cuda_experiments_tpu.models.config import PRESETS
from ggml_cuda_experiments_tpu.utils import native_sched as jax_sched
from ggml_cuda_experiments_tpu_torch.models import convert
from ggml_cuda_experiments_tpu_torch.models import engine as te
from ggml_cuda_experiments_tpu_torch.models.config import (
    ModelConfig as TModelConfig)
from ggml_cuda_experiments_tpu_torch.utils import native, native_sched

CFG = dataclasses.replace(PRESETS["debug"], fuse_mlp=False, fuse_attn=False,
                          fuse_layer=False)
TCFG = TModelConfig(**dataclasses.asdict(CFG))      # the port's twin
KW = dict(max_batch=3, page_size=16, n_pages=17, max_seq_len=96)


def _both(**kw):
    return (native_sched.NativeScheduler(**kw),
            jax_sched.NativeScheduler(**kw))


def test_scheduler_unit_decisions():
    """tests/test_native_sched.py's case, each answer equal to the JAX
    binding's."""
    ours, theirs = _both(max_batch=2, n_pages=6, pages_per_seq=4,
                         page_size=16, max_seq_len=64)
    for s in (ours, theirs):
        s.add_request(0, prompt_len=10, max_new_tokens=6)   # 1 page
        s.add_request(1, prompt_len=30, max_new_tokens=40)  # 64/16 = 4
        s.add_request(2, prompt_len=5, max_new_tokens=5)    # no slot yet
    adm = ours.admit()
    want = theirs.admit()
    assert [(r, sl, list(p)) for r, sl, p in adm] == \
        [(r, sl, list(p)) for r, sl, p in want]
    assert [(r, sl) for r, sl, _ in adm] == [(0, 0), (1, 1)]
    assert list(adm[0][2]) == [0, 6, 6, 6]                # 6: trash page
    assert list(adm[1][2]) == [1, 2, 3, 4]
    assert (ours.num_waiting, ours.num_running, ours.num_free_pages) == \
        (theirs.num_waiting, theirs.num_running, theirs.num_free_pages) \
        == (1, 2, 1)
    hit = np.zeros(2, np.uint8)
    fins = [ours.step_complete(hit) for _ in range(5)]
    assert fins == [theirs.step_complete(hit) for _ in range(5)]
    assert fins[:4] == [[]] * 4 and fins[4] == [(0, 0)]
    adm2 = ours.admit()
    assert [(r, sl, list(p)) for r, sl, p in adm2] == \
        [(r, sl, list(p)) for r, sl, p in theirs.admit()]
    # FIFO free list: the never-used page 5 before the released page 0
    assert [(r, sl) for r, sl, _ in adm2] == [(2, 0)]
    assert list(adm2[0][2]) == [5, 6, 6, 6]
    for a, b in zip(ours.state(), theirs.state()):
        assert np.array_equal(a, b)


def test_eos_and_capacity():
    ours, theirs = _both(max_batch=4, n_pages=8, pages_per_seq=2,
                         page_size=16, max_seq_len=32)
    for s in (ours, theirs):
        for rid in range(3):
            s.add_request(rid, 4, 20)
    assert len(ours.admit()) == len(theirs.admit()) == 3
    hit = np.zeros(4, np.uint8)
    hit[1] = 1                                           # slot 1: EOS
    assert ours.step_complete(hit) == theirs.step_complete(hit) == [(1, 1)]
    lengths, table = ours.state()
    assert lengths[1] == 1 and np.all(table[1] == 8)     # reset
    for a, b in zip((lengths, table), theirs.state()):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def params():
    """f32 weights on both sides: in bf16 the two packages' prefills may
    flip a near-tied first token (models/convert.py)."""
    jp = jl.init_weights(CFG, seed=3, dtype=jnp.float32)
    return jp, convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jp), TCFG, device="cpu", dtype=torch.float32)


def _workload(seed=42, n=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, CFG.vocab_size, int(rng.integers(3, 12))
                          ).tolist(), int(rng.integers(2, 9)))
            for _ in range(n)]


def _serve(engine_cls, p, scheduler, eos_id=None):
    eng = engine_cls(p, TCFG if engine_cls is te.Engine else CFG,
                     scheduler=scheduler, eos_id=eos_id, **KW)
    rids = [eng.add_request(pr, max_new_tokens=n) for pr, n in _workload()]
    out = eng.run_to_completion()
    assert not eng.waiting and not eng.running
    return [out[r] for r in rids], eng


def test_engine_native_matches_python_and_jax(params):
    """Deferred mode (no eos_id), then eager mode with an eos_id taken
    from the middle of a request's deferred stream, so that it fires."""
    jp, tp = params
    got, eng = _serve(te.Engine, tp, "native")
    py, eng_py = _serve(te.Engine, tp, "python")
    want, eng_j = _serve(je.Engine, jp, "native")
    assert got == py == want
    # every page back: the python allocator whole, the native free lists
    # of both packages as long
    assert sorted(eng_py.allocator.free) == list(range(eng_py.trash_page))
    assert eng._nsched.num_free_pages == eng_j._nsched.num_free_pages \
        == eng.trash_page
    eos = next(t[1] for t in got if len(t) > 2)
    got_e, eng_e = _serve(te.Engine, tp, "native", eos)
    py_e, _ = _serve(te.Engine, tp, "python", eos)
    want_e, _ = _serve(je.Engine, jp, "native", eos)
    assert got_e == py_e == want_e
    assert any(len(a) < len(b) for a, b in zip(got_e, got)), \
        "the eos_id cut no request short"
    assert eng_e._nsched.num_free_pages == eng_e.trash_page


@pytest.mark.parametrize("kw, match", [
    (dict(decode_window=4), "decode_window"),
    (dict(prefill_chunk=32), "prefill_chunk"),
    (dict(scheduler="rust"), "scheduler")])
def test_the_native_schedulers_limits_raise(params, kw, match):
    kw = {"scheduler": "native", **kw}
    with pytest.raises(ValueError, match=match):
        te.Engine(params[1], TCFG, **KW, **kw)


@pytest.mark.parametrize("cxx, match", [("false", "failed"),
                                        ("no-such-compiler-x", "no compiler")])
def test_a_failed_build_raises(monkeypatch, tmp_path, cxx, match):
    """No quiet fallback: a compiler that fails, or none, raises with its
    output; nothing is left in place of the library."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match=match):
        native.build(root=tmp_path)
    assert not list(tmp_path.rglob(native.LIB_NAME))
