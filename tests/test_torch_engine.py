"""Port's serving-engine device steps against the JAX package's, on the
debug preset with q4_k weights crossed by ``params_from_jax`` and identical
page tables: ``_quantize_rowwise`` bit-equal; ``_paged_prefill``,
``_paged_prefill_chunk`` and ``_paged_decode_step`` logits within
2e-2 * max (the model bound of tests/test_torch_llama.py) and the pools they
leave equal to within bf16 rounding. JAX's Pallas kernels run interpreted;
the port's wrappers take their plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
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
N_PAGES, PS = 16, 32
TRASH = N_PAGES - 1
ROWS = np.array([[5, 2, TRASH, TRASH],          # request A, 40 tokens
                 [4, 6, 8, TRASH],              # request B, 70 tokens
                 [TRASH] * 4], np.int32)        # idle slot


def _np(a):
    """JAX array -> NumPy with fp8 as its bytes."""
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _tnp(t):
    t = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.fixture(scope="module")
def params():
    jp = jl.init_weights(CFG, seed=21)
    tp = convert.params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jp), TCFG, device="cpu")
    return jl.quantize_params(jp, "q4_k"), tl.quantize_params(tp, "q4_k")


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_rowwise_bit_equal(fmt):
    x = np.random.default_rng(0).normal(size=(3, 5, 64)).astype(np.float32)
    x[1, 2] = 0.0                                    # an all-zero row
    x[2, 0, 7] = 40.0                                # one outlier
    for dt in (np.float32, None):
        xj = jnp.asarray(x) if dt else jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x) if dt else torch.from_numpy(x).to(
            torch.bfloat16)
        jq, js = jl._quantize_rowwise(xj, fmt)
        tq, ts = tl._quantize_rowwise(xt, fmt)
        assert tq.dtype == (torch.int8 if fmt == "int8"
                            else torch.float8_e4m3fn)
        assert np.array_equal(_tnp(tq), _np(jq))
        assert np.array_equal(ts.numpy(), np.asarray(js))


def _close(got, want, tol=2e-2):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= tol * scale, f"err {err} vs {tol} * {scale}"


def _pools_close(tp, jp):
    """Each layer of k / v equal to within bf16 rounding: |diff| at most
    one bf16 ulp of the layer's largest value (2^-7 of max). Quantized
    pools are held as dequantized values, where a bf16 rounding flip
    upstream can move an entry by one quantization step: int8's step is
    1/127 of the row's max (bound 2e-2 of max), e4m3's at the top binade
    32/448 (bound 2^-3 of max)."""
    for name in ("k", "v"):
        t, j = getattr(tp, name), getattr(jp, name)
        if tp.quantized:
            ts = getattr(tp, name + "_scale").numpy()
            js = np.asarray(getattr(jp, name + "_scale"))
            tv = t.float().numpy() * ts[..., None]
            jv = np.asarray(j, np.float32) * js[..., None]
            tol = 2e-2 if tp.quant_fmt == "int8" else 2 ** -3
        else:
            tv, jv, tol = t.float().numpy(), np.asarray(j, np.float32), 2 ** -7
        for li in range(CFG.n_layers):
            err = np.abs(tv[li] - jv[li]).max()
            assert err <= tol * np.abs(jv[li]).max(), (name, li, err)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(
        1, CFG.vocab_size, size=n).astype(np.int32)


@pytest.mark.parametrize("fmt", [False, "int8", "fp8"])
def test_prefill_chunk_and_decode_match_jax(params, fmt):
    jq, tq = params
    jpool = je.PagedKVPool.create(CFG, N_PAGES, PS, quantized=fmt)
    tpool = te.PagedKVPool.create(TCFG, N_PAGES, PS, quantized=fmt,
                                  device="cpu")
    rows_t = torch.from_numpy(ROWS)

    # request A: whole-prompt prefill, 40 tokens padded to 64
    a = _prompt(40, 1)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :40] = a
    jlog, jpool = je.paged_prefill(jq, CFG, jnp.asarray(toks),
                                   jnp.asarray(40, jnp.int32),
                                   jnp.asarray(ROWS[0]), jpool)
    tlog, tpool = te._paged_prefill(tq, TCFG, torch.from_numpy(toks), 40,
                                    rows_t[0], tpool)
    _close(tlog, jlog)

    # request B: chunked prefill, 70 tokens in chunks of 32
    b = _prompt(70, 2)
    for pos0 in (0, 32, 64):
        chunk = np.zeros((1, 32), np.int32)
        sl = b[pos0:pos0 + 32]
        chunk[0, :len(sl)] = sl
        last = pos0 == 64
        jlog_b, jpool = je.paged_prefill_chunk(
            jq, CFG, jnp.asarray(chunk), jnp.asarray(pos0, jnp.int32),
            jnp.asarray(70, jnp.int32), jnp.asarray(ROWS[1]), jpool,
            with_logits=last)
        tlog_b, tpool = te._paged_prefill_chunk(
            tq, TCFG, torch.from_numpy(chunk), pos0, 70, rows_t[1], tpool,
            with_logits=last)
        assert (tlog_b is None) == (not last)
    _close(tlog_b, jlog_b)
    _pools_close(tpool, jpool)

    # one batched decode step: A, B and an idle slot
    tokens = np.array([int(np.argmax(jlog)), int(np.argmax(jlog_b)), 0],
                      np.int32)
    lengths = np.array([40, 70, 1], np.int32)
    active = np.array([True, True, False])
    jlog_d, jpool = je.paged_decode_step(
        jq, CFG, jnp.asarray(tokens), jnp.asarray(lengths),
        jnp.asarray(ROWS), jpool, jnp.asarray(active), ppcb=4)
    tlog_d, tpool = te._paged_decode_step(
        tq, TCFG, torch.from_numpy(tokens), torch.from_numpy(lengths),
        rows_t, tpool, torch.from_numpy(active), ppcb=4)
    _close(tlog_d[:2], np.asarray(jlog_d)[:2])
    _pools_close(tpool, jpool)


def test_pool_writes_are_in_place():
    """The index writes land in the pool's own storage (no rebuild), at
    (layer, page, :, offset), and wholly invalid prefill runs and idle
    decode slots go to the trash page only."""
    pool = te.PagedKVPool.create(TCFG, N_PAGES, PS, quantized="fp8",
                                 device="cpu")
    ptrs = [t.data_ptr() for t in (pool.k, pool.v, pool.k_scale)]
    hkv, d = CFG.n_kv_heads, CFG.head_dim
    val = torch.randn(2, hkv, d).to(torch.float8_e4m3fn)
    pages = torch.tensor([3, TRASH])
    offs = torch.tensor([5, 0])
    te._pool_write(pool.k, 1, pages, offs, val)
    te._pool_write(pool.k_scale, 1, pages, offs,
                   torch.tensor([[2.0] * hkv, [3.0] * hkv]))
    assert [t.data_ptr() for t in (pool.k, pool.v, pool.k_scale)] == ptrs
    assert torch.equal(pool.k[1, 3, :, 5].view(torch.uint8),
                       val[0].view(torch.uint8))
    assert float(pool.k_scale[1, 3, :, 5].min()) == 2.0
    # a 64-token prompt of length 20 over pages [7, 9]: the second run
    # starts past the length and goes to the trash page
    run_pages = te._run_pages(torch.tensor([7, 9, TRASH, TRASH]),
                              torch.arange(2) * PS, 20, PS, TRASH)
    assert run_pages.tolist() == [7, TRASH]
    kt = torch.ones((hkv, 64, d), dtype=torch.bfloat16)
    bpool = te.PagedKVPool.create(TCFG, N_PAGES, PS, device="cpu")
    ptr = bpool.k.data_ptr()
    te._pool_write_pages(bpool.k, 0, run_pages, kt, PS)
    assert bpool.k.data_ptr() == ptr
    written = bpool.k[0].float().abs().sum(dim=(1, 2, 3)) > 0
    assert written.nonzero().flatten().tolist() == [7, TRASH]
