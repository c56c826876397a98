"""The port's CUDA kernels against their plain PyTorch versions, on the
card, at small and ragged shapes (the full-size checks are in
chip_smoke.py). Marked ``cuda``: they skip where no CUDA device is
present. This file imports no jax, so it also runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: the exact-f32 matvec 1e-4 * max, the bf16
GEMM 2e-2 * max, attention 1e-2 * max, paged decode 2e-3 * max on bf16 pages
and 2e-2 * max on int8 / fp8 pages, model logits 2e-2 * max; rope_pack is
exact. The int8-activation kernels: the matvec 1e-4 * max (its integer dots
are exact and its operands equal the plain version's), the fused MLP,
attention and layer kernels 5e-3 * max (the JAX package's bound for its
fused kernels: an f32 ulp in a value before its int8 quantization may move
one step), k_new / v_new 2e-2 * max(1, max); model_step equals chained
layer_step launches. The q6_k matvecs 1e-4 * max (exact f32, and the hybrid
whose int8 operands equal the plain version's); flash_decode on an int8 /
fp8 cache 2e-3 * max in MHA (the kernel and its plain version share the
quantization; only f32 sums differ in order) and 1e-2 * max with GQA
groups, whose p * v_scale is rounded to bf16 as in the reference. The
Q8_0 / Q4_0 kernels: q40_matvec and q40_q8_matvec 1e-4 * max (as their
q4_k instances), q80_matvec 1e-4 * max (it reproduces its plain version's
rounding, bf16(x) * bf16(q d) summed in f32), the GEMMs 2e-2 * max (as
q4k_gemm); the device quantizer bit-equal to the oracle. The q4_k s6
instances (q4k_s6_matvec, q4k_s6_q8_matvec, q4k_s6_gemm, the fused MLP and
attention on s6 weights) at their Q4_K-E instances' tolerances."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
from ggml_cuda_experiments_tpu_torch.models import engine
from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
from ggml_cuda_experiments_tpu_torch.ops import paged_attention as pa
from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _randn(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.normal(size=shape) * scale).astype(np.float32))


def _check(fn, *args, tol, **kw):
    got = fn(*args, **kw)
    with plain_versions():
        ref = fn(*args, **kw)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), float(err)


@pytest.mark.parametrize("n,k", [(300, 256), (4096, 4096), (37, 12288)])
def test_q4k_matvec(dev, n, k):
    ql = qm.quantize(_randn(0, n, k, scale=k ** -0.5).to(dev))
    before = qm.LAUNCHES["q4k_matvec"]
    _check(qm.q4k_matvec, _randn(1, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q4k_matvec"] == before + 1


def test_q4k_matvec_any_k_after_a_smaller_call(dev):
    """K = 5632 (tinyllama's w_down, K/32 = 176) and 11008 (llama2-7b's
    unpadded w_down: 50.9 KB of shared memory, above the 48 KB default, so
    the kernel's limit is raised as the calls grow) after K = 4096."""
    for k in (4096, 5632, 11008):
        ql = qm.quantize(_randn(40, 96, k, scale=k ** -0.5).to(dev))
        before = qm.LAUNCHES["q4k_matvec"]
        _check(qm.q4k_matvec, _randn(41, 1, k).to(dev), ql, tol=1e-4)
        assert qm.LAUNCHES["q4k_matvec"] == before + 1


def _q6_weight(seed, n, k, dev):
    w = _randn(seed, n, k, scale=k ** -0.5)
    w[0, :16] = 0.01
    w[0, 3], w[0, 9] = 0.5, -0.5             # a +/- tie, + first
    w[1, 16:32] = -0.02
    w[1, 20], w[1, 21] = -0.25, 0.25         # a -/+ tie, - first
    w[2, :16] = 0.0
    return w.to(dev)


def test_q6k_quantizer_on_the_card_is_bit_equal(dev):
    """The device quantizer on the card (rows with ties for the largest |x|
    included) against the NumPy oracle."""
    from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref
    w = _q6_weight(42, 64, 4096, dev)
    got = qm.quantize(w, "q6_k")
    want = qm.from_oracle(quant_ref.quantize_q6_k(w.cpu().numpy()),
                          device="cpu")
    for f in ("qs", "qh", "es"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("n,k", [(300, 2048), (37, 6144), (4096, 2048)])
def test_q6k_matvec(dev, n, k):
    ql = qm.quantize(_q6_weight(43, n, k, dev), "q6_k")
    before = qm.LAUNCHES["q6k_matvec"]
    _check(qm.q6k_matvec, _randn(44, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q6k_matvec"] == before + 1


@pytest.mark.parametrize("n,k", [(300, 4096), (37, 8192), (4096, 4096)])
def test_q6k_q8_matvec(dev, n, k):
    ql = qm.quantize(_q6_weight(45, n, k, dev), "q6_k")
    before = qm.LAUNCHES["q6k_q8_matvec"]
    _check(qm.q6k_q8_matvec, _randn(46, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q6k_q8_matvec"] == before + 1


def _q32_weight(seed, n, k, dev):
    """A weight with +v / -v ties for the largest |x| of a 32-block (either
    sign first) and an all-zero block."""
    w = _randn(seed, n, k, scale=k ** -0.5)
    w[0, :32] = 0.01
    w[0, 3], w[0, 20] = 0.5, -0.5
    w[1, 32:64] = -0.02
    w[1, 40], w[1, 41] = -0.25, 0.25
    w[2, :32] = 0.0
    return w.to(dev)


@pytest.mark.parametrize("fmt", ["q8_0", "q4_0"])
def test_q32_quantizer_on_the_card_is_bit_equal(dev, fmt):
    from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref
    w = _q32_weight(50, 64, 5632, dev)
    got = qm.quantize(w, fmt)
    want = qm.from_oracle(getattr(quant_ref, f"quantize_{fmt}")(
        w.cpu().numpy()), device="cpu")
    for f in ("qs", "d"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.parametrize("name,fmt", [("q80_matvec", "q8_0"),
                                      ("q40_matvec", "q4_0")])
@pytest.mark.parametrize("n,k", [(300, 4096), (37, 5632), (4096, 1024),
                                 (130, 96), (64, 12288)])
def test_q32_matvec(dev, name, fmt, n, k):
    ql = qm.quantize(_q32_weight(51, n, k, dev), fmt)
    before = qm.LAUNCHES[name]
    _check(getattr(qm, name), _randn(52, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES[name] == before + 1


def _q80_weight(n, k, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + n + k)
    ql = qm.quantize(torch.randn((n, k), generator=g, device=dev)
                     * k ** -0.5, "q8_0")
    return ql, torch.randn((1, k), generator=g, device=dev)


# tinyllama's narrow linears and the 7B W_o (one warp a row group), N 1 /
# 37 / 300 (q80_plan splits them in 2-8: a part-empty row group, a part
# step), the start cases (N = 4) and the K edges: 96 and 8224 (K/32 off a
# multiple of 8: the 4-byte scale path, one-block split bounds), 11008 and
# 12288 (three stages, one CTA an SM)
Q80_SHAPES = [(2048, 5632), (4096, 4096), (2560, 2048), (1, 4096),
              (37, 5632), (300, 2048), (4, 4096), (4, 5632), (1, 96),
              (130, 96), (37, 8224), (300, 11008), (4096, 11008),
              (37, 12288), (4096, 12288)]


@pytest.mark.parametrize("n,k", Q80_SHAPES)
def test_q80_matvec_is_bitwise_repeatable(dev, n, k):
    """Within 1e-4 * max of the plain version, two calls bit-equal (the
    splits fold in a fixed order; the tensor cores' sums are fixed)."""
    ql, x = _q80_weight(n, k, dev)
    before = qm.LAUNCHES["q80_matvec"]
    a, b = qm.q80_matvec(x, ql), qm.q80_matvec(x, ql)
    assert qm.LAUNCHES["q80_matvec"] == before + 2
    assert torch.equal(a, b)
    _check(qm.q80_matvec, x, ql, tol=1e-4)


def test_q80_matvec_off_16_byte_bases(dev):
    """x and d off 16 bytes: x copied in by plain loads, d through 4-byte
    words (the first half's place from the address)."""
    n, k = 300, 4096
    ql, x = _q80_weight(n, k, dev, seed=1)
    xb = torch.zeros(k + 1, device=dev)
    xb[1:] = x[0]
    db = torch.zeros(n * k // 32 + 1, dtype=torch.float16, device=dev)
    db[1:] = ql.d.reshape(-1)
    odd = dataclasses.replace(ql, d=db[1:].view(n, k // 32))
    assert odd.d.data_ptr() % 16 and xb[1:].data_ptr() % 16
    want = qm.q80_matvec(x, ql)
    got = qm.q80_matvec(xb[1:].view(1, k), odd)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_q80_matvec_graph_replays_after_another_shape(dev):
    """A graph captured after a call at another K and N (another ring depth
    and split) replays to the eager result."""
    ql1, x1 = _q80_weight(4096, 12288, dev, seed=2)
    ql2, x2 = _q80_weight(2048, 5632, dev, seed=3)
    qm.q80_matvec(x1, ql1)
    want = qm.q80_matvec(x2, ql2)
    out = torch.empty_like(want)
    qm.q80_matvec(x2, ql2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(qm.q80_matvec(x2, ql2))
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


@pytest.mark.parametrize("k", [96, 2048, 4096, 5632, 8192, 8224, 11008,
                               12288, 28672])
def test_q80_stages_match_the_runtime(dev, k):
    """q80_stages' CTAs an SM (its shared-memory arithmetic) is what the
    runtime makes resident, and no spill."""
    from ggml_cuda_experiments_tpu_torch.ops import probes
    stages, per_sm = qm.q80_stages(k)
    info = probes.kernel_info("q80_matvec", k)
    assert info["ctas_per_sm"] == per_sm, info
    assert info["local_bytes"] == 0, info


@pytest.mark.parametrize("n,k", [(640, 4096), (300, 12288), (4096, 4096)])
def test_q40_q8_matvec(dev, n, k):
    ql = qm.quantize(_q32_weight(53, n, k, dev), "q4_0")
    before = qm.LAUNCHES["q40_q8_matvec"]
    _check(qm.q40_q8_matvec, _randn(54, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q40_q8_matvec"] == before + 1


GEMMS = {"q4_k": "q4k_gemm", "q4_0": "q40_gemm", "q8_0": "q80_gemm"}
# M at each route's edges (gemm_route) and a part-empty tile of every
# instance the C side launches (stream: 8, 16 or 32 token rows, M 5, 12,
# 17; tc: 64, 128 or 256 tokens a CTA, M 33, 70, 300), N ragged against
# both kernels' row tiles, K ending on half a stage (544, 96: 32-block
# formats only), tinyllama's w_down (5632) and the unpadded 7B w_down (11008)
GEMM_MS = (2, 5, 8, 12, 17, qm.STREAM_MAX_M, qm.STREAM_MAX_M + 1, 70, 128,
           300, 512)
GEMM_CASES = [(fmt, m, n, k) for fmt in GEMMS for m in GEMM_MS
              for n in (130, 300) for k in (512, 544, 96, 4096, 5632, 11008)
              if fmt != "q4_k" or k % 256 == 0]


def _gemm_weight(fmt, n, k, dev):
    if fmt == "q4_k":
        return qm.quantize(_randn(2, n, k, scale=k ** -0.5).to(dev))
    return qm.quantize(_q32_weight(55, n, k, dev), fmt)


@pytest.mark.parametrize("fmt,m,n,k", GEMM_CASES,
                         ids=[f"{f}-M{m}-N{n}-K{k}" for f, m, n, k in GEMM_CASES])
def test_quant_gemm(dev, fmt, m, n, k):
    """Each format's GEMM on both routes against its plain version, one
    launch a call on the route gemm_route picks."""
    name = GEMMS[fmt]
    ql = _gemm_weight(fmt, n, k, dev)
    x = _randn(56, m, k).to(dev, torch.bfloat16)
    route = qm.gemm_route(m)
    before = qm.LAUNCHES[name], qm.GEMM_ROUTE_LAUNCHES[route]
    _check(getattr(qm, name), x, ql, tol=2e-2)
    assert (qm.LAUNCHES[name], qm.GEMM_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("fmt", sorted(GEMMS))
@pytest.mark.parametrize("m", [8, 200])
def test_quant_gemm_is_bitwise_repeatable(dev, fmt, m):
    """Fixed-order sums: repeated calls and the replays of a captured graph
    give the same bits."""
    fn = getattr(qm, GEMMS[fmt])
    ql = _gemm_weight(fmt, 300, 4096, dev)
    x = _randn(57, m, 4096).to(dev, torch.bfloat16)
    first = fn(x, ql)
    assert all(torch.equal(first, fn(x, ql)) for _ in range(3))
    fn(x, ql)                                   # warm-up outside capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = fn(x, ql)
    for _ in range(3):
        y.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, first)


@pytest.mark.parametrize("fmt", sorted(GEMMS))
def test_quant_gemm_refuses_an_unaligned_x_base(dev, fmt):
    """x must start on 16 bytes (the kernels copy it 16 bytes at a time)."""
    ql = _gemm_weight(fmt, 64, 512, dev)
    buf = torch.zeros(4 * 512 + 1, dtype=torch.bfloat16, device=dev)
    x = buf[1:].view(4, 512)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = dict(qm.LAUNCHES)
    with pytest.raises(ValueError):
        getattr(qm, GEMMS[fmt])(x, ql)
    assert qm.LAUNCHES == before


@pytest.mark.parametrize("phase", sorted(qm.GEMM_PHASES))
@pytest.mark.parametrize("m", [8, 200, 512])
def test_q4k_gemm_phases(dev, phase, m):
    """The tc route's measurement phases at any M (the stream route's M
    too), each one launch counted as q4k_gemm_phase: "all" is the
    production call itself, "stream" leaves y zero; "dequant" and "dot"
    give wrong values by design and are only launched."""
    ql = _gemm_weight("q4_k", 300, 4096, dev)
    x = _randn(58, m, 4096).to(dev, torch.bfloat16)
    want = qm.q4k_gemm(x, ql)
    before = dict(qm.LAUNCHES)
    y = qm.q4k_gemm(x, ql, phase=phase)
    torch.cuda.synchronize()
    assert y.shape == (m, 300)
    assert qm.LAUNCHES["q4k_gemm_phase"] == \
        before["q4k_gemm_phase"] + (phase != "all")
    assert qm.LAUNCHES["q4k_gemm"] == before["q4k_gemm"] + (phase == "all")
    if phase == "all":
        assert torch.equal(y, want)
    elif phase == "stream":
        assert not y.any()
    s6 = qm.quantize(_randn(2, 300, 4096, scale=4096 ** -0.5).to(dev),
                     "q4_k", enc="s6")
    with pytest.raises(ValueError):          # Q4_K-E only
        qm.q4k_gemm(x, s6, phase=phase if phase != "all" else "dot")


@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (4, 2, 64), (32, 2, 128),
                                      (64, 8, 128)])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_flash_decode(dev, hq, hkv, d, splits):
    L, B, S = 3, 3, 320
    q = _randn(4, B, hq, d).to(dev, torch.bfloat16)
    k = _randn(5, L, B, hkv, S, d).to(dev, torch.bfloat16)
    v = _randn(6, L, B, hkv, S, d).to(dev, torch.bfloat16)
    lengths = torch.tensor([0, 37, 320], dtype=torch.int32, device=dev)
    _check(fd.flash_decode, q, k, v, lengths, layer=2, kv_splits=splits,
           tol=1e-2)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d", [(8, 8, 128), (4, 2, 64), (32, 4, 64)])
@pytest.mark.parametrize("splits", [None, 1, 5])
def test_flash_decode_quantized(dev, fmt, hq, hkv, d, splits):
    L, B, S = 3, 3, 320
    q = _randn(47, B, hq, d).to(dev, torch.bfloat16)
    k, ks = llama._quantize_rowwise(_randn(48, L, B, hkv, S, d).to(dev), fmt)
    v, vs = llama._quantize_rowwise(_randn(49, L, B, hkv, S, d).to(dev), fmt)
    lengths = torch.tensor([0, 37, 320], dtype=torch.int32, device=dev)
    before = dict(fd.LAUNCHES)
    # a GQA group rounds p * v_scale to bf16: one ulp of expf between the
    # kernel and its plain version can flip that rounding (2^-8 of a term)
    _check(fd.flash_decode, q, k, v, lengths, layer=2, kv_splits=splits,
           k_scale=ks, v_scale=vs, tol=2e-3 if hq == hkv else 1e-2)
    assert fd.LAUNCHES["flash_decode_q"] == before["flash_decode_q"] + 1
    assert fd.LAUNCHES["flash_decode"] == before["flash_decode"]


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("g", [1, 4, 8, 16])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_decode_partials_split_edges(dev, fmt, g, d):
    """The partials kernel against ``_partials_ref`` split for split, at
    lengths 0, 1, 63, 64, 65, S = 320 (5 tiles) and S + 200 (the kernel
    splits min(len, S)), with 1 split, 3, and 7 (more than the tiles): an
    identity split exact, m within 1e-5 of the
    largest |m| and s within 1e-5 relative (f32 sums in another order), o
    within the attention bound times the largest |o| (bf16 1e-2; a
    quantized cache 2e-3 at MHA, 1e-2 where p * v_scale rounds to bf16)."""
    L, S, hkv = 2, 320, 2
    lens = torch.tensor([0, 1, 63, 64, 65, S, S + 200], dtype=torch.int32,
                        device=dev)
    B = len(lens)
    q = _randn(61, B, g * hkv, d).to(dev, torch.bfloat16)
    kf = _randn(62, L, B, hkv, S, d).to(dev)
    vf = _randn(63, L, B, hkv, S, d).to(dev)
    if fmt == "bf16":
        k, v, kw = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
        tol = 1e-2
    else:
        k, ks = llama._quantize_rowwise(kf, fmt)
        v, vs = llama._quantize_rowwise(vf, fmt)
        kw = dict(k_scale=ks, v_scale=vs)
        tol = 2e-3 if g == 1 else 1e-2
    for n in (1, 3, 7):
        key = "flash_decode" if fmt == "bf16" else "flash_decode_q"
        before = fd.LAUNCHES[key]
        got = fd.flash_decode_partials(q, k, v, lens, scale=d ** -0.5,
                                       n_splits=n, layer=1, **kw)
        with plain_versions():
            ref = fd.flash_decode_partials(q, k, v, lens, scale=d ** -0.5,
                                           n_splits=n, layer=1, **kw)
        torch.cuda.synchronize()
        assert fd.LAUNCHES[key] == before + 1
        empty = ref.m == -torch.inf
        assert torch.equal(got.m == -torch.inf, empty)
        assert not got.s[empty].any()
        assert not got.o[empty.expand_as(got.o)].any()
        live = ~empty
        m_err = (got.m[live] - ref.m[live]).abs().max()
        assert m_err <= 1e-5 * ref.m[live].abs().max(), float(m_err)
        s_err = ((got.s[live] - ref.s[live]).abs() / ref.s[live]).max()
        assert s_err <= 1e-5, float(s_err)
        o_err = (got.o - ref.o).abs().max()
        assert o_err <= tol * ref.o.abs().max(), float(o_err)



def test_flash_decode_partials_refuse_an_unaligned_kv_base(dev):
    """K / V rows are copied 16 bytes at a time: the wrapper refuses a
    contiguous view whose base is off 16 bytes, and so does the C entry
    (cudaErrorInvalidValue) if handed one, before anything launches."""
    from ggml_cuda_experiments_tpu_torch.ops import _build
    b, hkv, s_, d = 1, 2, 64, 64
    q = torch.zeros((b, 4, d), dtype=torch.bfloat16, device=dev)
    n = b * hkv * s_ * d
    good = torch.zeros((b, hkv, s_, d), dtype=torch.bfloat16, device=dev)
    bad = torch.zeros(n + 1, dtype=torch.bfloat16,
                      device=dev)[1:].view(b, hkv, s_, d)
    lens = torch.tensor([s_], dtype=torch.int32, device=dev)
    before = fd.LAUNCHES["flash_decode"]
    with pytest.raises(ValueError, match="16-byte aligned"):
        fd.flash_decode_partials(q, bad, good, lens, scale=0.125, n_splits=2)
    o = torch.empty((b, hkv, 2, 2, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, hkv, 2, 2, 1), dtype=torch.float32, device=dev)
    rc = _build.lib().flash_decode_partials(
        q.data_ptr(), good.data_ptr(), bad.data_ptr(), lens.data_ptr(),
        o.data_ptr(), m.data_ptr(), m.data_ptr(), b, 4, hkv, s_, d, 0, 2,
        0.125, _build.stream_of(q))
    torch.cuda.synchronize()
    assert rc == 1                                    # cudaErrorInvalidValue
    assert fd.LAUNCHES["flash_decode"] == before

@pytest.mark.parametrize("hq,hkv,d", [(4, 2, 64), (2, 2, 128)])
@pytest.mark.parametrize("sq,sk", [(8, 8), (100, 100), (128, 128),
                                   (40, 200)])
def test_flash_attention(dev, hq, hkv, d, sq, sk):
    q = _randn(7, 2, hq, sq, d).to(dev, torch.bfloat16)
    k = _randn(8, 2, hkv, sk, d).to(dev, torch.bfloat16)
    v = _randn(9, 2, hkv, sk, d).to(dev, torch.bfloat16)
    _check(fa.flash_attention, q, k, v, causal=True, tol=1e-2)


@pytest.mark.parametrize("sq,sk,length,causal", [
    (128, 128, 37, True), (100, 100, 100, True), (64, 256, 200, False),
    (64, 192, 1, False)])
def test_flash_attention_masked(dev, sq, sk, length, causal):
    """The engine's masks: a length mask with the causal cut, and a chunk
    mask (key j visible iff j <= pos0 + i and j < length) without it; a
    [1, 1, 1, Sk] mask is read through stride-0 broadcast dims."""
    q = _randn(10, 2, 4, sq, 64).to(dev, torch.bfloat16)
    k = _randn(11, 2, 2, sk, 64).to(dev, torch.bfloat16)
    v = _randn(12, 2, 2, sk, 64).to(dev, torch.bfloat16)
    kv = torch.arange(sk, device=dev)
    if causal:
        mask = torch.where(kv < length, 0.0, -torch.inf)[None, None, None]
    else:
        qpos = (sk - sq) + torch.arange(sq, device=dev)[:, None]
        mask = torch.where((kv <= qpos) & (kv < length), 0.0,
                           -torch.inf)[None, None]
    _check(fa.flash_attention, q, k, v, mask, causal=causal, tol=1e-2)


def test_flash_attention_unmasked_rows_stay_zero(dev):
    q = _randn(13, 1, 2, 64, 128).to(dev, torch.bfloat16)
    kv = _randn(14, 1, 2, 64, 128).to(dev, torch.bfloat16)
    mask = torch.zeros((1, 2, 64, 64), device=dev)
    mask[:, 1, 5] = -torch.inf
    out = fa.flash_attention(q, kv, kv, mask)
    assert torch.isfinite(out).all() and not out[:, 1, 5].any()


@pytest.mark.parametrize("case", ["causal", "ring_block", "dead_block",
                                  "gqa_ragged"])
def test_flash_attention_lse(dev, case):
    """The lse output (#14's residual) against the plain version: o within
    1e-2 * max, lse within 1e-4 * max|lse| where finite, -inf (and o = 0)
    exactly where every key is masked: ring attention's causal block mask,
    a block wholly in the future, a ragged GQA shape; counted as
    flash_attention_lse."""
    hq, hkv, sq, sk, d = (4, 2, 100, 200, 64) if case == "gqa_ragged" else (
        4, 4, 128, 128, 128)
    q = _randn(16, 2, hq, sq, d).to(dev, torch.bfloat16)
    k = _randn(17, 2, hkv, sk, d).to(dev, torch.bfloat16)
    v = _randn(18, 2, hkv, sk, d).to(dev, torch.bfloat16)
    pos = torch.arange(sq, device=dev)
    mask = {"ring_block": torch.where(pos[None, :] <= pos[:, None], 0.0,
                                      -torch.inf)[None, None],
            "dead_block": torch.full((1, 1, sq, sk), -torch.inf,
                                     device=dev)}.get(case)
    causal = case in ("causal", "gqa_ragged")
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                return_residuals=True)
    assert fa.LAUNCHES["flash_attention_lse"] == before[
        "flash_attention_lse"] + 1
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"]
    with plain_versions():
        ro, rlse = fa.flash_attention(q, k, v, mask, causal=causal,
                                      return_residuals=True)
    torch.cuda.synchronize()
    assert lse.shape == (2, hq, sq) and lse.dtype == torch.float32
    dead = torch.isneginf(rlse)
    assert torch.equal(torch.isneginf(lse), dead)
    assert dead.all() == (case == "dead_block")
    assert torch.isfinite(o).all() and not o[dead].any()
    if not dead.all():
        assert (o.float() - ro.float()).abs().max() <= 1e-2 * ro.float(
        ).abs().max()
        live = ~dead
        assert (lse[live] - rlse[live]).abs().max() <= 1e-4 * rlse[
            live].abs().max()
    # the same kernel without the residual gives the same o
    assert torch.equal(fa.flash_attention(q, k, v, mask, causal=causal), o)


def test_flash_attention_verify_window(dev):
    """The speculative verify window (models/speculative.py): Sq = 5
    against the whole 1024-slot cache, the additive mask kv_pos <= q_pos,
    the windows at positions 600-604 and 1019-1023; every key tile runs."""
    T, S = 5, 1024
    q = _randn(50, 2, 32, T, 128).to(dev, torch.bfloat16)
    k = _randn(51, 2, 32, S, 128).to(dev, torch.bfloat16)
    v = _randn(52, 2, 32, S, 128).to(dev, torch.bfloat16)
    positions = torch.tensor([600, 1019], device=dev)[:, None] + torch.arange(
        T, device=dev)
    kv_pos = torch.arange(S, device=dev)[None, None, None, :]
    mask = torch.where(kv_pos <= positions[:, None, :, None], 0.0,
                       -torch.inf)
    _check(fa.flash_attention, q, k, v, mask, tol=1e-2)


# Sq = 200: not a multiple of the 64-row query tile nor the 64-key tile;
# Hq 32 / Hkv 8 at D 128 (llama3-8b's GQA); Sk - Sq = 130 and 930: causal
# offsets that are not multiples of the tile
@pytest.mark.parametrize("hq,hkv,d,sq,sk", [
    (4, 4, 128, 200, 200), (32, 8, 128, 128, 128), (4, 2, 64, 100, 230),
    (2, 2, 128, 70, 1000)])
def test_flash_attention_tile_edges(dev, hq, hkv, d, sq, sk):
    q = _randn(53, 2, hq, sq, d).to(dev, torch.bfloat16)
    k = _randn(54, 2, hkv, sk, d).to(dev, torch.bfloat16)
    v = _randn(55, 2, hkv, sk, d).to(dev, torch.bfloat16)
    _check(fa.flash_attention, q, k, v, causal=True, tol=1e-2)


def test_flash_attention_lse_of_a_dead_row_in_a_live_tile(dev):
    """Rows whose every key is masked, inside query and key tiles that
    other rows use: O = 0 and lse = -inf exactly there, the other rows as
    the plain version."""
    q = _randn(56, 1, 2, 100, 128).to(dev, torch.bfloat16)
    k = _randn(57, 1, 2, 130, 128).to(dev, torch.bfloat16)
    v = _randn(58, 1, 2, 130, 128).to(dev, torch.bfloat16)
    mask = torch.zeros((1, 2, 100, 130), device=dev)
    mask[:, 1, 5] = -torch.inf
    mask[:, 0, 70] = -torch.inf
    mask[:, 0, 71, 1:] = -torch.inf                    # one visible key
    o, lse = fa.flash_attention(q, k, v, mask, causal=True,
                                return_residuals=True)
    with plain_versions():
        ro, rlse = fa.flash_attention(q, k, v, mask, causal=True,
                                      return_residuals=True)
    torch.cuda.synchronize()
    dead = torch.isneginf(rlse)
    assert int(dead.sum()) == 2 and torch.equal(torch.isneginf(lse), dead)
    assert not o[dead].any() and torch.isfinite(o).all()
    assert (o.float() - ro.float()).abs().max() <= 1e-2 * ro.float().abs(
    ).max()
    assert (lse[~dead] - rlse[~dead]).abs().max() <= 1e-4 * rlse[
        ~dead].abs().max()


@pytest.mark.parametrize("t,nh,nkv", [(128, 4, 2), (256, 32, 32),
                                      (1, 32, 32), (130, 32, 32),
                                      (130, 32, 8), (512, 32, 8)])
def test_rope_pack_is_exact(dev, t, nh, nkv):
    """Bit-equal to the plain version with its tables made by the call and
    given (``rope_tables``, as a prefill hands them to every layer): one
    token, a ragged tail of 2 past the kernel's 32-token CTAs, and GQA,
    whose last CTA of heads is short."""
    y = _randn(15, t, (nh + 2 * nkv) * 128).to(dev, torch.bfloat16)
    pos = torch.arange(40, 40 + t, dtype=torch.int32, device=dev)
    kw = dict(n_heads=nh, n_kv_heads=nkv, head_dim=128)
    tables = pf.rope_tables(pos, 128, 10000.0)
    before = pf.LAUNCHES["rope_pack"]
    built = pf.rope_pack_prefill(y, pos, **kw)
    given = pf.rope_pack_prefill(y, pos, **kw, tables=tables)
    with plain_versions():
        ref = pf.rope_pack_prefill(y, pos, **kw)
    assert pf.LAUNCHES["rope_pack"] == before + 2
    for b, g, r in zip(built, given, ref):
        assert torch.equal(b, r) and torch.equal(g, r)


@pytest.mark.parametrize("fmt", [False, "int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d,ps", [(8, 2, 64, 32), (4, 4, 128, 64),
                                          (32, 2, 128, 16)])
def test_paged_decode(dev, fmt, hq, hkv, d, ps):
    L, B, pps = 2, 3, 8
    n_pages = B * pps + 2
    kp = _randn(16, L, n_pages, hkv, ps, d).to(dev)
    vp = _randn(17, L, n_pages, hkv, ps, d).to(dev)
    kw = {}
    if fmt:
        kp, ks = llama._quantize_rowwise(kp, fmt)
        vp, vs = llama._quantize_rowwise(vp, fmt)
        kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    else:
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    q = _randn(18, B, hq, d).to(dev, torch.bfloat16)
    pidx = torch.from_numpy(np.random.default_rng(19).permutation(
        n_pages)[:B * pps].reshape(B, pps).astype(np.int32)).to(dev)
    lens = torch.tensor([1, ps + 1, pps * ps], dtype=torch.int32, device=dev)
    before = pa.LAUNCHES["paged_decode"]
    _check(pa.paged_decode, q, kp, vp, lens, pidx, layer=1,
           tol=2e-2 if fmt else 2e-3, **kw)
    assert pa.LAUNCHES["paged_decode"] == before + 1


def _pages(seed, fmt, L, n_pages, hkv, ps, d, dev):
    """k / v pools [L, n_pages, Hkv, ps, D] of a page type, and the scale
    pools' keyword arguments (int8 / fp8)."""
    kp = _randn(seed, L, n_pages, hkv, ps, d).to(dev)
    vp = _randn(seed + 1, L, n_pages, hkv, ps, d).to(dev)
    if fmt == "bf16":
        return kp.to(torch.bfloat16), vp.to(torch.bfloat16), {}
    kp, ks = llama._quantize_rowwise(kp, fmt)
    vp, vs = llama._quantize_rowwise(vp, fmt)
    return kp, vp, dict(k_scale_pages=ks, v_scale_pages=vs)


def _check_paged(q, kp, vp, lens, pidx, *, layer, tol, **kw):
    """One paged_decode launch against the plain version on the kernel's
    own partition (``pick_splits``); returns that split count."""
    B, hkv = q.shape[0], kp.shape[-3]
    n = fd.pick_splits(B, hkv, pidx.shape[1] * kp.shape[-2],
                       fd._sm_count(0))
    before = pa.LAUNCHES["paged_decode"]
    got = pa.paged_decode(q, kp, vp, lens, pidx, layer=layer, **kw)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == before + 1
    ref = pa.paged_decode_ref(q, kp, vp, lens, pidx, layer=layer,
                              kv_splits=n, **kw)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = (got.float() - ref.float()).abs().max()
    assert err <= tol * ref.float().abs().max(), (n, float(err))
    return n


def _table(seed, B, pps, n_pages, dev):
    """A random page table [B, pps] over n_pages, some entries past the
    pool (the kernel clamps them to its last page)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, n_pages + 3, size=(B, pps)).astype(np.int32)).to(dev)


@pytest.mark.parametrize("fmt", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("hq,hkv,d,ps", [(32, 4, 128, 16), (32, 8, 128, 32),
                                          (32, 32, 128, 64), (32, 8, 64, 64),
                                          (8, 8, 64, 48)])
@pytest.mark.parametrize("b", [1, 2, 5, 40])
def test_paged_decode_splits(dev, fmt, hq, hkv, d, ps, b):
    """Each sequence's ~1,050 keys split over the CTAs ``pick_splits`` gives
    B x Hkv (1 to 17 splits over these batches: 17, 9, 6, 1 at Hkv 4; 4,
    2, 1, 1 at Hkv 32) and merged inside the one launch, against the plain
    version on the same partition; lengths mix 1 (every split but the
    first empty) with the whole span pages_per_seq * page_size, over a
    layered pool."""
    L, pps = 3, 1024 // ps + 1
    n_pages = min(b * pps, 40) + 2
    kp, vp, kw = _pages(60, fmt, L, n_pages, hkv, ps, d, dev)
    q = _randn(62, b, hq, d).to(dev, torch.bfloat16)
    pidx = _table(63, b, pps, n_pages, dev)
    lens = torch.tensor([(1, pps * ps, 65, pps * ps - 1, 300, 64)[i % 6]
                         for i in range(b)], dtype=torch.int32, device=dev)
    n = _check_paged(q, kp, vp, lens, pidx, layer=2,
                     pages_per_compute_block=1,
                     tol=2e-3 if fmt == "bf16" else 2e-2, **kw)
    assert (n > 1) == (b * hkv < fd._sm_count(0))


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("ps", [1, 2, 16])
@pytest.mark.parametrize("b", [1, 66])
def test_paged_decode_page_table_past_a_whole_row(dev, fmt, ps, b):
    """More than 1,024 pages a sequence: the kernel reads each split's own
    entries of the page table (not the whole row); one split at B x Hkv =
    132, many at B = 1 (18, 35 and 55 at pages of 1, 2 and 16), lengths 1 and
    pages_per_seq * page_size."""
    L, hq, hkv, d, pps = 2, 4, 2, 64, 1100
    n_pages = 60
    kp, vp, kw = _pages(70, fmt, L, n_pages, hkv, ps, d, dev)
    q = _randn(72, b, hq, d).to(dev, torch.bfloat16)
    pidx = _table(73, b, pps, n_pages, dev)
    lens = torch.tensor([(pps * ps, 1, 777, pps * ps - 1)[i % 4]
                         for i in range(b)], dtype=torch.int32, device=dev)
    n = _check_paged(q, kp, vp, lens, pidx, layer=1,
                     tol=2e-3 if fmt == "bf16" else 2e-2, **kw)
    assert (n > 1) == (b == 1)


def _graph_case(dev, B, hkv, seed, pps=32):
    """A paged_decode call over int8 pages (GQA 2), its lengths tensor (to
    change in place) and its split count."""
    L, hq, d, ps = 2, 2 * hkv, 128, 16
    n_pages = B * pps + 1
    kp, vp, kw = _pages(seed, "int8", L, n_pages, hkv, ps, d, dev)
    q = _randn(seed + 2, B, hq, d).to(dev, torch.bfloat16)
    pidx = torch.arange(B * pps, dtype=torch.int32,
                        device=dev).reshape(B, pps)
    lens = torch.full((B,), pps * ps, dtype=torch.int32, device=dev)

    def call():
        return pa.paged_decode(q, kp, vp, lens, pidx, layer=1, **kw)
    return call, lens, fd.pick_splits(B, hkv, pps * ps, fd._sm_count(0))


def test_paged_decode_graph_replays_with_new_lengths(dev):
    """One split-merging paged_decode captured in a CUDA graph, replayed
    with the lengths changed in place: each replay bit-equal to an eager
    call at those lengths (the tickets are back to 0 after every launch)."""
    call, lens, n = _graph_case(dev, 4, 8, 64)
    assert n > 1
    sets = ([1, 512, 300, 17], [512, 2, 64, 65], [3, 100, 511, 512])
    eager = []
    for s in sets:
        lens.copy_(torch.tensor(s, dtype=torch.int32))
        eager.append(call())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for i in (0, 1, 2, 1, 0):
        lens.copy_(torch.tensor(sets[i], dtype=torch.int32))
        out.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[i]), i


def test_paged_decode_graph_replays_after_a_larger_batch(dev):
    """A graph captured at B = 4 still replays right after eager calls at
    B x Hkv past 1,024 and at a split-merging B x Hkv of 64: the tickets
    are one buffer made once at the kernel's limit, never replaced."""
    call, lens, n = _graph_case(dev, 4, 8, 74)
    assert n > 1
    lens.copy_(torch.tensor([1, 512, 300, 17], dtype=torch.int32))
    want = call()
    tickets = pa._TICKETS[0]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    big, _, _ = _graph_case(dev, 130, 8, 76, pps=2)
    mid, _, n_mid = _graph_case(dev, 8, 8, 78)
    assert n_mid > 1
    for _ in range(2):
        big(), mid()
        out.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    assert pa._TICKETS[0] is tickets
    assert tickets.numel() == pa.MAX_HEAD_ROWS and not tickets.any()


@pytest.mark.parametrize("name,fmt", [("q4k_matvec", "q4_k"),
                                      ("q40_matvec", "q4_0")])
@pytest.mark.parametrize("n,k", [(37, 2048), (2048, 2048), (2560, 2048),
                                 (2048, 5632), (300, 11008), (4096, 11008),
                                 (37, 12288), (4096, 12288), (4096, 4096),
                                 (32000, 4096)])
def test_q4_matvec_is_bitwise_repeatable(dev, name, fmt, n, k):
    """Both exact-f32 matvecs at the split and unsplit shapes
    (``matvec_splits``): within 1e-4 * max of the plain version, and two
    calls bit-equal (the splits fold in a fixed order, no atomics)."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    ql = qm.quantize(torch.randn((n, k), generator=g, device=dev)
                     * k ** -0.5, fmt)
    x = torch.randn((1, k), generator=g, device=dev)
    fn = getattr(qm, name)
    before = qm.LAUNCHES[name]
    a, b = fn(x, ql), fn(x, ql)
    assert qm.LAUNCHES[name] == before + 2
    assert torch.equal(a, b)
    _check(fn, x, ql, tol=1e-4)


@pytest.mark.parametrize("n,k", [(640, 4096), (300, 12288), (4096, 4096)])
def test_q4k_q8_matvec(dev, n, k):
    ql = qm.quantize(_randn(20, n, k, scale=k ** -0.5).to(dev))
    before = qm.LAUNCHES["q4k_q8_matvec"]
    _check(qm.q4k_q8_matvec, _randn(21, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q4k_q8_matvec"] == before + 1


@pytest.mark.parametrize("kd", [4096, 8192, 16384])
def test_fused_mlp(dev, kd):
    w_gu = qm.quantize(_randn(22, 2 * kd, 4096, scale=1 / 64).to(dev))
    w_down = qm.quantize(_randn(23, 256, kd, scale=1 / 64).to(dev))
    before = qm.LAUNCHES["fused_mlp"]
    _check(qm.mlp_fused, _randn(24, 1, 4096).to(dev), w_gu, w_down, tol=5e-3)
    assert qm.LAUNCHES["fused_mlp"] == before + 1


def _attn_weights(seed, hq, hkv, dev):
    wqkv = qm.quantize(_randn(seed, (hq + 2 * hkv) * 128, 4096,
                              scale=1 / 64).to(dev))
    wo = qm.quantize(_randn(seed + 1, 4096, 4096, scale=1 / 64).to(dev))
    return wqkv, wo


def _close(got, ref, tol, floor=0.0):
    got, ref = got.float(), ref.float()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    err = float((got - ref).abs().max())
    assert err <= tol * max(floor, float(ref.abs().max())), err


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hkv", [32, 8, 4])
@pytest.mark.parametrize("length", [1, 23, 255, 256])
def test_fused_attention(dev, hkv, length, cache_dtype):
    wqkv, wo = _attn_weights(25, 32, hkv, dev)
    kc = _randn(27, 2, 1, hkv, 256, 128).to(dev, cache_dtype)
    vc = _randn(28, 2, 1, hkv, 256, 128).to(dev, cache_dtype)
    x = _randn(29, 1, 4096).to(dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=128)
    before = fat.LAUNCHES["fused_attention"]
    got = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 1, **kw)
    with plain_versions():
        ref = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 1, **kw)
    torch.cuda.synchronize()
    assert fat.LAUNCHES["fused_attention"] == before + 1
    _close(got[0], ref[0], 5e-3)
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == cache_dtype
        _close(g, r, 2e-2, floor=1.0)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hkv", [32, 8, 4])
@pytest.mark.parametrize("length", [0, 63, 64, 1022, 1023])
def test_fused_attention_split_edges(dev, hkv, length, cache_dtype):
    """At S = 1024: the new token alone (0), the edges of the kernel's
    tiles and splits (63, 64: one and two bf16 tiles), and the cache's last
    slots (1022; 1023: the new token at the clamp lengths[0] + 1 == S)."""
    wqkv, wo = _attn_weights(26, 32, hkv, dev)
    kc = _randn(27, 2, 1, hkv, 1024, 128).to(dev, cache_dtype)
    vc = _randn(28, 2, 1, hkv, 1024, 128).to(dev, cache_dtype)
    x = _randn(29, 1, 4096).to(dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=128)
    got = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 0, **kw)
    with plain_versions():
        ref = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 0, **kw)
    torch.cuda.synchronize()
    _close(got[0], ref[0], 5e-3)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, 2e-2, floor=1.0)


def test_fused_attention_graph_replays_with_new_lengths(dev):
    """attention_fused captured in a CUDA graph after one eager call (which
    makes its ticket buffer), replayed with lengths changed in place (one
    split, two, and many): each replay bit-equal to an eager call at that
    length, the tickets back to 0 after each. Made first inside a capture,
    the buffer raises."""
    wqkv, wo = _attn_weights(35, 32, 8, dev)
    kc = _randn(36, 1, 1, 8, 1024, 128).to(dev, torch.bfloat16)
    vc = _randn(37, 1, 1, 8, 1024, 128).to(dev, torch.bfloat16)
    x = _randn(38, 1, 4096).to(dev)
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    kw = dict(n_heads=32, n_kv_heads=8, head_dim=128)

    def call():
        return fat.attention_fused(x, wqkv, wo, kc, vc, lens, 0, **kw)

    saved = fat._TICKETS.pop(dev.index, None)
    try:
        with pytest.raises(RuntimeError, match="outside a CUDA graph"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                call()
    finally:
        if saved is not None:
            fat._TICKETS[dev.index] = saved
    sets = (5, 700, 31, 1023, 64)
    eager = []
    for n in sets:
        lens.fill_(n)
        eager.append(call())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    tickets = fat._TICKETS[dev.index]
    for i in (1, 0, 3, 2, 4, 1):
        lens.fill_(sets[i])
        for t in out:
            t.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        for g, w in zip(out, eager[i]):
            assert torch.equal(g, w), sets[i]
        assert not tickets.any()


def _layers(seed, n, hkv, dev, kd=4096):
    layers = []
    for i in range(n):
        wqkv, wo = _attn_weights(seed + 10 * i, 32, hkv, dev)
        layers.append({
            "wqkv": wqkv, "wo": wo,
            "w_gu": qm.quantize(_randn(seed + 10 * i + 2, 2 * kd, 4096,
                                       scale=1 / 64).to(dev)),
            "w_down": qm.quantize(_randn(seed + 10 * i + 3, 4096, kd,
                                         scale=1 / 64).to(dev)),
            "attn_norm": (1 + 0.1 * _randn(seed + 10 * i + 4, 4096)).to(
                dev, torch.bfloat16),
            "mlp_norm": (1 + 0.1 * _randn(seed + 10 * i + 5, 4096)).to(
                dev, torch.bfloat16)})
    return layers


# cache lengths before the token: empty, one key, the edges of the
# kernel's 32-key bf16 (16-key f32) tiles, a ragged one, 513, the last slot
# and past the cache (a token past it attends over the cache alone)
LAYER_S = 640
LAYER_LENGTHS = (0, 1, 15, 16, 31, 32, 63, 64, 65, 100, 513, LAYER_S - 1,
                 LAYER_S + 5)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hkv", [32, 8, 4])
def test_layer_step_and_model_step(dev, hkv, cache_dtype):
    """Each layer's launch (nL = 1) against its plain version, every
    layer's input forced to the plain version's (as chip_smoke.py's forced
    check: the kernel and its plain version sum in other orders, and int8
    activations turn the ulps that earlier layers leave into whole steps);
    and model_step (nL = 3) against the layer launches chained on their own
    outputs with h carried in f32, bit for bit, at every length of
    LAYER_LENGTHS. The kernel's ring of 9 slots of 20 KB (units of 8 rows)
    wraps several times a layer, so it wraps within each layer and from
    layer to layer."""
    _layer_chain(dev, _layers(30, 3, hkv, dev), hkv, cache_dtype,
                 LAYER_LENGTHS)


def test_layer_step_and_model_step_at_llama3_width(dev):
    """The same checks at llama3-8b's layer: GQA 32/8, the intermediate
    padded to Kd 16384 (the kernel's largest shared memory, 227,728 bytes
    a CTA) and rope_theta 5e5, at lengths around the tiles and the
    splits."""
    _layer_chain(dev, _layers(60, 2, 8, dev, kd=16384), 8, torch.bfloat16,
                 (0, 63, 64, 300, 513, LAYER_S - 1), rope_theta=5e5)


def _layer_chain(dev, layers, hkv, cache_dtype, lengths, **rope):
    n = len(layers)
    kc = _randn(31, n, 1, hkv, LAYER_S, 128).to(dev, cache_dtype)
    vc = _randn(32, n, 1, hkv, LAYER_S, 128).to(dev, cache_dtype)
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=128, **rope)
    h = _randn(33, 1, 4096).to(dev)
    packs = [lk.pack_layers([layer]) for layer in layers]
    m_pack = lk.pack_layers(layers)
    for length in lengths:
        lens = torch.tensor([length], dtype=torch.int32, device=dev)
        hp, hk, kns, vns = h, h, [], []
        for li, pack in enumerate(packs):
            got = lk.layer_step(hp, pack, kc, vc, lens, li, **kw)
            with plain_versions():
                ref = lk.layer_step(hp, pack, kc, vc, lens, li, **kw)
            _close(got[0], ref[0], 5e-3)
            for g_, r_ in zip(got[1:], ref[1:]):
                assert g_.dtype == cache_dtype
                _close(g_, r_, 2e-2, floor=1.0)
            hp = ref[0]
            hk, kn, vn = lk.layer_step(hk, pack, kc, vc, lens, li, **kw)
            kns.append(kn)
            vns.append(vn)
        before = lk.LAUNCHES["model_step"]
        hm, kn, vn = lk.model_step(h, m_pack, kc, vc, lens, **kw)
        torch.cuda.synchronize()
        assert lk.LAUNCHES["model_step"] == before + 1
        assert torch.equal(hm, hk), length
        assert torch.equal(kn, torch.stack(kns)), length
        assert torch.equal(vn, torch.stack(vns)), length


def test_model_step_graph_replays_are_bitwise(dev):
    """model_step (3 layers, GQA 32/8, intermediate 8192: a w_down row in
    two 4096-wide segments) captured in a CUDA graph and replayed 20 times
    gives the same bits every time, equal to an eager call, and
    phase="all" is the default call."""
    layers = _layers(40, 3, 8, dev, kd=8192)
    m_pack = lk.pack_layers(layers)
    kc = _randn(41, 3, 1, 8, LAYER_S, 128).to(dev, torch.bfloat16)
    vc = _randn(42, 3, 1, 8, LAYER_S, 128).to(dev, torch.bfloat16)
    lens = torch.tensor([300], dtype=torch.int32, device=dev)
    h = _randn(43, 1, 4096).to(dev)
    kw = dict(n_heads=32, n_kv_heads=8, head_dim=128)
    want = lk.model_step(h, m_pack, kc, vc, lens, **kw)
    same = lk.model_step(h, m_pack, kc, vc, lens, **kw, phase="all")
    for w_, s_ in zip(want, same):
        assert torch.equal(w_, s_)
    out = {}
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out["y"] = lk.model_step(h, m_pack, kc, vc, lens, **kw)
    for _ in range(20):
        graph.replay()
        torch.cuda.synchronize()
        for w_, g_ in zip(want, out["y"]):
            assert torch.equal(w_, g_)


def test_engine_on_the_card_matches_the_cpu(dev):
    """A debug-size int8 engine run on the card, against the CPU's."""
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=2)
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, device="cpu"), "q4_k")
    outs = []
    for p in (params, _to(params, dev)):
        eng = engine.Engine(p, cfg, max_batch=4, page_size=32, n_pages=32,
                            max_seq_len=128, quantized_kv="int8",
                            decode_window=4)
        for n in (5, 40, 17):
            eng.add_request(list(range(1, n + 1)), max_new_tokens=9)
        outs.append(eng.run_to_completion())
    # free-running, so compare the first tokens (from the prefill); later
    # ones may part at a bf16 rounding tie
    assert all(len(t) == 9 and t[0] == outs[0][r][0]
               for r, t in outs[1].items()), outs


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    ql = qm.quantize(_randn(0, 64, 256).to(dev))
    with pytest.raises(ValueError):
        qm.q4k_matvec(torch.zeros((1, 256), dtype=torch.float16,
                                  device=dev), ql)
    with pytest.raises(ValueError):
        qm.q4k_gemm(torch.zeros((4, 256), device=dev), ql)   # f32, not bf16
    q = torch.zeros((1, 4, 96), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 2, 64, 96), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError):
        fd.flash_decode(q, kv, kv)                             # D = 96
    with pytest.raises(ValueError):
        fa.flash_attention(q[:, :, None], kv, kv)              # D = 96
    with pytest.raises(ValueError):                           # K % 4096
        qm.q4k_q8_matvec(torch.zeros((1, 256), device=dev), ql)
    q6 = qm.quantize(_randn(0, 64, 1024).to(dev), "q6_k")
    with pytest.raises(ValueError):                   # (K/16) % 128, K % 4096
        qm.q6k_matvec(torch.zeros((1, 1024), device=dev), q6)
    with pytest.raises(ValueError):
        qm.q6k_q8_matvec(torch.zeros((1, 1024), device=dev), q6)
    with pytest.raises(ValueError):                   # a q4_k weight
        qm.q6k_matvec(torch.zeros((1, 256), device=dev), ql)
    q40 = qm.quantize(_randn(0, 64, 1024).to(dev), "q4_0")
    with pytest.raises(ValueError):                   # K % 4096
        qm.q40_q8_matvec(torch.zeros((1, 1024), device=dev), q40)
    with pytest.raises(ValueError):                   # a q4_0 weight
        qm.q80_matvec(torch.zeros((1, 1024), device=dev), q40)
    with pytest.raises(ValueError):                   # f32, not bf16
        qm.q40_gemm(torch.zeros((4, 1024), device=dev), q40)
    kq = torch.zeros((1, 2, 64, 64), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 2, 64), device=dev)
    q64 = torch.zeros((1, 4, 64), dtype=torch.bfloat16, device=dev)
    fd.flash_decode(q64, kq, kq, k_scale=sc, v_scale=sc)       # taken
    with pytest.raises(ValueError):                   # bf16 scales
        fd.flash_decode(q64, kq, kq, k_scale=sc.bfloat16(),
                        v_scale=sc.bfloat16())
    pos = torch.arange(4, device=dev)
    with pytest.raises(ValueError):                   # D % 16
        pf.rope_pack_prefill(torch.zeros((4, 3 * 72), dtype=torch.bfloat16,
                                         device=dev), pos, n_heads=1,
                             n_kv_heads=1, head_dim=72)
    with pytest.raises(ValueError):                   # tables of 2 tokens
        pf.rope_pack_prefill(torch.zeros((4, 3 * 128), dtype=torch.bfloat16,
                                         device=dev), pos, n_heads=1,
                             n_kv_heads=1, head_dim=128,
                             tables=pf.rope_tables(pos[:2], 128, 1e4))


def test_debug_model_on_the_card_matches_the_cpu(dev):
    _model_on_the_card_matches_the_cpu(dev, False)


def test_int8_cache_model_on_the_card_matches_the_cpu(dev):
    _model_on_the_card_matches_the_cpu(dev, "int8")


def _model_on_the_card_matches_the_cpu(dev, quantized):
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=2)
    params = llama.quantize_params(
        llama.init_weights(cfg, seed=0, device="cpu"), "q4_k")
    moved = _to(params, dev)
    prompt = torch.arange(1, 9)[None]
    outs = []
    for p, device in ((params, "cpu"), (moved, dev)):
        cache = llama.KVCache.create(cfg, 1, 256, quantized=quantized,
                                     device=device)
        logits, cache = llama.prefill(p, cfg, prompt.to(device), cache)
        seq = [logits.cpu()]
        for t in (3, 5, 7):
            logits, cache = llama.decode_step(
                p, cfg, torch.tensor([t], device=device), cache)
            seq.append(logits.cpu())
        outs.append(torch.cat(seq))
    err = (outs[1] - outs[0]).abs().max()
    assert err <= 2e-2 * outs[0].abs().max()


def _to(params, dev):
    def mv(w):
        if isinstance(w, qm.QuantLinear):
            return dataclasses.replace(w, **{
                f: getattr(w, f).to(dev)
                for f in ("qs", "es", "em", "qh", "d")
                if getattr(w, f) is not None})
        return w.to(dev)
    out = {k: mv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: mv(v) for k, v in layer.items()}
                     for layer in params["layers"]]
    return out


# ---- the kernel lab's kernels: matmul (csrc/matmul.cu) and the staging /
# reduction primitives (csrc/primitives.cu). Tolerances: int8 matmul,
# stage_pad, the int32 grid_sum and lane_reduce's max exact; bf16 / f16
# matmul 2e-2 * max (the output rounded to bf16 / f16 from an f32 sum taken
# in another order), f32 matmul 1e-4 * max, the f32 grid_sum and the f32
# lane_reduce sum 1e-6 * max, the bf16 lane_reduce sum one bf16 ulp.

from ggml_cuda_experiments_tpu_torch.ops import matmul as mm  # noqa: E402
from ggml_cuda_experiments_tpu_torch.ops import primitives as pr  # noqa: E402

_MM_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}


def _mm_operand(seed, shape, dtype, dev):
    if dtype == torch.int8:
        rng = np.random.default_rng(seed)
        return torch.from_numpy(rng.integers(-127, 128, size=shape).astype(
            np.int8)).to(dev)
    return _randn(seed, *shape).to(dev, dtype)


def _mm_check(dev, dtype, m, k, n, ta=False, tb=False, out_dtype=None):
    x = _mm_operand(m + k, (k, m) if ta else (m, k), dtype, dev)
    w = _mm_operand(n + k + 1, (n, k) if tb else (k, n), dtype, dev)
    kw = dict(transpose_a=ta, transpose_b=tb, out_dtype=out_dtype)
    before = mm.LAUNCHES["matmul"]
    got = mm.matmul(x, w, **kw)
    with plain_versions():
        ref = mm.matmul(x, w, **kw)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["matmul"] == before + 1
    assert got.shape == ref.shape == (m, n) and got.dtype == ref.dtype
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        err = (got.float() - ref.float()).abs().max()
        assert err <= _MM_TOL[dtype] * ref.float().abs().max(), float(err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32, torch.int8])
@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (64, 200, 136),
                                   (1, 2048, 512), (1000, 1000, 1000),
                                   (257, 383, 129)])
def test_matmul(dev, dtype, m, k, n):
    _mm_check(dev, dtype, m, k, n)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.int8])
@pytest.mark.parametrize("ta,tb", [(False, True), (True, False),
                                   (True, True)])
@pytest.mark.parametrize("m,k,n", [(64, 128, 192), (70, 300, 45)])
def test_matmul_transposes(dev, dtype, ta, tb, m, k, n):
    _mm_check(dev, dtype, m, k, n, ta, tb)


@pytest.mark.parametrize("dtype,out", [(torch.bfloat16, torch.float32),
                                       (torch.float16, torch.float32),
                                       (torch.int8, torch.float32)])
def test_matmul_out_dtype(dev, dtype, out):
    _mm_check(dev, dtype, 96, 256, 160, out_dtype=out)


def test_matmul_strided_views(dev):
    """Operands that are views: a transposed view is read through its
    strides, a view with no unit stride is made contiguous."""
    x = _randn(3, 64, 512).to(dev, torch.bfloat16)
    w = _randn(4, 256, 96).to(dev, torch.bfloat16)
    for a, b in ((x[:, :256].T.contiguous().T, w), (x[:, ::2], w),
                 (x[:, 256:], w.T.contiguous().T)):
        got = mm.matmul(a, b, out_dtype=torch.float32)
        want = mm.matmul_ref(a, b, out_dtype=torch.float32)
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("dtype,m,k,n,ta,tb,want", [
    (torch.bfloat16, 256, 512, 512, False, False, "wgmma"),
    (torch.float16, 200, 136, 264, True, True, "wgmma"),
    (torch.int8, 256, 512, 512, False, True, "wgmma"),
    (torch.int8, 256, 512, 512, False, False, "mma"),
    (torch.int8, 96, 256, 160, True, True, "mma"),
    (torch.bfloat16, 257, 383, 129, False, False, "mma"),
    (torch.float32, 64, 128, 96, False, False, "ffma")])
def test_matmul_routes(dev, dtype, m, k, n, ta, tb, want):
    """Each route launches one counted kernel and holds its tolerance."""
    x = _mm_operand(1, (k, m) if ta else (m, k), dtype, dev)
    w = _mm_operand(2, (n, k) if tb else (k, n), dtype, dev)
    assert mm.route(x, w, transpose_a=ta, transpose_b=tb) == want
    _mm_check(dev, dtype, m, k, n, ta, tb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
@pytest.mark.parametrize("m,k,n", [(129, 4104, 200), (4097, 136, 72),
                                   (200, 8, 264)])
def test_matmul_wgmma_ragged_edges(dev, dtype, ta, tb, m, k, n):
    """M, N and K ragged against the 128 x 256 tiles and the 64-value K
    slices (K = 8: one partial slice), in every layout, on the wgmma
    route. An M-major x has M as its leading stride, which TMA takes at a
    multiple of 8 elements: M = 129 / 4097 become 136 / 4104 there."""
    m = -(-m // 8) * 8 if ta else m
    x = _mm_operand(3, (k, m) if ta else (m, k), dtype, dev)
    w = _mm_operand(4, (n, k) if tb else (k, n), dtype, dev)
    assert mm.route(x, w, transpose_a=ta, transpose_b=tb) == "wgmma"
    _mm_check(dev, dtype, m, k, n, ta, tb)


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (32768, 4096, 256),
                                   (32768, 2048, 128)])
def test_matmul_int8_transpose_b_bitwise(dev, m, k, n):
    """int8 with both operands K-major (the q6_probe nib rungs' products:
    [N, 256] over K = 4096, and [N, 128] over a 2048 column slice) is
    bitwise the plain version's."""
    _mm_check(dev, torch.int8, m, k, n, tb=True)
    x = _mm_operand(5, (m, 2 * k), torch.int8, dev)[:, k:]
    w = _mm_operand(6, (n, k), torch.int8, dev)
    assert mm.route(x, w, transpose_b=True) == "wgmma"
    got = mm.matmul(x, w, transpose_b=True)
    with plain_versions():
        assert torch.equal(got, mm.matmul(x, w, transpose_b=True))


@pytest.mark.parametrize("ld,want", [(520, "wgmma"), (521, "mma")])
def test_matmul_column_slice(dev, ld, want):
    """A column slice of a wider bf16 matrix: a leading stride of a
    multiple of 8 elements takes the wgmma route, an odd one does not."""
    wide = _mm_operand(7, (300, ld), torch.bfloat16, dev)
    x = wide[:, 8:264]
    w = _mm_operand(8, (256, 136), torch.bfloat16, dev)
    assert mm.route(x, w) == want
    got = mm.matmul(x, w)
    with plain_versions():
        ref = mm.matmul(x, w)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max()
    assert err <= 2e-2 * ref.float().abs().max(), float(err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("r,d,dpad", [(16, 80, 128), (1000, 80, 128),
                                      (300, 77, 96), (5, 128, 128)])
def test_stage_pad_is_exact(dev, dtype, r, d, dpad):
    x = _mm_operand(r + d, (r, d), dtype, dev)
    before = pr.LAUNCHES["stage_pad"]
    got = pr.stage_pad(x, dpad)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["stage_pad"] == before + 1
    assert torch.equal(got, pr.stage_pad_ref(x, dpad))


# n * d odd (a scalar tail: 1001 x 37), one row, and less than one CTA's
# chunk of 4,096 elements (3 x 100) beside the earlier shapes
@pytest.mark.parametrize("n,d", [(64, 128), (1000, 37), (20000, 128),
                                 (3, 5000), (1001, 37), (1, 5), (3, 100)])
def test_grid_sum(dev, n, d):
    rng = np.random.default_rng(n + d)
    xi = torch.from_numpy(rng.integers(-1000, 1000, size=(n, d)).astype(
        np.int32)).to(dev)
    before = pr.LAUNCHES["grid_sum"]
    assert int(pr.grid_sum(xi)) == int(xi.long().sum())
    assert pr.LAUNCHES["grid_sum"] == before + 1
    xf = _randn(n, n, d).to(dev)
    got, again = pr.grid_sum(xf), pr.grid_sum(xf)
    want = xf.double().sum()
    assert got.dtype == torch.float32 and got.shape == ()
    assert torch.equal(got, again)                      # the same bits
    assert abs(float(got) - float(want)) <= 1e-6 * float(xf.abs().sum())


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_grid_sum_off_16_byte_alignment(dev, offset):
    """A contiguous view whose first element is 4, 8 or 12 bytes past a
    16-byte boundary: the kernel's scalar head takes 3, 2 or 1 elements."""
    n, d = 1000, 37
    flat = torch.from_numpy(np.random.default_rng(offset).integers(
        -1000, 1000, size=n * d + 3).astype(np.int32)).to(dev)
    xi = flat[offset:offset + n * d].view(n, d)
    assert xi.is_contiguous() and xi.data_ptr() % 16 == 4 * offset
    assert int(pr.grid_sum(xi)) == int(xi.long().sum())
    xf = _randn(offset, n * d + 3).to(dev)[offset:offset + n * d].view(n, d)
    got, again = pr.grid_sum(xf), pr.grid_sum(xf)
    assert torch.equal(got, again)
    assert (abs(float(got) - float(xf.double().sum()))
            <= 1e-6 * float(xf.abs().sum()))


def test_grid_sum_is_one_launch(dev):
    from torch.profiler import ProfilerActivity, profile
    x = _randn(4, 4096, 129).to(dev)
    pr.grid_sum(x)                            # makes the ticket
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pr.grid_sum(x)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    assert sum(e.count for e in rows) == 1, [(e.key, e.count) for e in rows]
    assert "grid_sum" in rows[0].key


def test_grid_sum_graph_replays_reset_the_ticket(dev):
    """Three calls captured in one CUDA graph, replayed twice: each total
    right each time (the outputs are overwritten with a sentinel before
    each replay), f32 bit-equal to the eager calls and across replays."""
    xs = [_randn(30 + i, 777, 129).to(dev) for i in range(2)]
    xs.insert(1, torch.from_numpy(np.random.default_rng(33).integers(
        -1000, 1000, size=(4097, 3)).astype(np.int32)).to(dev))
    eager = [pr.grid_sum(x) for x in xs]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [pr.grid_sum(x) for x in xs]
    for _ in range(2):
        for o in outs:
            o.fill_(-7)
        graph.replay()
        torch.cuda.synchronize()
        for o, e, x in zip(outs, eager, xs):
            assert torch.equal(o, e)
        assert int(outs[1]) == int(xs[1].long().sum())
        for o, x in ((outs[0], xs[0]), (outs[2], xs[2])):
            assert (abs(float(o) - float(x.double().sum()))
                    <= 1e-6 * float(x.abs().sum()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d", [(8, 128), (1000, 4096), (33, 77)])
def test_lane_reduce(dev, dtype, n, d):
    x = _randn(n * d, n, d).to(dev, dtype)
    before = pr.LAUNCHES["lane_reduce"]
    mx, sm = pr.lane_reduce(x)
    with plain_versions():
        rmx, rsm = pr.lane_reduce(x)
    torch.cuda.synchronize()
    assert pr.LAUNCHES["lane_reduce"] == before + 1
    assert mx.shape == sm.shape == (n, 1) and sm.dtype == dtype
    assert torch.equal(mx, rmx)
    err = (sm.float() - rsm.float()).abs().max()
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    assert err <= tol * rsm.float().abs().max(), float(err)


def test_lab_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):                   # mixed dtypes
        mm.matmul(x, x.T.to(torch.bfloat16))
    with pytest.raises(ValueError):                   # f64
        mm.matmul(x.double(), x.T.double())
    with pytest.raises(ValueError):                   # int8 -> bf16
        mm.matmul(x.to(torch.int8), x.T.to(torch.int8),
                  out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):                   # D > dpad
        pr.stage_pad(torch.zeros((4, 130), device=dev))
    with pytest.raises(ValueError):                   # not contiguous
        pr.stage_pad(torch.zeros((8, 4), device=dev).T)
    with pytest.raises(ValueError):                   # bf16
        pr.grid_sum(x.bfloat16())
    with pytest.raises(ValueError):                   # int32
        pr.lane_reduce(x.int())


# ---- the VPU attention op (csrc/vpu_attention.cu) and speculative decoding
# as CUDA graphs. Tolerances: o 2e-5 absolute in f32 (the JAX test's, unit-
# normal inputs), 1e-2 * max in bf16 (attention); lse 1e-5 relative; the
# gradients 5e-5 (the JAX test's); graphs equal to their eager runs.

from ggml_cuda_experiments_tpu_torch.models import (  # noqa: E402
    speculative as spec)
from ggml_cuda_experiments_tpu_torch.ops import vpu_attention as va  # noqa: E402


def _vpu_inputs(seed, B, H, T, S, D, dtype, dev):
    return [_randn(seed + i, *shape).to(dev, dtype) for i, shape in
            enumerate(((B, H, T, D), (B, H, S, D), (B, H, S, D)))]


# D 36 (bf16: 72-byte rows) and 33 take the element-by-element loads
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [40, 64, 80, 128, 36, 33])
@pytest.mark.parametrize("causal", [True, False])
def test_vpu_attention(dev, dtype, D, causal):
    B, H, T, S = 2, 3, 11, 320
    q, k, v = _vpu_inputs(D, B, H, T, S, D, dtype, dev)
    lengths = torch.tensor([S, 201], dtype=torch.int32, device=dev)
    kw = dict(causal=causal, scale=None, block_k=64, q0_pos=150)
    before = va.LAUNCHES["vpu_attention"]
    o, lse = va._vpu_attention_fwd_impl(q, k, v, lengths, **kw)
    torch.cuda.synchronize()
    assert va.LAUNCHES["vpu_attention"] == before + 1
    with plain_versions():
        ro, rlse = va._vpu_attention_fwd_impl(q, k, v, lengths, **kw)
    assert o.dtype == dtype and o.shape == q.shape and lse.shape == (B, H, T)
    err = (o.float() - ro.float()).abs().max()
    bound = 2e-5 if dtype == torch.float32 else 1e-2 * ro.float().abs().max()
    assert err <= bound, float(err)
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs()).all()


def test_vpu_attention_row_without_keys(dev):
    """lengths == 0 gives the mean of v over all S keys, as the plain
    version and the JAX kernel do."""
    q, k, v = _vpu_inputs(7, 2, 2, 5, 256, 64, torch.float32, dev)
    lengths = torch.tensor([0, 256], dtype=torch.int32, device=dev)
    o = va.vpu_attention(q, k, v, lengths, True, None, 128, 251)
    assert (o[0] - v[0].mean(1, keepdim=True)).abs().max() <= 2e-5
    with plain_versions():
        ro = va.vpu_attention(q, k, v, lengths, True, None, 128, 251)
    assert (o - ro).abs().max() <= 2e-5


def test_vpu_attention_gradients(dev):
    B, H, T, S, D = 1, 4, 5, 256, 64
    q, k, v = _vpu_inputs(9, B, H, T, S, D, torch.float32, dev)
    do = _randn(13, B, H, T, D).to(dev)
    lengths = torch.tensor([200], dtype=torch.int32, device=dev)
    grads = []
    for plain in (False, True):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        with plain_versions() if plain else contextlib.nullcontext():
            o = va.vpu_attention(*xs, lengths, True, None, 128, S - T)
        grads.append(torch.autograd.grad(o, xs, do))
    for got, want in zip(*grads):
        assert (got - want).abs().max() <= 5e-5


def test_vpu_attention_raises(dev):
    q, k, v = _vpu_inputs(1, 1, 1, 2, 64, 64, torch.float32, dev)
    lengths = torch.tensor([64], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):                    # mixed dtypes
        va.vpu_attention(q, k.bfloat16(), v, lengths)
    with pytest.raises(ValueError):                    # f16
        va.vpu_attention(q.half(), k.half(), v.half(), lengths)
    with pytest.raises(ValueError):                    # not contiguous
        va.vpu_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                         v, lengths)


# S 64 / 65 / 4096 at 1, 2 and many splits of the keys; lengths 0 (every
# split computes: m = MASK, l = its keys) and 1 (every later split the
# identity)
@pytest.mark.parametrize("S,span,lens", [
    (64, 64, (64, 0)), (65, 64, (65, 0)), (65, 128, (65, 1)),
    (4096, 64, (4096, 0)), (4096, 1024, (3000, 1))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vpu_attention_splits(dev, S, span, lens, dtype):
    """The partials kernel against ``_vpu_partials_ref`` (the identity
    exactly, m and l 1e-5 relative, o to o's bound times the largest |o|
    of the partials), and the merge kernel on them against the unsplit
    plain version (o 2e-5 / 1e-2 * max, lse 1e-5 relative)."""
    B, H, T, D = 2, 3, 5, 64
    q, k, v = _vpu_inputs(S, B, H, T, S, D, dtype, dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    kw = dict(causal=True, scale=D ** -0.5, q0_pos=S - T)
    before = dict(va.LAUNCHES)
    po, pm, pl = va._vpu_partials(q, k, v, lengths, span=span, **kw)
    o, lse = va._vpu_merge(po, pm, pl, dtype)
    torch.cuda.synchronize()
    assert va.LAUNCHES["vpu_attention"] == before["vpu_attention"] + 1
    assert va.LAUNCHES["vpu_attention_merge"] == before[
        "vpu_attention_merge"] + 1
    with plain_versions():
        ro_, rm, rl = va._vpu_partials(q, k, v, lengths, span=span, **kw)
        ro, rlse = va._vpu_attention_fwd_impl(q, k, v, lengths, **kw)
    assert po.shape == (B, H, T, -(-S // span), D)
    ident = torch.isneginf(rm)
    assert torch.equal(torch.isneginf(pm), ident)
    assert not pl[ident].any() and not po[ident].any()
    assert ((pm - rm).abs() <= 1e-5 * rm.abs())[~ident].all()
    assert ((pl - rl).abs() <= 1e-5 * rl.abs())[~ident].all()
    tol = 2e-5 if dtype == torch.float32 else 1e-2
    assert (po - ro_).abs().max() <= tol * ro_.abs().max()
    assert o.dtype == dtype
    bound = tol if dtype == torch.float32 else tol * ro.float().abs().max()
    assert (o.float() - ro.float()).abs().max() <= bound
    assert ((lse - rlse).abs() <= 1e-5 * rlse.abs()).all()


def _debug_pair(dev):
    cfg = dataclasses.replace(PRESETS["debug"], n_layers=2)
    params = _to(llama.quantize_params(
        llama.init_weights(cfg, seed=0, device="cpu"), "q4_k"), dev)
    return params, cfg


def test_generate_scan_graph_equals_generate(dev):
    params, cfg = _debug_pair(dev)
    prompt = torch.arange(1, 9, device=dev)[None]
    want = llama.generate(params, cfg, prompt, 12)
    got = llama.generate_scan(params, cfg, prompt,
                              llama.KVCache.create(cfg, 1, 256, device=dev),
                              12)
    np.testing.assert_array_equal(got, want)


def test_speculative_scan_graph_equals_eager_windows(dev):
    """speculative_scan's replayed graph emits the stream of the eager host
    loop (speculative_generate: the same kernels, a window at a time), on
    q4_k debug weights with a 1-layer draft; the caches end where the
    accepted tokens put them."""
    params, cfg = _debug_pair(dev)
    dparams = {**params, "layers": params["layers"][:1]}
    dcfg = dataclasses.replace(cfg, n_layers=1)
    prompt = torch.arange(3, 19, device=dev)[None]
    tcache = llama.KVCache.create(cfg, 1, 256, device=dev)
    dcache = llama.KVCache.create(dcfg, 1, 256, device=dev)
    tlog, _ = llama.prefill(params, cfg, prompt, tcache)
    llama.prefill(dparams, dcfg, prompt, dcache)
    cur = torch.argmax(tlog, -1).to(torch.int32)
    toks, counts, cur2, tcache, dcache = spec.speculative_scan(
        params, cfg, dparams, dcfg, cur, tcache, dcache, gamma=3, windows=6)
    toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
    stream = [int(cur[0])]
    for w in range(6):
        stream.extend(toks[w, :counts[w]].tolist())
    assert int(cur2[0]) == stream[-1]
    assert tcache.lengths.tolist() == dcache.lengths.tolist() == [
        16 + int(counts.sum())]
    eager, _ = spec.speculative_generate(params, cfg, dparams, dcfg, prompt,
                                         len(stream), gamma=3, max_len=256)
    assert stream == eager[0].tolist()


def test_spec_bench_replays_one_capture(dev):
    """spec_bench times replays of one captured window from a restored
    state: the longer run's stream is speculative_scan's, and a capture
    counts two windows' launches (the eager one and the captured one),
    whatever the replays."""
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    params, cfg = _debug_pair(dev)
    dparams = {**params, "layers": params["layers"][:1]}
    dcfg = dataclasses.replace(cfg, n_layers=1)
    prompt = torch.arange(3, 19, device=dev)[None]
    fa.LAUNCHES["flash_attention"] = 0
    secs, counts, stream = sb.window_cost(params, cfg, dparams, dcfg, prompt,
                                          3, 2, 5, max_len=256)
    assert np.isfinite(secs) and counts.shape == (5,)
    # the two prefills (2 + 1 layers) and two verify passes (2 layers)
    assert fa.LAUNCHES["flash_attention"] == 3 + 2 * 2
    eager, _ = spec.speculative_generate(params, cfg, dparams, dcfg, prompt,
                                         len(stream), gamma=3, max_len=256)
    assert stream == eager[0].tolist()
    assert sb.plain_per_token(params, cfg, prompt, max_len=256) > 0


# --------------------------------------------------------------------------
# the probe kernels (ops/probes.py, ops/mosaic_probes.py): every ladder
# rung, q6 rung and Mosaic probe against its plain version. Integer parts
# and the Mosaic probes bitwise; floor and q6 stream (f32 sums of es / em
# in another order) 1e-5 * max; the f32 rungs 1e-4 * max; bf16 2e-2 * max;
# full and cols256 (q4k_q8_matvec's operands and dots) 1e-4 * max, and
# full_pre bitwise equal to q4k_q8_matvec.
# --------------------------------------------------------------------------

_LADDER_TOL = {"floor": 1e-5, "bf16": 2e-2}


def _ladder_weight(dev, n, k, seed=3):
    return qm.quantize(_randn(seed, n, k, scale=k ** -0.5).to(dev), "q4_k")


@pytest.mark.parametrize("mode", ["floor", "chunk", "chunk32", "ponly",
                                  "loonly", "nochunk", "floorhi", "bf16",
                                  "dma", "zponly", "zlonly", "full", "noand",
                                  "cols256", "split_f32"])
@pytest.mark.parametrize("n,k,ctas", [(2048, 4096, 0), (300, 8192, 1)])
def test_q4_ladder(dev, mode, n, k, ctas):
    from ggml_cuda_experiments_tpu_torch.ops import probes
    ql = _ladder_weight(dev, n, k)
    x = _randn(4, 1, k).to(dev)
    act = probes.act_operands(mode, x)
    _check(probes.ladder, mode, act, x, ql, ctas,
           tol=_LADDER_TOL.get(mode, 1e-4))


@pytest.mark.parametrize("n,k", [(4096, 4096), (300, 12288)])
def test_full_pre_is_q4k_q8_matvec_bitwise(dev, n, k):
    from ggml_cuda_experiments_tpu_torch.ops import probes
    ql = _ladder_weight(dev, n, k)
    x = _randn(5, 1, k).to(dev)
    act = probes.q8_prep(x)
    with plain_versions():
        assert torch.equal(act, probes.q8_prep(x))
    assert torch.equal(probes.full_pre(x, ql), qm.q4k_q8_matvec(x, ql))
    assert torch.equal(probes.ladder("cols256", act, x, ql),
                       qm.q4k_q8_matvec(x, ql))


def _q6_operands(dev, n, seed=6):
    from ggml_cuda_experiments_tpu_torch.tools import q6_probe
    return q6_probe.draw_operands(n, np.random.default_rng(seed), dev)


@pytest.mark.parametrize("mode", ["stream", "bits2", "nib_global",
                                  "nib_seg"])
@pytest.mark.parametrize("n", [1024, 333])
def test_q6_rungs(dev, mode, n):
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.tools import q6_probe
    ops = _q6_operands(dev, n)
    fn = q6_probe.rung(mode, ops)
    _check(fn, (ops["qs"], ops["qh"], ops["es"]),
           tol=1e-5 if mode == "stream" else 1e-4)
    if mode.startswith("nib"):
        lhs = probes.q6_nib_lhs(ops["qs"], mode == "nib_seg")
        with plain_versions():
            assert torch.equal(lhs, probes.q6_nib_lhs(ops["qs"],
                                                      mode == "nib_seg"))


def test_mosaic_probes(dev):
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    x = _randn(7, 32, 128).to(dev)
    e = torch.eye(32, device=dev)
    big = _randn(8, 128, 128).to(dev)
    row = _randn(9, 1, 4096).to(dev)
    small = _randn(10, 8, 128).to(dev)
    for fn, args in ((mp.transpose_dot, (x, e)), (mp.lane_concat, (big,)),
                     (mp.roll64, (x,)), (mp.dyn_sublane, (x,)),
                     (mp.lane_extract, (row,)), (mp.read_output, (small,)),
                     (mp.tiny_call, (small,))):
        got = fn(*args)
        with plain_versions():
            ref = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            assert torch.equal(g, r), fn.__name__
    # dyn_sublane's other paths: a slice of 2,000 float4s over two blocks,
    # a float a thread (C % 4 != 0), and a base off 16-byte alignment
    unaligned = _randn(11, 32 * 128 + 1).to(dev)[1:].view(32, 128)
    for x in (_randn(12, 64, 1000).to(dev), _randn(13, 16, 3).to(dev),
              unaligned):
        before = mp.LAUNCHES["mosaic_dyn_sublane"]
        got = mp.dyn_sublane(x)
        torch.cuda.synchronize()
        assert mp.LAUNCHES["mosaic_dyn_sublane"] == before + 1
        with plain_versions():
            assert torch.equal(got, mp.dyn_sublane(x)), tuple(x.shape)


def test_probe_tools_on_the_card(dev):
    from ggml_cuda_experiments_tpu_torch.tools import (
        exp_q4, exp_q4_r2, probe_mosaic_r3)
    assert probe_mosaic_r3.main([]) == 0
    assert exp_q4_r2.main(["--check", "--probes",
                           "dma,zponly,zlonly,full,noand,cols256,split,"
                           "full_pre,full:1"]) == 0
    assert exp_q4.main(["--check", "--rows", "4096"]) == 0


@pytest.mark.parametrize("fmt", qm.FORMATS)
def test_quantize_blocks_on_the_card(dev, fmt):
    """The GGML fields a GGUF writer encodes, computed on the card: equal
    to the port's oracle bit for bit (ties, a zero and a constant block
    among the rows)."""
    from ggml_cuda_experiments_tpu_torch.oracle import quant as oq
    w = _randn(21, 256, 4096, scale=0.05)
    w[0, :32] = 0.01
    w[0, 3], w[0, 9] = 0.5, -0.5
    w[1, :256] = 0.0
    w[2, :256] = 0.125
    got = qm.quantize_blocks(w.to(dev), fmt)
    want = getattr(oq, f"quantize_{fmt}")(w.numpy())
    for f in dataclasses.fields(want):
        if f.name != "shape":
            a, b = getattr(got, f.name), getattr(want, f.name)
            assert a.is_cuda and np.array_equal(a.cpu().numpy(), b), f.name


def test_load_gguf_onto_the_card(dev, tmp_path):
    """A Q4_K_M-style file of the debug model, written from weights on the
    card and loaded there: every field equal to the CPU load's (the codecs
    on the card are exact), the loaded model's generate equal to the same
    blocks quantized directly on the card."""
    from ggml_cuda_experiments_tpu_torch.utils import gguf
    cfg = PRESETS["debug"]
    dense = llama.init_weights(cfg, seed=4, device=dev)
    path = str(tmp_path / "debug.gguf")
    gguf.export_llama(path, dense, cfg)
    on_card, lcfg = gguf.load_gguf(path)
    on_cpu, _ = gguf.load_gguf(path, device="cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in tree for x in leaves(tree[k])]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        if isinstance(tree, qm.QuantLinear):
            return [t for t in (tree.qs, tree.es, tree.em, tree.qh, tree.d)
                    if t is not None]
        return [tree]

    for a, b in zip(leaves(on_card), leaves(on_cpu), strict=True):
        assert a.is_cuda and torch.equal(a.cpu(), b)
    fmt = lambda n: gguf.q4_k_m_format(n, cfg.n_layers)
    direct = dict(on_card, lm_head=qm.quantize(dense["lm_head"],
                                               fmt("output.weight")))
    direct["layers"] = [dict(lay, wq=qm.quantize(d["wq"], "q4_k"),
                             wk=qm.quantize(d["wk"], "q4_k"))
                        for lay, d in zip(on_card["layers"],
                                          dense["layers"])]
    for lay, d in zip(direct["layers"], on_card["layers"]):
        for k in ("wq", "wk"):                 # back in the original rows
            assert all(torch.equal(a, b) for a, b in zip(
                leaves(lay[k]), leaves(d[k]), strict=True)), k
    prompt = torch.arange(1, 9, device=dev)[None]
    assert np.array_equal(llama.generate(on_card, lcfg, prompt, steps=6),
                          llama.generate(direct, lcfg, prompt, steps=6))


@pytest.mark.parametrize("n,k", [(14336, 4096), (4096, 14336)])
def test_moe_expert_slices(dev, n, k):
    """Expert slices of a stacked q4_k weight at Mixtral's expert shapes
    (K = 14336: K / 32 = 448 blocks) are views the kernels take as they
    are: q4k_matvec and q4k_gemm on each slice bit-equal to the same call
    on a standalone copy of that expert, and within their tolerances of
    the plain versions."""
    from ggml_cuda_experiments_tpu_torch.models import moe
    g = torch.Generator(device=dev).manual_seed(n + 3 * k)
    experts = [qm.quantize(torch.randn((n, k), generator=g, device=dev)
                           * k ** -0.5) for _ in range(3)]
    stack = moe.stack_expert_quant(experts)
    x1 = torch.randn((1, k), generator=g, device=dev)
    x8 = torch.randn((8, k), generator=g, device=dev).to(torch.bfloat16)
    for e, alone in enumerate(experts):
        s = moe._expert_slice(stack, e)
        assert s.qs.data_ptr() == stack.qs[e].data_ptr()
        qm._check_ql(s, dev)
        assert torch.equal(qm.q4k_matvec(x1, s), qm.q4k_matvec(x1, alone))
        assert torch.equal(qm.q4k_gemm(x8, s), qm.q4k_gemm(x8, alone))
    _check(qm.q4k_matvec, x1, s, tol=1e-4)
    _check(qm.q4k_gemm, x8, s, tol=2e-2)


@pytest.mark.parametrize("rows", [1, 8])
def test_moe_mlp_on_card(dev, rows):
    """moe_mlp on stacked q4_k experts (moe-debug's layer at dim 4096):
    one q4k_matvec or q4k_gemm per expert linear, within 2e-2 * max of the
    plain versions; the one-row step captured in a graph replays to the
    same bits."""
    from ggml_cuda_experiments_tpu_torch.models import moe
    cfg = dataclasses.replace(PRESETS["moe-debug"], dim=4096,
                              intermediate=1024)
    g = torch.Generator(device=dev).manual_seed(rows)
    E = cfg.n_experts

    def lin(*shape):
        return torch.randn(shape, generator=g, device=dev) * shape[-1] ** -0.5

    layer = {"router": lin(E, 4096).to(torch.bfloat16)}
    for key, (n, k) in (("w_gate", (1024, 4096)), ("w_up", (1024, 4096)),
                        ("w_down", (4096, 1024))):
        layer[key] = moe.stack_expert_quant([qm.quantize(lin(n, k))
                                             for _ in range(E)])
    x = lin(rows, 4096).to(torch.bfloat16) * 64
    name = "q4k_matvec" if rows == 1 else "q4k_gemm"
    before = qm.LAUNCHES[name]
    _check(moe.moe_mlp, layer, cfg, x, tol=2e-2)
    assert qm.LAUNCHES[name] == before + 3 * E
    if rows == 1:
        want = moe.moe_mlp(layer, cfg, x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y = moe.moe_mlp(layer, cfg, x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(y, want)


# ---------------------------------------------------------------- q4_k s6

def _s6(seed, n, k, dev, scale=None):
    return qm.quantize(_randn(seed, n, k, scale=scale or k ** -0.5).to(dev),
                       enc="s6")


@pytest.mark.parametrize("n,k", [(300, 4096), (4096, 4096), (37, 12288),
                                 (12288, 4096), (130, 8192)])
def test_q4k_s6_matvec(dev, n, k):
    """Every split the plan picks (37 rows: 8 splits of 48 blocks, a step
    of 16 the last), ragged N; bitwise repeatable; launched under its own
    key, never the Q4_K-E one."""
    ql = _s6(60, n, k, dev)
    x = _randn(61, 1, k).to(dev)
    before = dict(qm.LAUNCHES)
    _check(qm.q4k_s6_matvec, x, ql, tol=1e-4)
    assert qm.LAUNCHES["q4k_s6_matvec"] == before["q4k_s6_matvec"] + 1
    assert qm.LAUNCHES["q4k_matvec"] == before["q4k_matvec"]
    first = qm.q4k_s6_matvec(x, ql)
    assert torch.equal(first, qm.q4k_s6_matvec(x, ql))


@pytest.mark.parametrize("n,k", [(640, 4096), (300, 12288)])
def test_q4k_s6_q8_matvec(dev, n, k):
    ql = _s6(62, n, k, dev)
    before = qm.LAUNCHES["q4k_s6_q8_matvec"]
    _check(qm.q4k_s6_q8_matvec, _randn(63, 1, k).to(dev), ql, tol=1e-4)
    assert qm.LAUNCHES["q4k_s6_q8_matvec"] == before + 1


S6_GEMM_CASES = [(m, n, k) for m in (2, 17, 32, 33, 300) for n in (130, 300)
                 for k in (4096, 12288)]


@pytest.mark.parametrize("m,n,k", S6_GEMM_CASES,
                         ids=[f"M{m}-N{n}-K{k}" for m, n, k in S6_GEMM_CASES])
def test_q4k_s6_gemm(dev, m, n, k):
    """Both routes (gemm_route), each instance's part-empty tile, ragged N;
    bitwise repeatable."""
    ql = _s6(64, n, k, dev)
    x = _randn(65, m, k).to(dev, torch.bfloat16)
    route = qm.gemm_route(m)
    before = qm.LAUNCHES["q4k_s6_gemm"], qm.GEMM_ROUTE_LAUNCHES[route]
    _check(qm.q4k_s6_gemm, x, ql, tol=2e-2)
    assert (qm.LAUNCHES["q4k_s6_gemm"], qm.GEMM_ROUTE_LAUNCHES[route]) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(qm.q4k_s6_gemm(x, ql), qm.q4k_s6_gemm(x, ql))


@pytest.mark.parametrize("kd", [4096, 12288])
def test_fused_mlp_s6(dev, kd):
    w_gu = _s6(66, 2 * kd, 4096, dev, 1 / 64)
    w_down = _s6(67, 256, kd, dev, 1 / 64)
    before = qm.LAUNCHES["fused_mlp_s6"], qm.LAUNCHES["fused_mlp"]
    _check(qm.mlp_fused, _randn(68, 1, 4096).to(dev), w_gu, w_down, tol=5e-3)
    assert (qm.LAUNCHES["fused_mlp_s6"], qm.LAUNCHES["fused_mlp"]) == (
        before[0] + 1, before[1])


@pytest.mark.parametrize("hkv", [32, 8])
@pytest.mark.parametrize("length", [0, 255, 1023])
def test_fused_attention_s6(dev, hkv, length):
    """One split (0), several (255), the cache's last slot (1023)."""
    wqkv = _s6(69, (32 + 2 * hkv) * 128, 4096, dev, 1 / 64)
    wo = _s6(70, 4096, 4096, dev, 1 / 64)
    kc = _randn(71, 2, 1, hkv, 1024, 128).to(dev, torch.bfloat16)
    vc = _randn(72, 2, 1, hkv, 1024, 128).to(dev, torch.bfloat16)
    x = _randn(73, 1, 4096).to(dev)
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    kw = dict(n_heads=32, n_kv_heads=hkv, head_dim=128)
    before = fat.LAUNCHES["fused_attention_s6"], fat.LAUNCHES[
        "fused_attention"]
    got = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 1, **kw)
    with plain_versions():
        ref = fat.attention_fused(x, wqkv, wo, kc, vc, lens, 1, **kw)
    torch.cuda.synchronize()
    assert (fat.LAUNCHES["fused_attention_s6"],
            fat.LAUNCHES["fused_attention"]) == (before[0] + 1, before[1])
    _close(got[0], ref[0], 5e-3)
    for g, r in zip(got[1:], ref[1:]):
        _close(g, r, 2e-2, floor=1.0)


def test_s6_weights_never_reach_an_e_kernel(dev):
    """A Q4_K-E wrapper refuses an s6 weight (and an s6 one a Q4_K-E
    weight) before any launch; mixed encodings in one fused block raise."""
    s6, e = _s6(74, 256, 4096, dev), qm.quantize(
        _randn(74, 256, 4096, scale=1 / 64).to(dev))
    x = _randn(75, 1, 4096).to(dev)
    before = dict(qm.LAUNCHES)
    for fn, w in ((qm.q4k_matvec, s6), (qm.q4k_q8_matvec, s6),
                  (qm.q4k_s6_matvec, e), (qm.q4k_s6_q8_matvec, e)):
        with pytest.raises(ValueError):
            fn(x, w)
    for fn, w in ((qm.q4k_gemm, s6), (qm.q4k_s6_gemm, e)):
        with pytest.raises(ValueError):
            fn(x.repeat(4, 1).to(torch.bfloat16), w)
    w_gu, w_down = _s6(76, 8192, 4096, dev), qm.quantize(
        _randn(77, 256, 4096, scale=1 / 64).to(dev))
    with pytest.raises(ValueError):
        qm.mlp_fused(x, w_gu, w_down)
    assert qm.LAUNCHES == before
