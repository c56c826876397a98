"""The probe kernels of the JAX package's measuring tools, ported: the q4_k
stage ladder with the int8-activation prep (``csrc/q4_probe.cu``) and the
q6_k head's probe rungs (``csrc/q6_probe.cu``).

**The q4_k stage ladder.** ``ladder(mode, act, x, ql)`` runs one rung on a
q4_k weight [N, K] (K % 4096 == 0) with the production int8-activation
matvec's load pattern and grid (``q4k_q8_matvec``), so that a rung's time
prices that stage of the port's kernel. Each rung computes the function of
the JAX rung it replaces, on the same operands in logical order: block b of
a row is bytes 16b .. 16b + 15 (byte t: the low nibble lo = element t, the
high nibble element t + 16), p = byte - 128 = lo + 16 hi - 128 (the byte
XOR 0x80 read as int8, ``pack_xor8``), and the prepared activations of
block b at [b][t]. With xl / xh a block's elements 0-15 / 16-31:

======== ================================ =====================================
mode     JAX rung                         y[n] =
======== ================================ =====================================
floor    exp_q4 ``_floor_kernel``          f32(wrapping int32 sum of the row's
                                          qs words) + sum(es + em) + x[0]
chunk    exp_q4 ``_chunk_kernel``          sum_b es (z + c) - em xs,
chunk32  (int8_ops true / false)          z = sum_t lo a + p b (the matvec)
ponly    exp_q4 ``_probe_kernel``          as chunk with z = sum_t p b
loonly                                    as chunk with z = sum_t lo a
nochunk                                   sum_b sum_t lo a + p b (no scales)
floorhi                                   as chunk with a = xl, b = xh - 16 xl,
                                          c = 128 sum xl, z = sum_t p a + hi b,
                                          hi = floor(p / 16 + 8) (the matvec)
bf16                                      as chunk, lo a + p b in bf16
dma      exp_q4_r2 ``k_dma``               sum_b es p_0 - em xs (byte 0 only)
zponly   ``k_zponly``                     sum_b es (sb zp + c) - em xs
zlonly   ``k_zlonly``                     sum_b es (sa zl + c) - em xs
full     ``k_full`` (``k_onedot``,         sum_b es (sa zl + sb zp + c) - em xs,
         ``k_onedot_sub``, ``k_subtile``)  = ``q4k_q8_matvec``
noand    ``k_noand``                      as full with zl = sum_t p aq
cols256  ``k_cols256``                    as full, every dot taken twice
split_f32 ``k_split_f32``                 as full with sa zl -> sum_t lo af
======== ================================ =====================================

where a = xl - xh/16, b = xh/16, c = 8 sum xh, xs = sum(xl + xh) per block
(``act_operands``), and for the int8 rungs aq / bq, sa / sb the int8
operands of a and b (``quantize_activations_q8``), zl = sum_t lo aq and
zp = sum_t p bq exact int32 dot products, af = a in f32. The JAX rungs
``k_onedot``, ``k_onedot_sub`` and ``k_subtile`` compute ``full``'s function
and differ from it only in how they fed the MXU (one concatenated dot, row
subtiles): they are timed as ``full``. The JAX rungs run on the interleaved
layout; ``floor`` sums the stored bytes, so the two layouts give it
different word sums, and bench.py's stream-only ceiling (``_chunk8_kernel``
under ``CHUNK8_STREAM_ONLY``) sums only ``qs[:, :128]``: a CUDA kernel
reads only what it touches, so the port's floor takes ``_floor_kernel``'s
function, which reads every byte once. ``ctas`` (CTAs per SM, 0: what is
resident) is the ladder's grid knob, the counterpart of the JAX tools'
``bn``; the production kernels have none.

``q8_prep(x)`` quantizes x into device memory once: the operand block that
every CTA of ``q4k_q8_matvec`` builds in its own shared memory.
``full_pre(x, ql)`` = ``ladder("full", q8_prep(x), x, ql)`` is bit-equal
to ``q4k_q8_matvec`` (shape_probe's ``--preprep``).

**The q6_k probe rungs** (tools/q6_probe.py ``_probe_kernel``, on its
random operands at K = 4096): ``q6_stream``, ``q6_bits2`` and
``q6_nib(mode)`` for ``nib_global`` / ``nib_seg``, the int8 selector
products on the port's int8 GEMM (``ops/matmul.py``) between this file's
prologue (``q6_nib_lhs``) and epilogue (``q6_nib_fold``) kernels.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel, or raises, for a CUDA tensor; each launch is counted in
``LAUNCHES``.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops import matmul as mm
from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

MODES = ("floor", "chunk", "chunk32", "ponly", "loonly", "nochunk", "floorhi",
         "bf16", "dma", "zponly", "zlonly", "full", "noand", "cols256",
         "split_f32")
F32_MODES = MODES[1:8]
INT8_MODES = ("dma", "zponly", "zlonly", "full", "noand", "cols256")
Q6_KH, Q6_KQ, Q6_KB = 2048, 1024, 256        # q6 probe bytes at K = 4096

LAUNCHES = {**{f"q4_ladder_{m}": 0 for m in MODES}, "q8_prep": 0,
            "q6_stream": 0, "q6_bits2": 0, "q6_nib_lhs": 0, "q6_nib_fold": 0}

_ROWS = 4096                 # rows per chunk of the plain versions


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"ladder mode {mode!r}: one of {', '.join(MODES)}")
    return MODES.index(mode)


def act_bytes(mode: str, k: int) -> int:
    """Bytes of ``mode``'s operand block for K = ``k``."""
    kb = k // 32
    _mode(mode)
    if mode == "floor":
        return 0
    return kb * (136 if mode in F32_MODES else 112 if mode == "split_f32"
                 else 48)


def pack_xor8(qs: torch.Tensor) -> torch.Tensor:
    """The JAX tools' int8 weight bytes, p = lo + 16 hi - 128: the stored
    q4_k bytes ``qs`` XOR 0x80 read as int8 (exp_q4.py ``pack_xor8``; the
    JAX package now stores q4_k this way, the port stores the plain bytes
    and its kernels XOR them in registers)."""
    return (qs ^ 0x80).view(torch.int8)


def _halves(x: torch.Tensor):
    xb = x.float().reshape(-1, 32)
    return xb[:, :16], xb[:, 16:]


def _q8_block(x: torch.Tensor) -> torch.Tensor:
    aq, bq, sc = qm.quantize_activations_q8(x.reshape(-1))
    return torch.cat([aq.reshape(-1).view(torch.uint8),
                      bq.reshape(-1).view(torch.uint8),
                      sc.float().contiguous().reshape(-1).view(torch.uint8)])


def act_operands(mode: str, x: torch.Tensor) -> torch.Tensor:
    """The prepared operand block of ``mode`` for x [1, K] (or [K]) f32, on
    x's device (plain torch: the JAX tools' prep outside the kernel). f32
    rungs: [a | b | c | xs] (floorhi: a = xl, b = xh - 16 xl, c = 128 sum xl;
    the others a = xl - xh/16, b = xh/16, c = 8 sum xh); int8 rungs: [aq |
    bq | c | xs | sa | sb], the block ``q8_prep`` writes; split_f32: [af |
    that block]; floor: empty."""
    _mode(mode)
    if mode == "floor":
        return torch.empty((0,), dtype=torch.uint8, device=x.device)
    if mode in INT8_MODES:
        return _q8_block(x)
    xl, xh = _halves(x)
    if mode == "floorhi":
        a, b, c = xl, xh - 16.0 * xl, 128.0 * xl.sum(-1)
    else:
        b = xh / 16.0                                # exact
        a, c = xl - b, 8.0 * xh.sum(-1)
    if mode == "split_f32":
        return torch.cat([a.contiguous().reshape(-1).view(torch.uint8),
                          _q8_block(x)])
    xs = (xl + xh).sum(-1)
    return torch.cat([a.reshape(-1), b.reshape(-1), c, xs]).contiguous().view(
        torch.uint8)


def _f32_parts(act: torch.Tensor, kb: int):
    f = act.view(torch.float32)
    return (f[:16 * kb].reshape(kb, 16), f[16 * kb:32 * kb].reshape(kb, 16),
            f[32 * kb:33 * kb], f[33 * kb:34 * kb])


def _q8_parts(act: torch.Tensor, kb: int):
    aq = act[:16 * kb].view(torch.int8).reshape(kb, 16)
    bq = act[16 * kb:32 * kb].view(torch.int8).reshape(kb, 16)
    sc = act[32 * kb:48 * kb].view(torch.float32).reshape(4, kb)
    return aq, bq, sc


def _check_act(mode: str, act: torch.Tensor, k: int) -> None:
    want = act_bytes(mode, k)
    if act.dtype != torch.uint8 or act.dim() != 1 or act.numel() != want \
            or not act.is_contiguous():
        raise ValueError(f"ladder {mode}: need a contiguous uint8 operand "
                         f"block of {want} bytes, got {act.dtype} "
                         f"{tuple(act.shape)}")


def ladder_ref(mode: str, act: torch.Tensor, x: torch.Tensor,
               ql: qm.QuantLinear) -> torch.Tensor:
    """Plain version of ``ladder``: y f32 [1, N] (the table above)."""
    qm._need(ql, "q4_k")
    n, k = ql.array_shape
    kb = k // 32
    _check_act(mode, act, k)
    if mode == "floor":
        words = ql.qs.view(torch.int32).long().sum(1)
        wrapped = (words + 2 ** 31) % 2 ** 32 - 2 ** 31
        fsum = (ql.es.float() + ql.em.float()).sum(1)
        return (wrapped.float() + fsum + x.reshape(-1)[0].float())[None]
    if mode in F32_MODES:
        a, b, c, xs = _f32_parts(act, kb)
    elif mode == "split_f32":
        af = act[:64 * kb].view(torch.float32).reshape(kb, 16)
        aq, bq, (c, xs, sa, sb) = _q8_parts(act[64 * kb:], kb)
    else:
        aq, bq, (c, xs, sa, sb) = _q8_parts(act, kb)
    ys = []
    for r in range(0, n, _ROWS):
        p8 = ql.qs[r:r + _ROWS].reshape(-1, kb, 16)
        es, em = ql.es[r:r + _ROWS].float(), ql.em[r:r + _ROWS].float()
        lo = (p8 & 0x0F).float()
        p = pack_xor8(p8).float()
        if mode in F32_MODES:
            if mode == "ponly":
                t = p * b
            elif mode == "loonly":
                t = lo * a
            elif mode == "floorhi":
                t = p * a + torch.floor(p * 0.0625 + 8.0) * b
            elif mode == "bf16":
                t = (lo.bfloat16() * a.bfloat16()
                     + p.bfloat16() * b.bfloat16()).float()
            else:
                t = lo * a + p * b
            z = t.sum(-1)
            ys.append(z.sum(-1) if mode == "nochunk"
                      else (es * (z + c) - em * xs).sum(-1))
            continue
        if mode == "dma":
            z = p[..., 0]
        else:
            # the integer dots as qmatmul_q8_ref takes them (exact in f32)
            zp = torch.einsum("nbt,bt->nb", p, bq.float())
            zl = torch.einsum("nbt,bt->nb", p if mode == "noand" else lo,
                              aq.float())
            if mode == "zponly":
                z = sb * zp + c
            elif mode == "zlonly":
                z = sa * zl + c
            elif mode == "split_f32":
                z = torch.einsum("nbt,bt->nb", lo, af) + sb * zp + c
            else:                                    # full, noand, cols256
                z = sa * zl + sb * zp + c
        ys.append((es * z - em * xs).sum(-1))
    return torch.cat(ys)[None]


def ladder(mode: str, act: torch.Tensor, x: torch.Tensor,
           ql: qm.QuantLinear, ctas: int = 0) -> torch.Tensor:
    """Rung ``mode`` of the stage ladder on the q4_k weight ``ql`` [N, K]:
    y f32 [1, N] from the operand block ``act`` (``act_operands`` or
    ``q8_prep``) and x [1, K] f32 (floor reads x[0]). ``ctas``: CTAs per SM
    (0: as many as are resident)."""
    if not kernels_for(x):
        return ladder_ref(mode, act, x, ql)
    n, k = qm._check_weight(ql, x)
    if k % 4096 or x.dtype != torch.float32 or x.shape[0] != 1:
        raise ValueError(f"ladder: x f32 [1, K] with K % 4096 == 0, got "
                         f"{x.dtype} {tuple(x.shape)}")
    _check_act(mode, act, k)
    if act.device != x.device or act.data_ptr() % 16:
        raise ValueError("ladder: the operand block must lie on x's device, "
                         "16-byte aligned")
    if ctas < 0:
        raise ValueError(f"ladder: ctas >= 0, got {ctas}")
    y = torch.empty((1, n), dtype=torch.float32, device=x.device)
    rc = _build.lib().q4_ladder(
        _mode(mode), act.data_ptr(), x.data_ptr(), ql.qs.data_ptr(),
        ql.es.data_ptr(), ql.em.data_ptr(), y.data_ptr(), n, k, ctas,
        _build.stream_of(x))
    _build.check(rc, f"q4_ladder {mode}")
    LAUNCHES[f"q4_ladder_{mode}"] += 1
    return y


def floor(x: torch.Tensor, ql: qm.QuantLinear, ctas: int = 0
          ) -> torch.Tensor:
    """The stream floor of ``ql``: ``ladder("floor", ...)``."""
    return ladder("floor", act_operands("floor", x), x, ql, ctas)


def q8_prep(x: torch.Tensor) -> torch.Tensor:
    """x [1, K] f32 (K % 4096 == 0) quantized once into device memory: the
    int8 operand block (uint8 [48 K/32]) of ``q4k_q8_matvec``."""
    if not kernels_for(x):
        return _q8_block(x)
    k = x.shape[-1]
    if x.dtype != torch.float32 or x.numel() != k or k % 4096 \
            or not x.is_contiguous():
        raise ValueError(f"q8_prep: x contiguous f32 [1, K], K % 4096 == 0, "
                         f"got {x.dtype} {tuple(x.shape)}")
    out = torch.empty((48 * (k // 32),), dtype=torch.uint8, device=x.device)
    rc = _build.lib().q8_prep(x.data_ptr(), out.data_ptr(), k,
                              _build.stream_of(x))
    _build.check(rc, "q8_prep")
    LAUNCHES["q8_prep"] += 1
    return out


def full_pre(x: torch.Tensor, ql: qm.QuantLinear, ctas: int = 0
             ) -> torch.Tensor:
    """``q4k_q8_matvec``'s function with x quantized once into device memory
    (``q8_prep``) and the ``full`` rung reading it: two launches, bit-equal
    to ``q4k_q8_matvec``."""
    return ladder("full", q8_prep(x), x, ql, ctas)


def ladder_info(mode: str, k: int) -> dict:
    """Registers, shared memory and occupancy of rung ``mode`` at K (the
    card's runtime, ``cudaFuncGetAttributes``)."""
    return _info(_build.lib().q4_ladder_info, _mode(mode), k)


def _info(fn, *args) -> dict:
    import ctypes
    out = (ctypes.c_int * 7)()
    _build.check(fn(*args, ctypes.cast(out, ctypes.c_void_p)), "kernel info")
    keys = ("regs", "static_smem", "dynamic_smem", "threads", "ctas_per_sm",
            "sms", "local_bytes")
    return dict(zip(keys, list(out)))


def kernel_info(name: str, k: int) -> dict:
    """Registers, shared memory and occupancy of a benched production
    kernel (``q4k_q8_matvec`` or ``q80_matvec``, the latter with
    ``q80_stages``' ring) at K."""
    if name == "q80_matvec":
        return _info(_build.lib().q80_matvec_info, k, qm.q80_stages(k)[0])
    fn = {"q4k_q8_matvec": "q4k_q8_matvec_info"}[name]
    return _info(getattr(_build.lib(), fn), k)


# ---------------------------------------------------------------------------
# the q6_k probe rungs (tools/q6_probe.py)
# ---------------------------------------------------------------------------

def _check_q6(name, qs=None, qh=None, es=None, n=None) -> int:
    arrays = []
    if es is not None:
        n = es.shape[0]
        arrays.append(("es", es, torch.bfloat16, (n, Q6_KB), 16))
    if qs is not None:
        arrays.append(("qs", qs, torch.int8, (n, Q6_KH), 16))
    if qh is not None:
        arrays.append(("qh", qh, torch.int8, (n, Q6_KQ), 16))
    dev = arrays[0][1].device
    qm._check_arrays(dev, arrays)
    if n < 1:
        raise ValueError(f"{name}: no rows")
    return n


def q6_stream_ref(qs, qh, es) -> torch.Tensor:
    return ((qs[:, :128].float().sum(1) + qh[:, :128].float().sum(1))
            + es.float().sum(1))[None]


def q6_stream(qs: torch.Tensor, qh: torch.Tensor, es: torch.Tensor
              ) -> torch.Tensor:
    """The q6 head's stream rung: o f32 [1, N] = sum(qs[:, :128]) +
    sum(qh[:, :128]) + sum(es), every byte streamed."""
    if not kernels_for(es):
        return q6_stream_ref(qs, qh, es)
    n = _check_q6("q6_stream", qs, qh, es)
    o = torch.empty((1, n), dtype=torch.float32, device=es.device)
    rc = _build.lib().q6_stream(qs.data_ptr(), qh.data_ptr(), es.data_ptr(),
                                o.data_ptr(), n, _build.stream_of(es))
    _build.check(rc, "q6_stream")
    LAUNCHES["q6_stream"] += 1
    return o


def q6_bits2_ref(qh, xc, es) -> torch.Tensor:
    u = qh.to(torch.int32) + 128
    h = [((u >> s) & 3).float() for s in (0, 2, 4, 6)]
    t2 = ((h[0] * xc[0] + h[1] * xc[1]) + h[2] * xc[2]) + h[3] * xc[3]
    z = ((t2[:, :256] + t2[:, 256:512]) + t2[:, 512:768]) + t2[:, 768:]
    return (es.float() * z).sum(1)[None]


def q6_bits2(qh: torch.Tensor, xc: torch.Tensor, es: torch.Tensor
             ) -> torch.Tensor:
    """The q6 head's 2-bit plane rung: o f32 [1, N] (csrc/q6_probe.cu)."""
    if not kernels_for(es):
        return q6_bits2_ref(qh, xc, es)
    n = _check_q6("q6_bits2", None, qh, es)
    qm._check_arrays(es.device, (("xc", xc, torch.float32, (4, Q6_KQ), 16),))
    o = torch.empty((1, n), dtype=torch.float32, device=es.device)
    rc = _build.lib().q6_bits2(qh.data_ptr(), xc.data_ptr(), es.data_ptr(),
                               o.data_ptr(), n, _build.stream_of(es))
    _build.check(rc, "q6_bits2")
    LAUNCHES["q6_bits2"] += 1
    return o


def q6_nib_lhs_ref(qs: torch.Tensor, seg: bool) -> torch.Tensor:
    hi4 = ((qs.to(torch.int32) >> 4) + 8).to(torch.int8)
    if not seg:
        return torch.cat([qs, hi4], dim=1)
    h = Q6_KH // 2
    return torch.cat([qs[:, :h], hi4[:, :h], qs[:, h:], hi4[:, h:]], dim=1)


def q6_nib_lhs(qs: torch.Tensor, seg: bool) -> torch.Tensor:
    """[p | hi4] int8 [N, 4096] (seg: per 1 KB segment of qs), hi4 =
    floor(p / 16) + 8: the left operand of the nib rungs' products."""
    if not kernels_for(qs):
        return q6_nib_lhs_ref(qs, seg)
    n = _check_q6("q6_nib_lhs", qs, None, None, qs.shape[0])
    lhs = torch.empty((n, 2 * Q6_KH), dtype=torch.int8, device=qs.device)
    rc = _build.lib().q6_nib_lhs(qs.data_ptr(), lhs.data_ptr(), n, int(seg),
                                 _build.stream_of(qs))
    _build.check(rc, "q6_nib_lhs")
    LAUNCHES["q6_nib_lhs"] += 1
    return lhs


def q6_nib_fold_ref(z0, z1, es) -> torch.Tensor:
    z = torch.cat([z0[:, :128], z1[:, :128]], dim=1).float()
    return (es.float() * z).sum(1)[None]


def q6_nib_fold(z0: torch.Tensor, z1: torch.Tensor, es: torch.Tensor
                ) -> torch.Tensor:
    """o f32 [1, N] = sum_c es[n, c] f32(z[n, c]), columns 0-127 of z from
    z0, 128-255 from z1 (int32 views with unit column stride and one row
    stride)."""
    if not kernels_for(es):
        return q6_nib_fold_ref(z0, z1, es)
    n = _check_q6("q6_nib_fold", None, None, es)
    ld = z0.stride(0)
    for z in (z0, z1):
        if z.dtype != torch.int32 or z.device != es.device or z.stride(1) != 1 \
                or z.stride(0) != ld or z.shape[0] != n or z.shape[1] < 128 \
                or z.data_ptr() % 16:
            raise ValueError("q6_nib_fold: z0 / z1 int32 [N, >=128] views "
                             "with one row stride, 16-byte aligned")
    o = torch.empty((1, n), dtype=torch.float32, device=es.device)
    rc = _build.lib().q6_nib_fold(z0.data_ptr(), z1.data_ptr(), ld,
                                  es.data_ptr(), o.data_ptr(), n,
                                  _build.stream_of(es))
    _build.check(rc, "q6_nib_fold")
    LAUNCHES["q6_nib_fold"] += 1
    return o


def nib_rhs(mode: str, ea: torch.Tensor, eb: torch.Tensor):
    """The right operands of a nib rung's products, made once: global,
    [ea; eb]^T int8 [256, 4096]; seg, per segment s the [ea_s; eb_s][:, :128]
    ^T [128, 2048] (the selectors' rows of that 1 KB segment of qs)."""
    if mode == "nib_global":
        return [torch.cat([ea, eb]).T.contiguous()]
    h = Q6_KH // 2
    return [torch.cat([ea[s * h:(s + 1) * h, :128],
                       eb[s * h:(s + 1) * h, :128]]).T.contiguous()
            for s in range(2)]


def q6_nib(mode: str, qs: torch.Tensor, rhs, es: torch.Tensor
           ) -> torch.Tensor:
    """The nib rung ``mode`` (nib_global or nib_seg): o f32 [1, N] =
    sum_c es[n, c] z[n, c] with z the int8 selector products of p and
    hi4 (``nib_rhs``); the prologue, the port's int8 GEMM (one for global,
    one per segment for seg) and the epilogue."""
    if mode not in ("nib_global", "nib_seg"):
        raise ValueError(f"q6_nib: nib_global or nib_seg, got {mode!r}")
    lhs = q6_nib_lhs(qs, mode == "nib_seg")
    if mode == "nib_global":
        z = mm.matmul(lhs, rhs[0], transpose_b=True)            # [N, 256]
        return q6_nib_fold(z, z[:, 128:], es)
    zs = [mm.matmul(lhs[:, s * Q6_KH:(s + 1) * Q6_KH], rhs[s],
                    transpose_b=True) for s in range(2)]        # [N, 128]
    return q6_nib_fold(zs[0], zs[1], es)
