"""GGML Q8_0, Q4_0, Q4_K and Q6_K block quantization in NumPy: the
executable specification the port's device quantizers and kernels are held
to.

The port's own copy of the JAX package's ``oracle/quant.py`` (same
arithmetic, same planar layouts), so the port imports nothing of that
package.

Q8_0 and Q4_0, per 32-element block:

    Q8_0 qs int8  [..., N]     q in [-127, 127]
         d  f32   [..., N/32]  absmax / 127, fp16-rounded
    Q4_0 qs uint8 [..., N/2]   per-32-block planar nibbles (as Q4_K's)
         d  f32   [..., N/32]  (signed value of largest |x|) / -8,
                               fp16-rounded

Dequantization: x = d * q (Q8_0), x = d * (q - 8) (Q4_0).

Q4_K, per-32-block planar nibbles:

    qs   uint8 [..., N/2]    byte j of a block: element j (low nibble),
                             element j + 16 (high nibble)
    sc   uint8 [..., N/32]   6-bit sub-scales
    mn   uint8 [..., N/32]   6-bit sub-mins
    d    f32   [..., N/256]  superblock scale (fp16-rounded)
    dmin f32   [..., N/256]  superblock min scale (fp16-rounded)

Dequantization: x = (d * sc) * q - (dmin * mn), q in [0, 15].

Q6_K, one byte per element (GGML's ql / qh bit packing is a storage
detail the port's container makes its own):

    qs   uint8 [..., N]      q + 32, values 0..63
    sc   int8  [..., N/16]   signed sub-scales
    d    f32   [..., N/256]  superblock scale (fp16-rounded)

Dequantization: x = (d * sc) * (q - 32), per 16-element sub-block.

Per-row int8 and float8_e4m3fn codecs (the quantized KV cache's): absmax
scales per last-axis row; the fp8 rounding goes through
``torch.float8_e4m3fn`` (the JAX copy's ``ml_dtypes`` is not needed).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

QK = 32          # elements per quantization block
QK_K = 256       # elements per Q4_K superblock


def np_div(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a / b where b != 0, else 0."""
    return np.divide(a, b, out=np.zeros_like(a), where=(b != 0))


def _f16_round(x: np.ndarray) -> np.ndarray:
    """Round scale factors through fp16, as GGML stores them in fp16."""
    return x.astype(np.float16).astype(np.float32)


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """[..., nb, 32] uint8 (values 0..15) -> [..., nb, 16] packed uint8."""
    return (q[..., :16] | (q[..., 16:] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """[..., nb, 16] packed uint8 -> [..., nb, 32] uint8 (values 0..15)."""
    return np.concatenate([packed & np.uint8(0x0F), packed >> 4], axis=-1)


@dataclasses.dataclass
class Q8_0:
    """Planar Q8_0 tensor: per-32-block absmax int8 quantization."""
    qs: np.ndarray
    d: np.ndarray
    shape: tuple

    @property
    def bits_per_weight(self) -> float:
        return 8 + 16 / QK


def quantize_q8_0(x: np.ndarray) -> Q8_0:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK == 0, f"last dim {n} must be a multiple of {QK}"
    xb = x.reshape(*lead, n // QK, QK)
    amax = np.max(np.abs(xb), axis=-1)
    d = _f16_round(amax / 127.0)
    inv_d = np_div(np.ones_like(d), d)
    q = np.clip(np.round(xb * inv_d[..., None]), -127, 127).astype(np.int8)
    return Q8_0(qs=q.reshape(*lead, n), d=d, shape=tuple(x.shape))


def dequantize_q8_0(t: Q8_0) -> np.ndarray:
    *lead, n = t.shape
    q = t.qs.reshape(*lead, n // QK, QK).astype(np.float32)
    return (q * t.d[..., None]).reshape(t.shape)


@dataclasses.dataclass
class Q4_0:
    """Planar Q4_0 tensor: per-32-block symmetric 4-bit quantization."""
    qs: np.ndarray
    d: np.ndarray
    shape: tuple

    @property
    def bits_per_weight(self) -> float:
        return 4 + 16 / QK


def quantize_q4_0(x: np.ndarray) -> Q4_0:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK == 0, f"last dim {n} must be a multiple of {QK}"
    xb = x.reshape(*lead, n // QK, QK)
    # GGML's rule: the signed value of largest |x| (np.argmax: the first
    # such index on ties, so +v before -v keeps the +) over -8, so that it
    # maps to q = 0 (after the +8 offset) exactly
    idx = np.argmax(np.abs(xb), axis=-1, keepdims=True)
    maxv = np.take_along_axis(xb, idx, axis=-1)[..., 0]
    d = _f16_round(maxv / -8.0)
    inv_d = np_div(np.ones_like(d), d)
    q = np.clip(np.round(xb * inv_d[..., None]) + 8, 0, 15).astype(np.uint8)
    return Q4_0(qs=pack_nibbles(q).reshape(*lead, n // 2), d=d,
                shape=tuple(x.shape))


def dequantize_q4_0(t: Q4_0) -> np.ndarray:
    *lead, n = t.shape
    packed = t.qs.reshape(*lead, n // QK, QK // 2)
    q = unpack_nibbles(packed).astype(np.float32) - 8.0
    return (q * t.d[..., None]).reshape(t.shape)


@dataclasses.dataclass
class Q4_K:
    """Planar Q4_K tensor: asymmetric 4-bit, 6-bit sub-scales per
    superblock; x ~ (d * sc_j) * q - (dmin * mn_j) for 32-element
    sub-block j of each 256-element superblock."""
    qs: np.ndarray
    sc: np.ndarray
    mn: np.ndarray
    d: np.ndarray
    dmin: np.ndarray
    shape: tuple


def quantize_q4_k(x: np.ndarray) -> Q4_K:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK_K == 0, f"last dim {n} must be a multiple of {QK_K}"
    nsb = n // QK_K
    xb = x.reshape(*lead, nsb, 8, QK)
    mn_f = np.minimum(np.min(xb, axis=-1), 0.0)
    mx_f = np.maximum(np.max(xb, axis=-1), 0.0)
    scale_f = (mx_f - mn_f) / 15.0
    neg_mn = -mn_f
    d = _f16_round(np.max(scale_f, axis=-1) / 63.0)
    dmin = _f16_round(np.max(neg_mn, axis=-1) / 63.0)
    sc = np.clip(np.round(scale_f * np_div(np.ones_like(d), d)[..., None]),
                 0, 63).astype(np.uint8)
    inv_dmin = np_div(np.ones_like(dmin), dmin)
    mn = np.clip(np.round(neg_mn * inv_dmin[..., None]), 0, 63)
    mn = mn.astype(np.uint8)
    # quantize against the decoded scales, so dequantization inverts exactly
    eff_scale = d[..., None] * sc.astype(np.float32)
    eff_min = dmin[..., None] * mn.astype(np.float32)
    inv_s = np_div(np.ones_like(eff_scale), eff_scale)
    q = np.clip(np.round((xb + eff_min[..., None]) * inv_s[..., None]), 0, 15)
    q = q.astype(np.uint8)
    return Q4_K(
        qs=pack_nibbles(q.reshape(*lead, n // QK, QK)).reshape(*lead, n // 2),
        sc=sc.reshape(*lead, n // QK), mn=mn.reshape(*lead, n // QK),
        d=d, dmin=dmin, shape=tuple(x.shape))


def dequantize_q4_k(t: Q4_K) -> np.ndarray:
    *lead, n = t.shape
    nsb = n // QK_K
    q = unpack_nibbles(t.qs.reshape(*lead, n // QK, QK // 2)).astype(
        np.float32)
    sc = t.sc.reshape(*lead, nsb, 8).astype(np.float32)
    mn = t.mn.reshape(*lead, nsb, 8).astype(np.float32)
    eff_scale = (t.d[..., None] * sc).reshape(*lead, n // QK)
    eff_min = (t.dmin[..., None] * mn).reshape(*lead, n // QK)
    return (q * eff_scale[..., None] - eff_min[..., None]).reshape(t.shape)


QK6 = 16         # elements per Q6_K scale block (16 per 256-superblock)


@dataclasses.dataclass
class Q6_K:
    """Planar Q6_K tensor: symmetric 6-bit, int8 scales per 16-element
    sub-block of a 256-element superblock; x ~ (d * sc_j) * (q - 32)."""
    qs: np.ndarray
    sc: np.ndarray
    d: np.ndarray
    shape: tuple


def quantize_q6_k(x: np.ndarray) -> Q6_K:
    x = np.asarray(x, np.float32)
    *lead, n = x.shape
    assert n % QK_K == 0, f"last dim {n} must be a multiple of {QK_K}"
    nsb = n // QK_K
    xb = x.reshape(*lead, nsb, QK_K // QK6, QK6)
    # per-sub-block signed scale: the value of largest |x| (the first such
    # index on ties) maps to q = -32 exactly
    idx = np.argmax(np.abs(xb), axis=-1, keepdims=True)
    maxv = np.take_along_axis(xb, idx, axis=-1)[..., 0]
    scale_f = maxv / -32.0
    d = _f16_round(np.max(np.abs(scale_f), axis=-1) / 127.0)
    sc = np.clip(np.round(scale_f * np_div(np.ones_like(d), d)[..., None]),
                 -127, 127).astype(np.int8)
    # quantize against the decoded scale, so dequantization inverts exactly
    eff = d[..., None] * sc.astype(np.float32)
    inv_s = np_div(np.ones_like(eff), eff)
    q = np.clip(np.round(xb * inv_s[..., None]), -32, 31) + 32
    return Q6_K(qs=q.astype(np.uint8).reshape(*lead, n),
                sc=sc.reshape(*lead, n // QK6), d=d, shape=tuple(x.shape))


def dequantize_q6_k(t: Q6_K) -> np.ndarray:
    *lead, n = t.shape
    nsb = n // QK_K
    q = t.qs.reshape(*lead, n // QK6, QK6).astype(np.float32) - 32.0
    sc = t.sc.reshape(*lead, nsb, QK_K // QK6).astype(np.float32)
    eff = (t.d[..., None] * sc).reshape(*lead, n // QK6)
    return (q * eff[..., None]).reshape(t.shape)


# ---------------------------------------------------------------------------
# int8 / fp8 per-row (KV-cache) quantization
# ---------------------------------------------------------------------------

def quantize_int8_rowwise(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-last-axis absmax int8 quantization: returns (qs int8, scale f32)."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = amax / 127.0
    inv = np_div(np.ones_like(scale), scale)
    q = np.clip(np.round(x * inv), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8_rowwise(qs: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return qs.astype(np.float32) * scale


FP8_MAX = 448.0     # float8_e4m3fn largest finite value


def to_fp8_e4m3fn(x: np.ndarray) -> np.ndarray:
    """f32 -> float8_e4m3fn (round to nearest even), as its raw bytes in a
    uint8 array of x's shape. NumPy has no fp8 type (the JAX copy uses
    ``ml_dtypes``, which the port does not have), so the rounding goes
    through ``torch.float8_e4m3fn``."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def fp8_e4m3fn_to_f32(raw: np.ndarray) -> np.ndarray:
    """float8_e4m3fn bytes (uint8) -> their f32 values (exact)."""
    t = torch.from_numpy(np.ascontiguousarray(raw, np.uint8))
    return t.view(torch.float8_e4m3fn).to(torch.float32).numpy()


def quantize_fp8_rowwise(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-last-axis absmax float8_e4m3fn quantization: returns (qs, scale
    f32), qs the fp8 bytes as uint8 (``fp8_e4m3fn_to_f32`` reads them). The
    per-row scale maps the absmax to the fp8 range; fp8 keeps ~3 mantissa
    bits against int8's uniform grid, so small entries quantize relatively
    better and large ones worse."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    scale = amax / FP8_MAX
    inv = np_div(np.ones_like(scale), scale)
    return to_fp8_e4m3fn(x * inv), scale.astype(np.float32)


def dequantize_fp8_rowwise(qs: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return fp8_e4m3fn_to_f32(qs) * scale
