"""GGUF checkpoints (llama.cpp's wire format): read, write, and load into
the port's model.

The port's own copy of the JAX package's ``utils/gguf.py``: the container
(header, typed metadata, tensor directory, aligned data) and the GGML block
codecs, converted to the planar blocks of the port's ``oracle/quant.py``
and from there to ``QuantLinear`` weights. The bytes ``encode_tensor`` and
``write_gguf`` produce are the reference's for the same values.

Wire layouts (GGML block structs -> planar):
    Q8_0  34 B / 32 elems:  f16 d | 32x i8
    Q4_0  18 B / 32 elems:  f16 d | 16 B nibbles (lo=elem i, hi=elem i+16)
    Q4_K 144 B / 256 elems: f16 d | f16 dmin | 12 B packed 6-bit sc/mn |
                            128 B nibbles (per-64 chunk: lo=i, hi=i+32)
    Q6_K 210 B / 256 elems: 128 B ql | 64 B qh | 16x i8 scales | f16 d
    F32 / F16 / BF16 passthrough (BF16 read through ``torch.bfloat16``).

GGUF dims: ne[0] is the contiguous axis, so a tensor's shape is
``reversed(ne)`` and quantization blocks run along its last axis, the
port's output-major [N, K].

The codecs are written in torch. NumPy bytes decode on the CPU into NumPy
fields, as the reference's reader returns them; a uint8 tensor decodes
where it lies, so ``load_gguf`` copies each tensor's bytes to the card and
decodes them there, one tensor at a time.

``load_gguf`` does not inherit two faults of the reference (ROADMAP C.3.3,
C.3.4):
- a quantized ``token_embd`` (Q4_K in llama.cpp's Q4_K_M files) becomes a
  dense bf16 ``embed``, dequantized on the device; a tied head keeps the
  quantized copy;
- llama.cpp's converter stores ``attn_q`` / ``attn_k`` rows permuted for
  GGML's adjacent-pair RoPE, and the port's RoPE is rotate-half, so the
  reader undoes that permute (``unpermute_qk``). ``write_gguf`` writes
  what it is given; ``permute_qk`` is the converter's permute, for a
  writer of a llama.cpp-order file.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models import moe
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import (
    _field, block_format, dequantize, from_oracle, quantize, quantize_blocks)
from ggml_cuda_experiments_tpu_torch.oracle import quant as oq
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

GGUF_MAGIC = 0x46554747          # "GGUF" little-endian
GGUF_VERSION = 3
ALIGNMENT_KEY = "general.alignment"
DEFAULT_ALIGNMENT = 32

# GGML tensor dtypes (ggml.h enum ggml_type)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q8_0 = 2, 8
GGML_Q4_K, GGML_Q6_K = 12, 14
GGML_BF16 = 30

_TYPE_NAME = {GGML_F32: "f32", GGML_F16: "f16", GGML_BF16: "bf16",
              GGML_Q4_0: "q4_0", GGML_Q8_0: "q8_0", GGML_Q4_K: "q4_k",
              GGML_Q6_K: "q6_k"}
_NAME_TYPE = {v: k for k, v in _TYPE_NAME.items()}

# (block_elems, block_bytes)
_BLOCK = {GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
          GGML_Q4_0: (32, 18), GGML_Q8_0: (32, 34),
          GGML_Q4_K: (256, 144), GGML_Q6_K: (256, 210)}

# GGUF metadata value types
_VT_U8, _VT_I8, _VT_U16, _VT_I16 = 0, 1, 2, 3
_VT_U32, _VT_I32, _VT_F32, _VT_BOOL = 4, 5, 6, 7
_VT_STR, _VT_ARR, _VT_U64, _VT_I64, _VT_F64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {_VT_U8: "<B", _VT_I8: "<b", _VT_U16: "<H", _VT_I16: "<h",
               _VT_U32: "<I", _VT_I32: "<i", _VT_F32: "<f", _VT_BOOL: "<?",
               _VT_U64: "<Q", _VT_I64: "<q", _VT_F64: "<d"}


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]       # reversed ne
    ggml_type: int
    offset: int                  # relative to the data section's start

    @property
    def type_name(self) -> str:
        return _TYPE_NAME.get(self.ggml_type, f"type{self.ggml_type}")

    @property
    def nbytes(self) -> int:
        if self.ggml_type not in _BLOCK:
            raise ValueError(f"{self.name}: unsupported GGML type "
                             f"{self.type_name}")
        be, bb = _BLOCK[self.ggml_type]
        n = int(np.prod(self.shape)) if self.shape else 1
        if n % be:
            raise ValueError(f"{self.name}: {self.shape} is not whole "
                             f"{self.type_name} blocks")
        return n // be * bb


@dataclasses.dataclass
class GGUFFile:
    path: str
    metadata: dict[str, Any]
    tensors: dict[str, GGUFTensorInfo]
    data_offset: int

    def raw(self, name: str) -> np.ndarray:
        """The tensor's raw block bytes (memory-mapped, zero-copy)."""
        info = self.tensors[name]
        return np.memmap(self.path, np.uint8, "r",
                         offset=self.data_offset + info.offset,
                         shape=(info.nbytes,))

    def tensor_bytes(self, name: str, device) -> torch.Tensor:
        """The tensor's raw block bytes as a uint8 tensor on ``device``: one
        read of the file, then one copy to the device."""
        info = self.tensors[name]
        raw = np.fromfile(self.path, np.uint8, count=info.nbytes,
                          offset=self.data_offset + info.offset)
        if raw.size != info.nbytes:
            raise ValueError(f"{self.path}: {name} is cut short "
                             f"({raw.size} of {info.nbytes} bytes)")
        return torch.from_numpy(raw).to(device)

    def load(self, name: str):
        """Decode one tensor to planar oracle blocks (NumPy fields) or a
        float32 array."""
        info = self.tensors[name]
        return decode_tensor(self.raw(name), info.ggml_type, info.shape)


# ---------------------------------------------------------------------------
# low-level read
# ---------------------------------------------------------------------------

def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vt: int):
    if vt in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vt]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vt == _VT_STR:
        return _read_str(f)
    if vt == _VT_ARR:
        (et, n) = struct.unpack("<IQ", f.read(12))
        if et in _SCALAR_FMT:
            fmt = _SCALAR_FMT[et][1:]
            buf = f.read(struct.calcsize("<" + fmt) * n)
            return list(struct.unpack(f"<{n}{fmt}", buf)) if n else []
        return [_read_value(f, et) for _ in range(n)]
    raise ValueError(f"unknown GGUF value type {vt}")


def read_gguf(path: str) -> GGUFFile:
    """Parse the header, metadata and tensor directory (the data stays on
    disk, read per tensor)."""
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        if version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))

        metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (vt,) = struct.unpack("<I", f.read(4))
            metadata[key] = _read_value(f, vt)

        tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_str(f)
            (nd,) = struct.unpack("<I", f.read(4))
            ne = struct.unpack(f"<{nd}Q", f.read(8 * nd))
            ggml_type, offset = struct.unpack("<IQ", f.read(12))
            tensors[name] = GGUFTensorInfo(
                name=name, shape=tuple(reversed([int(x) for x in ne])),
                ggml_type=ggml_type, offset=int(offset))

        align = int(metadata.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
        data_offset = -(-f.tell() // align) * align
    return GGUFFile(path=path, metadata=metadata, tensors=tensors,
                    data_offset=data_offset)


# ---------------------------------------------------------------------------
# block codecs: GGML wire <-> planar oracle blocks
# ---------------------------------------------------------------------------

def _q4k_scale_unpack(s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """GGML get_scale_min_k4: [..., 12] packed bytes -> 6-bit sc, mn
    [..., 8] each (uint8)."""
    hi = s[..., 8:12]
    sc = torch.cat([s[..., 0:4] & 63,
                    (hi & 0x0F) | ((s[..., 0:4] >> 6) << 4)], -1)
    mn = torch.cat([s[..., 4:8] & 63,
                    (hi >> 4) | ((s[..., 4:8] >> 6) << 4)], -1)
    return sc, mn


def _q4k_scale_pack(sc: torch.Tensor, mn: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_q4k_scale_unpack`` (6-bit values, uint8)."""
    return torch.cat([
        (sc[..., :4] & 63) | ((sc[..., 4:] >> 4) << 6),
        (mn[..., :4] & 63) | ((mn[..., 4:] >> 4) << 6),
        (sc[..., 4:] & 0x0F) | ((mn[..., 4:] & 0x0F) << 4)], -1)


def _f16(cols: torch.Tensor) -> torch.Tensor:
    """[nb, 2] little-endian fp16 bytes -> f32 [nb]."""
    return cols.contiguous().view(torch.float16).reshape(-1).float()


def _f16_bytes(d: torch.Tensor) -> torch.Tensor:
    """f32 values (fp16-exact, as the oracle's) -> [nb, 2] fp16 bytes."""
    return d.reshape(-1, 1).to(torch.float16).view(torch.uint8)


def _numpy(t):
    """Decoded tensor(s) -> NumPy (an array, or blocks of NumPy fields)."""
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return dataclasses.replace(t, **{
        f.name: getattr(t, f.name).numpy() for f in dataclasses.fields(t)
        if f.name != "shape"})


def decode_tensor(raw, ggml_type: int, shape: tuple[int, ...]):
    """Raw GGML block bytes -> planar oracle blocks (``oracle/quant.py``'s
    Q8_0 / Q4_0 / Q4_K / Q6_K) or a float32 array. ``raw``: NumPy bytes,
    decoded on the CPU into NumPy fields, or a uint8 tensor, decoded where
    it lies into tensor fields."""
    shape = tuple(int(s) for s in shape)
    if isinstance(raw, torch.Tensor):
        return _decode(raw.reshape(-1), ggml_type, shape)
    b = torch.from_numpy(np.array(raw, np.uint8).reshape(-1))
    return _numpy(_decode(b, ggml_type, shape))


def _decode(b: torch.Tensor, ggml_type: int, shape: tuple[int, ...]):
    if ggml_type == GGML_F32:
        return b.view(torch.float32).reshape(shape)
    if ggml_type in (GGML_F16, GGML_BF16):
        dt = torch.float16 if ggml_type == GGML_F16 else torch.bfloat16
        return b.view(dt).reshape(shape).float()
    if ggml_type not in _BLOCK:
        raise ValueError(f"unsupported GGML type {ggml_type}")
    n = int(np.prod(shape)) if shape else 1
    be, bb = _BLOCK[ggml_type]
    blocks = b.reshape(n // be, bb)
    lead, k = shape[:-1], shape[-1]

    if ggml_type == GGML_Q8_0:
        qs = blocks[:, 2:].contiguous().view(torch.int8)
        return oq.Q8_0(qs=qs.reshape(shape),
                       d=_f16(blocks[:, :2]).reshape(*lead, k // 32),
                       shape=shape)
    if ggml_type == GGML_Q4_0:                  # lo = elem i, hi = i + 16
        return oq.Q4_0(qs=blocks[:, 2:].reshape(*lead, k // 2),
                       d=_f16(blocks[:, :2]).reshape(*lead, k // 32),
                       shape=shape)
    if ggml_type == GGML_Q4_K:
        sc, mn = _q4k_scale_unpack(blocks[:, 4:16])          # [nsb, 8]
        # per-64 chunk: byte i of chunk l -> elems 64l+i (lo), 64l+32+i (hi)
        w = blocks[:, 16:].reshape(-1, 4, 32)
        vals = torch.cat([w & 0x0F, w >> 4], -1).reshape(-1, 8, 32)
        qs = (vals[..., :16] | (vals[..., 16:] << 4)).reshape(*lead, k // 2)
        return oq.Q4_K(qs=qs, sc=sc.reshape(*lead, k // 32),
                       mn=mn.reshape(*lead, k // 32),
                       d=_f16(blocks[:, 0:2]).reshape(*lead, k // 256),
                       dmin=_f16(blocks[:, 2:4]).reshape(*lead, k // 256),
                       shape=shape)
    # Q6_K: element 32i + j of each 128-half holds bits (qh >> 2i) & 3 of
    # qh byte j over the low (i = 0, 1) or high (i = 2, 3) nibble of ql
    # byte j (i = 0, 2) or j + 32 (i = 1, 3)
    nsb = blocks.shape[0]
    ql = blocks[:, :128].reshape(nsb, 2, 64)
    qh = blocks[:, 128:192].reshape(nsb, 2, 32)
    lo, hi = ql & 0x0F, ql >> 4
    parts = (lo[..., :32], lo[..., 32:], hi[..., :32], hi[..., 32:])
    vals = torch.cat([p | (((qh >> (2 * i)) & 3) << 4)
                      for i, p in enumerate(parts)], -1)      # [nsb, 2, 128]
    sc = blocks[:, 192:208].contiguous().view(torch.int8)
    return oq.Q6_K(qs=vals.reshape(shape), sc=sc.reshape(*lead, k // 16),
                   d=_f16(blocks[:, 208:210]).reshape(*lead, k // 256),
                   shape=shape)


def _ggml_type(t) -> int:
    """The GGML type ``encode_tensor`` writes ``t`` as: F16 for an fp16
    array, F32 for any other float array (bf16 is widened, exactly), else
    the format of its oracle blocks."""
    if isinstance(t, np.ndarray):
        return GGML_F16 if t.dtype == np.float16 else GGML_F32
    if isinstance(t, torch.Tensor):
        return GGML_F16 if t.dtype == torch.float16 else GGML_F32
    return _NAME_TYPE[block_format(t)]


def encode_tensor(t) -> tuple[Any, int]:
    """Planar oracle blocks or a float array -> (raw bytes, ggml_type).
    NumPy in, NumPy uint8 bytes out (the reference's bytes for the same
    values); tensor fields in, a uint8 tensor out, encoded where they
    lie."""
    gt = _ggml_type(t)
    as_np = not isinstance(t if isinstance(t, (np.ndarray, torch.Tensor))
                           else t.qs, torch.Tensor)
    raw = _encode(t, gt)
    return (raw.numpy() if as_np else raw), gt


def _encode(t, gt: int) -> torch.Tensor:
    if gt in (GGML_F16, GGML_F32):
        x = _field(t)
        x = x if gt == GGML_F16 else x.float()
        return x.contiguous().reshape(-1).view(torch.uint8)
    n = int(np.prod(t.shape))
    qs, d = _field(t.qs), _field(t.d)
    if gt in (GGML_Q8_0, GGML_Q4_0):
        nb = n // 32
        payload = (qs.reshape(nb, 32).view(torch.uint8) if gt == GGML_Q8_0
                   else qs.reshape(nb, 16))
        return torch.cat([_f16_bytes(d), payload], 1).reshape(-1)
    nsb = n // 256
    if gt == GGML_Q4_K:
        p = qs.reshape(nsb, 8, 16)
        v64 = torch.cat([p & 0x0F, p >> 4], -1).reshape(nsb, 4, 64)
        wire = (v64[..., :32] | (v64[..., 32:] << 4)).reshape(nsb, 128)
        scales = _q4k_scale_pack(_field(t.sc).reshape(nsb, 8),
                                 _field(t.mn).reshape(nsb, 8))
        return torch.cat([_f16_bytes(d), _f16_bytes(_field(t.dmin)),
                          scales, wire], 1).reshape(-1)
    vals = qs.reshape(nsb, 2, 4, 32)             # [nsb, half, group, 32]
    lo4, hi2 = vals & 0x0F, vals >> 4
    ql = torch.cat([lo4[:, :, 0] | (lo4[:, :, 2] << 4),
                    lo4[:, :, 1] | (lo4[:, :, 3] << 4)], -1)
    qh = (hi2[:, :, 0] | (hi2[:, :, 1] << 2) | (hi2[:, :, 2] << 4)
          | (hi2[:, :, 3] << 6))
    sc = _field(t.sc).reshape(nsb, 16).view(torch.uint8)
    return torch.cat([ql.reshape(nsb, 128), qh.reshape(nsb, 64), sc,
                      _f16_bytes(d)], 1).reshape(-1)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _write_str(f: BinaryIO, s: str) -> None:
    b = s.encode("utf-8")
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _write_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<I", _VT_BOOL) + struct.pack("<?", v))
    elif isinstance(v, int):
        f.write(struct.pack("<I", _VT_U32 if 0 <= v < 2 ** 32 else _VT_I64))
        f.write(struct.pack("<I" if 0 <= v < 2 ** 32 else "<q", v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", _VT_F32) + struct.pack("<f", v))
    elif isinstance(v, str):
        f.write(struct.pack("<I", _VT_STR))
        _write_str(f, v)
    elif isinstance(v, (list, tuple)):
        f.write(struct.pack("<I", _VT_ARR))
        if v and isinstance(v[0], str):
            f.write(struct.pack("<IQ", _VT_STR, len(v)))
            for s in v:
                _write_str(f, s)
        elif v and isinstance(v[0], float):
            f.write(struct.pack("<IQ", _VT_F32, len(v)))
            f.write(struct.pack(f"<{len(v)}f", *v))
        else:
            f.write(struct.pack("<IQ", _VT_I32, len(v)))
            f.write(struct.pack(f"<{len(v)}i", *v))
    else:
        raise TypeError(f"cannot write metadata value {type(v)}")


def write_gguf(path: str, tensors: dict[str, Any],
               metadata: dict[str, Any] | None = None) -> None:
    """Write a GGUF v3 file. ``tensors`` values are float arrays or planar
    oracle blocks, NumPy or tensor fields (encoded to GGML wire blocks
    where they lie, one tensor at a time, so the host holds one tensor's
    bytes at once)."""
    metadata = dict(metadata or {})
    align = int(metadata.setdefault(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
    with open(path, "wb") as f:
        f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                            len(tensors), len(metadata)))
        for k, v in metadata.items():
            _write_str(f, k)
            _write_value(f, v)
        offset = 0
        for name, t in tensors.items():
            shape = tuple(int(s) for s in t.shape)
            gt = _ggml_type(t)
            _write_str(f, name)
            ne = tuple(reversed(shape))
            f.write(struct.pack("<I", len(ne)))
            f.write(struct.pack(f"<{len(ne)}Q", *ne))
            f.write(struct.pack("<IQ", gt, offset))
            nbytes = GGUFTensorInfo(name, shape, gt, offset).nbytes
            offset += -(-nbytes // align) * align
        f.write(b"\0" * ((-f.tell()) % align))
        for t in tensors.values():
            raw, _ = encode_tensor(t)
            data = raw.cpu().numpy() if isinstance(raw, torch.Tensor) else raw
            f.write(np.ascontiguousarray(data))
            f.write(b"\0" * ((-data.size) % align))


# ---------------------------------------------------------------------------
# llama.cpp's conventions: Q / K row order, the Q4_K_M mix
# ---------------------------------------------------------------------------

def _qk_order(n_rows: int, n_head: int, inverse: bool) -> np.ndarray:
    """Rows of llama.cpp's converter permute (convert_hf_to_gguf.py,
    ``LlamaModel.permute``: ``w.reshape(n_head, 2, hd / 2, K)
    .swapaxes(1, 2)``), which interleaves each head's two RoPE halves for
    GGML's adjacent-pair rotation: row i of the permuted weight is row
    order[i] of the original. ``inverse``: the order that undoes it."""
    hd = n_rows // n_head
    if hd * n_head != n_rows or hd % 2:
        raise ValueError(f"{n_rows} rows are not {n_head} heads of an even "
                         "width")
    split = (n_head, hd // 2, 2) if inverse else (n_head, 2, hd // 2)
    return np.arange(n_rows).reshape(split).swapaxes(1, 2).reshape(n_rows)


def _take_rows(t, order: np.ndarray):
    """Rows ``order`` of an [N, ...] array, tensor, or oracle blocks (each
    field's leading axis is N; a row move carries whole blocks, which run
    along K, so it is exact in every format)."""
    if isinstance(t, np.ndarray):
        return t[order]
    if isinstance(t, torch.Tensor):
        return t[torch.as_tensor(order, device=t.device)]
    return dataclasses.replace(t, **{
        f.name: _take_rows(getattr(t, f.name), order)
        for f in dataclasses.fields(t) if f.name != "shape"})


def permute_qk(t, n_head: int):
    """llama.cpp's converter permute of ``attn_q`` (``n_head`` = the query
    heads) or ``attn_k`` (the KV heads) rows, from the port's rotate-half
    order: what a writer of a llama.cpp-order file applies."""
    return _take_rows(t, _qk_order(t.shape[0], n_head, inverse=False))


def unpermute_qk(t, n_head: int):
    """The inverse of ``permute_qk``: what ``load_gguf`` applies."""
    return _take_rows(t, _qk_order(t.shape[0], n_head, inverse=True))


def use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama.cpp's rule (``llama-quant.cpp``) for the layers whose
    ``attn_v`` and ``ffn_down`` a Q4_K_M file keeps in Q6_K: the first and
    last eighth and every third layer between."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


def q4_k_m_format(name: str, n_layers: int) -> str:
    """The format of the 2-D weight ``name`` in a Q4_K_M-style llama file:
    q6_k for ``output.weight`` and for ``attn_v`` / ``ffn_down`` of the
    layers ``use_more_bits`` picks, q4_k for every other."""
    if name == "output.weight":
        return "q6_k"
    parts = name.split(".")
    if (parts[0] == "blk" and parts[2] in ("attn_v", "ffn_down")
            and use_more_bits(int(parts[1]), n_layers)):
        return "q6_k"
    return "q4_k"


# ---------------------------------------------------------------------------
# model assembly: GGUF -> the port's params
# ---------------------------------------------------------------------------

# llama.cpp tensor names -> params keys
_NAME_MAP = {
    "token_embd.weight": ("embed",),
    "output_norm.weight": ("final_norm",),
    "output.weight": ("lm_head",),
}
_LAYER_MAP = {
    "attn_q.weight": "wq", "attn_k.weight": "wk", "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w_gate", "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
    "attn_norm.weight": "attn_norm", "ffn_norm.weight": "mlp_norm",
    "ffn_gate_inp.weight": "router",
    "ffn_gate_exps.weight": "w_gate", "ffn_up_exps.weight": "w_up",
    "ffn_down_exps.weight": "w_down",
}
_NORMS = ("attn_norm", "mlp_norm", "final_norm")
_DENSE = (*_NORMS, "embed", "router")         # float tensors kept dense


def _expert_blocks(t, e: int):
    """Expert e's planar blocks of a stacked [E, N, K] tensor's (views)."""
    return dataclasses.replace(t, shape=tuple(t.shape[1:]), **{
        f.name: getattr(t, f.name)[e] for f in dataclasses.fields(t)
        if f.name != "shape"})


def config_from_metadata(md: dict[str, Any]) -> ModelConfig:
    """The port's ModelConfig from GGUF ``<arch>.*`` metadata (the same
    fields as the reference's)."""
    arch = md.get("general.architecture", "llama")
    g = lambda k, d=None: md.get(f"{arch}.{k}", d)
    n_heads = int(g("attention.head_count"))
    dim = int(g("embedding_length"))
    vocab = md.get(f"{arch}.vocab_size")
    if vocab is None:
        toks = md.get("tokenizer.ggml.tokens")
        vocab = len(toks) if toks else 32000
    return ModelConfig(
        name=md.get("general.name", arch),
        vocab_size=int(vocab),
        dim=dim,
        n_layers=int(g("block_count")),
        n_heads=n_heads,
        n_kv_heads=int(g("attention.head_count_kv", n_heads)),
        intermediate=int(g("feed_forward_length")),
        head_dim=int(g("attention.key_length", dim // n_heads)),
        rope_theta=float(g("rope.freq_base", 10000.0)),
        rms_eps=float(g("attention.layer_norm_rms_epsilon", 1e-5)),
        max_seq_len=int(g("context_length", 4096)),
        n_experts=int(g("expert_count", 0)),
        n_active_experts=int(g("expert_used_count", 2)),
    )


def _param_key(name: str, n_layers: int):
    """(params key, layer index or None) of a llama.cpp tensor name;
    (None, None) for a tensor the model does not take."""
    if name in _NAME_MAP:
        return _NAME_MAP[name][0], None
    if not name.startswith("blk."):
        return None, None
    _, idx, rest = name.split(".", 2)
    key = _LAYER_MAP.get(rest)
    if key is None or int(idx) >= n_layers:
        return None, None
    return key, int(idx)


def load_gguf(path: str, *, requantize: str | None = None,
              max_layers: int | None = None, device=None):
    """Load a llama.cpp GGUF checkpoint -> (params, ModelConfig), on the
    card unless ``device`` says otherwise.

    Each tensor's bytes are copied to the device and decoded there, then
    made a ``QuantLinear`` by ``from_oracle`` (q8_0 / q4_0 / q4_k / q6_k,
    no requantization: the Q6_K heads and ``attn_v`` / ``ffn_down`` of
    llama.cpp's *_K_M files run on the q6_k kernels), one tensor at a time:
    a 7B file never sits decoded in host memory. Norms are dense bf16;
    dense float linears bf16, or ``quantize(w, requantize)`` when set. A
    quantized ``token_embd`` becomes a dense bf16 ``embed``, its
    dequantization on the device; with no ``output.weight`` (tied) the
    head is the quantized copy. ``attn_q`` / ``attn_k`` rows are taken out
    of llama.cpp's order (``unpermute_qk``).

    As in the reference, the projections stay separate (``wq`` / ``wk`` /
    ``wv``, ``w_gate`` / ``w_up``): a loaded model decodes unfused, since
    the fused decode kernels need ``wqkv`` / ``w_gu``.

    A MoE file (``expert_count`` > 0) maps as the reference's:
    ``ffn_gate_inp`` -> ``router`` (dense bf16; it must be a float
    tensor) and ``ffn_{gate,up,down}_exps`` [E, N, K] -> the stacked
    ``w_gate`` / ``w_up`` / ``w_down``: float stacks dense bf16 (never
    requantized, as in the reference), quantized stacks decoded expert by
    expert and stacked by ``moe.stack_expert_quant``. The reference's
    ``from_oracle`` unpacks a 2-D shape and fails on a quantized stack: a
    fault not inherited (ROADMAP C.3.11).
    """
    device = resolve_device(device)
    gf = read_gguf(path)
    cfg = config_from_metadata(gf.metadata)
    if max_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers,
                                                    max_layers))
    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads}
    params: dict[str, Any] = {"layers": [{} for _ in range(cfg.n_layers)]}
    embed_blocks = None
    for name, info in gf.tensors.items():
        key, li = _param_key(name, cfg.n_layers)
        if key is None:
            continue
        raw = gf.tensor_bytes(name, device)
        if key in heads:
            raw = unpermute_qk(raw.reshape(info.shape[0], -1), heads[key])
        t = decode_tensor(raw, info.ggml_type, info.shape)
        if isinstance(t, torch.Tensor):
            dense = key in _DENSE or t.dim() != 2
            value = (quantize(t, requantize) if requantize and not dense
                     else t.to(torch.bfloat16))
        elif key in _NORMS or key == "router":
            raise ValueError(f"{path}: {name} is {info.type_name}; a norm "
                             "or router must be a float tensor")
        elif len(info.shape) == 3:
            value = moe.stack_expert_quant([
                from_oracle(_expert_blocks(t, e), device)
                for e in range(info.shape[0])])
        else:
            value = from_oracle(t, device)
            if key == "embed":
                embed_blocks = value
                value = dequantize(value, torch.bfloat16)
        (params if li is None else params["layers"][li])[key] = value
    if "lm_head" not in params and "embed" in params:
        # tied embeddings (llama.cpp omits output.weight then)
        params["lm_head"] = (embed_blocks if embed_blocks is not None
                             else params["embed"])
    return params, cfg


# ---------------------------------------------------------------------------
# the port's params -> a llama.cpp-style file
# ---------------------------------------------------------------------------

def _llama_metadata(cfg: ModelConfig, tokenizer=None) -> dict[str, Any]:
    """GGUF ``llama.*`` metadata of ``cfg`` (what ``config_from_metadata``
    reads back), with ``tokenizer``'s SPM vocabulary when one is given."""
    md = {
        "general.architecture": "llama", "general.name": cfg.name,
        "llama.block_count": cfg.n_layers,
        "llama.embedding_length": cfg.dim,
        "llama.attention.head_count": cfg.n_heads,
        "llama.attention.head_count_kv": cfg.n_kv_heads,
        "llama.feed_forward_length": cfg.intermediate,
        "llama.attention.key_length": cfg.head_dim,
        "llama.context_length": cfg.max_seq_len,
        "llama.vocab_size": cfg.vocab_size,
        "llama.rope.freq_base": float(cfg.rope_theta),
        "llama.attention.layer_norm_rms_epsilon": float(cfg.rms_eps),
    }
    if tokenizer is not None:
        md.update({
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": list(tokenizer.tokens),
            "tokenizer.ggml.scores": [float(x) for x in tokenizer.scores],
            "tokenizer.ggml.token_type": list(tokenizer.token_type),
            "tokenizer.ggml.bos_token_id": tokenizer.bos_id,
            "tokenizer.ggml.eos_token_id": tokenizer.eos_id,
            "tokenizer.ggml.unknown_token_id": tokenizer.unk_id,
            "tokenizer.ggml.add_space_prefix": tokenizer.add_space_prefix,
        })
    return md


def export_llama(path: str, params: dict[str, Any], cfg: ModelConfig,
                 tokenizer=None) -> None:
    """Write the port's dense llama ``params`` (``llama.init_weights``'
    tree, on any device) as a Q4_K_M-style GGUF file, as llama.cpp's
    converter and quantizer would: its tensor names and metadata,
    ``attn_q`` / ``attn_k`` rows in its order (``permute_qk``), norms F32,
    and every 2-D weight, the embedding included, quantized where it lies
    (``quantize_blocks``) to its ``q4_k_m_format``. ``tokenizer``: an
    ``SpmTokenizer`` whose vocabulary goes into the metadata."""
    names = {v: k.removesuffix(".weight") for k, v in _LAYER_MAP.items()
             if v != "router" and "_exps" not in k}      # the dense layer's
    heads = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads}
    dense = {"token_embd.weight": params["embed"],
             "output_norm.weight": params["final_norm"],
             "output.weight": params["lm_head"]}
    for i, layer in enumerate(params["layers"]):
        for key, w in layer.items():
            if key in heads:
                w = permute_qk(w, heads[key])
            dense[f"blk.{i}.{names[key]}.weight"] = w
    tensors = {name: w.float() if w.dim() == 1 else quantize_blocks(
        w, q4_k_m_format(name, cfg.n_layers)) for name, w in dense.items()}
    write_gguf(path, tensors, _llama_metadata(cfg, tokenizer))
