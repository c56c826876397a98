"""The GCTC checkpoint container: a parameter tree in one file, read lazily.

The port's counterpart of the JAX package's ``utils/loader.py``, with its
framing (little-endian):

    magic "GCTC" | u32 version | u32 n_tensors | u64 data_offset
    n_tensors x { u16 name_len | name | u8 dtype | u8 ndim | u32 ne[ndim]
                  | u64 offset | u64 nbytes }
    ...data blobs (64-byte aligned)...

dtype codes: 0 f32, 1 f16, 2 bf16 (through ``torch.bfloat16``), 3 int8,
4 uint8, 5 int32. A tree flattens to one entry a leaf, named by its path
(``layers.3.attn_norm``), and a ``QuantLinear`` to one entry a field,
``<path>#<fmt>+logical#<N>x<K>#<field>``, so no side manifest is needed; a
q4_k weight in the s6 encoding names its format ``q4_k~s6`` (the JAX
package's v3 token), as in ``<path>#q4_k~s6+logical#<N>x<K>#es``.

Dense entries are the JAX package's both ways: same framing, codes,
alignment and names, and a tree with no quantized leaf is written as
version 5, which the JAX reader takes. Quantized entries differ: the port
stores its ``QuantLinear`` fields in logical column order (``qs``, ``d``,
``es``, ``em``, ``qh``), the ``+logical`` layout token in each name, in a
version 6 file, which the JAX reader refuses. A JAX file's quantized
entries hold the JAX device layout (interleaved lanes, the v4 signed
nibbles of q6_k ``qh``, the v5 segment-local q6_k order); the port refuses
them (re-quantize from the source weights) and never misreads them.

Format history (the JAX package's v2-v5, then the port's):
  v2-v5: the JAX package's (its ``utils/loader.py``); dense entries read
         unchanged here
  v6:    quantized entries in the port's logical order (``+logical``)
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import QuantLinear
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

_MAGIC = b"GCTC"
_DENSE_VERSION = 5          # the JAX package's current version
_VERSION = 6
_DTYPES = {0: torch.float32, 1: torch.float16, 2: torch.bfloat16,
           3: torch.int8, 4: torch.uint8, 5: torch.int32}
_CODES = {v: k for k, v in _DTYPES.items()}
_ALIGN = 64
_LAYOUT = "logical"

_QFIELDS = ("qs", "d", "es", "em", "qh")


# ---------------------------------------------------------------------------
# container read / write
# ---------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    return torch.as_tensor(a).detach()


def save_container(path, tensors: dict[str, Any]) -> None:
    """Write named tensors (any device) or NumPy arrays; each is copied to
    the host in turn, so the host holds one entry at a time."""
    tensors = {name: _tensor(a) for name, a in tensors.items()}
    version = (_VERSION if any("#" in name for name in tensors)
               else _DENSE_VERSION)
    body = bytearray()
    offsets, offset = [], 0
    for name, t in tensors.items():
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")
        offset = -(-offset // _ALIGN) * _ALIGN
        name_b = name.encode()
        nbytes = t.numel() * t.element_size()
        body += struct.pack("<H", len(name_b)) + name_b
        body += struct.pack("<BB", _CODES[t.dtype], t.dim())
        body += struct.pack(f"<{t.dim()}I", *t.shape)
        body += struct.pack("<QQ", offset, nbytes)
        offsets.append(offset)
        offset += nbytes
    head = _MAGIC + struct.pack("<II", version, len(tensors))
    data_offset = -(-(len(head) + 8 + len(body)) // _ALIGN) * _ALIGN
    with open(path, "wb") as f:
        f.write(head)
        f.write(struct.pack("<Q", data_offset))
        f.write(body)
        for off, t in zip(offsets, tensors.values()):
            f.seek(data_offset + off)
            f.write(t.cpu().contiguous().reshape(-1).view(torch.uint8)
                    .numpy())


def load_container(path, lazy: bool = True) -> dict[str, torch.Tensor]:
    """Read a container into CPU tensors; with ``lazy`` they are views of
    a copy-on-write map of the file (pages read when touched)."""
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != _MAGIC:
            raise ValueError(f"{path} is not a GCTC container")
        version, n = struct.unpack("<II", head[4:12])
        if version not in (2, 3, 4, 5, _VERSION):
            raise ValueError(f"{path}: unsupported GCTC version {version}")
        (data_offset,) = struct.unpack("<Q", f.read(8))
        entries = []
        for _ in range(n):
            (nl,) = struct.unpack("<H", f.read(2))
            name = f.read(nl).decode()
            code, ndim = struct.unpack("<BB", f.read(2))
            shape = struct.unpack(f"<{ndim}I", f.read(4 * ndim))
            off, nbytes = struct.unpack("<QQ", f.read(16))
            entries.append((name, code, shape, off, nbytes))
    foreign = [name for name, *_ in entries
               if "#" in name and _layout(name) != _LAYOUT]
    if foreign:
        raise ValueError(
            f"{path} (version {version}) holds quantized tensors in the JAX "
            f"package's device layout ({foreign[0]}: interleaved lanes, its "
            "q6_k packing); the port reads only its own logical-order "
            "fields -- re-quantize from the source weights")
    buf = (np.memmap(path, np.uint8, mode="c") if lazy
           else np.fromfile(path, np.uint8))
    out = {}
    for name, code, shape, off, nbytes in entries:
        start = data_offset + off
        raw = torch.from_numpy(buf[start:start + nbytes])
        out[name] = raw.view(_DTYPES[code]).reshape(shape)
    return out


def _layout(name: str) -> str:
    """The layout token of a quantized entry's name ('std' when none)."""
    _, fmt, _, _ = name.split("#")
    return fmt.partition("+")[2] or "std"


# ---------------------------------------------------------------------------
# param tree <-> flat tensors
# ---------------------------------------------------------------------------

def _flatten(prefix: str, node, out: dict[str, torch.Tensor]) -> None:
    if isinstance(node, dict):
        for key, sub in node.items():
            _flatten(f"{prefix}.{key}" if prefix else key, sub, out)
    elif isinstance(node, (list, tuple)):
        for i, sub in enumerate(node):
            _flatten(f"{prefix}.{i}", sub, out)
    elif isinstance(node, QuantLinear):
        n, k = node.shape
        fmt = node.fmt if node.enc == "e" else f"{node.fmt}~{node.enc}"
        base = f"{prefix}#{fmt}+{_LAYOUT}#{n}x{k}"
        for f in _QFIELDS:
            a = getattr(node, f)
            if a is not None:
                out[f"{base}#{f}"] = a
    elif isinstance(node, (torch.Tensor, np.ndarray)):
        out[prefix] = node
    elif node is not None:
        raise TypeError(f"{prefix}: cannot store a {type(node).__name__} "
                        "(save the tree before permute_hidden_params)")


def save_params(path, params: dict[str, Any]) -> None:
    flat: dict[str, Any] = {}
    _flatten("", params, flat)
    save_container(path, flat)


def _set_path(tree: dict, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for i, p in enumerate(parts[:-1]):
        nxt = parts[i + 1]
        if p.isdigit():
            p = int(p)
            while len(node) <= p:
                node.append({})
            if not isinstance(node[p], (dict, list)):
                node[p] = [] if nxt.isdigit() else {}
            node = node[p]
        else:
            default = [] if nxt.isdigit() else {}
            node = node.setdefault(p, default)
    last = parts[-1]
    if last.isdigit():
        last = int(last)
        while len(node) <= last:
            node.append(None)
    node[last] = value


def _to(tree, device):
    """``tree`` with every tensor (and QuantLinear field) on ``device``."""
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    if isinstance(tree, QuantLinear):
        return dataclasses.replace(tree, **{
            f: getattr(tree, f).to(device) for f in _QFIELDS
            if getattr(tree, f) is not None})
    return tree.to(device)


def load_params(path, mesh=None, device=None) -> dict[str, Any]:
    """Rebuild a parameter tree on ``device`` (the card unless named).
    With ``mesh``, each rank keeps its tensor-parallel slice
    (``parallel/tp.shard_params``), cut from the mapped file before it is
    copied, so a rank reads only its shard's bytes."""
    device = resolve_device(device)
    tree: dict[str, Any] = {}
    quants: dict[str, dict] = {}
    for name, t in load_container(path).items():
        if "#" in name:
            prefix, fmt, shape_s, field = name.split("#")
            if prefix not in quants:           # keep the saved key order
                _set_path(tree, prefix, None)
                fmt, _, enc = fmt.partition("+")[0].partition("~")
                quants[prefix] = {
                    "fmt": fmt, "enc": enc or "e",
                    "shape": tuple(int(v) for v in shape_s.split("x"))}
            quants[prefix][field] = t
        else:
            _set_path(tree, name, t)
    for prefix, q in quants.items():
        _set_path(tree, prefix, QuantLinear(**q))
    if mesh is not None:
        from ggml_cuda_experiments_tpu_torch.parallel import tp
        tree = tp.shard_params(tree, mesh)
    return _to(tree, device)
