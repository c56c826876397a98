"""The `.tensor` golden-file format: one tensor a file, read and written.

The port's own copy of the JAX package's ``utils/tensor_io.py``, with the
same wire format (little-endian):

    int32 n_dims | int32 dtype | int32 ne[n_dims] | int32 name_len
    | name bytes | raw data

dtype codes: 0 f32, 1 f16 (the two llama.cpp's dumps use), 2 bf16, 3 int8.
bf16 goes through ``torch.bfloat16`` (NumPy has no bf16, and the H100
machine has no ``ml_dtypes``), so a file written by either package reads
the same bytes in the other.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch

_DTYPES = {0: torch.float32, 1: torch.float16, 2: torch.bfloat16,
           3: torch.int8}
_CODES = {v: k for k, v in _DTYPES.items()}


def save_tensor(path, arr, name: str = "") -> None:
    """Write ``arr`` (a tensor on any device, or a NumPy array of f32, f16
    or int8) with ``name``."""
    t = torch.as_tensor(arr).detach().cpu().contiguous()
    code = _CODES.get(t.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype {t.dtype}; use f32/f16/bf16/"
                         "int8")
    name_b = name.encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", t.dim(), code))
        f.write(struct.pack(f"<{t.dim()}i", *t.shape))
        f.write(struct.pack("<i", len(name_b)))
        f.write(name_b)
        f.write(t.reshape(-1).view(torch.uint8).numpy().tobytes())


def load_tensor(path) -> tuple[torch.Tensor, str]:
    """Read a `.tensor` file: (a CPU tensor of the file's dtype, name)."""
    data = Path(path).read_bytes()
    n_dims, code = struct.unpack_from("<ii", data, 0)
    if not (0 < n_dims <= 4):
        raise ValueError(f"bad n_dims {n_dims} in {path}")
    if code not in _DTYPES:
        raise ValueError(f"bad dtype code {code} in {path}")
    ne = struct.unpack_from(f"<{n_dims}i", data, 8)
    off = 8 + 4 * n_dims
    (name_len,) = struct.unpack_from("<i", data, off)
    off += 4
    name = data[off:off + name_len].decode(errors="replace")
    off += name_len
    dtype = _DTYPES[code]
    nbytes = int(np.prod(ne)) * dtype.itemsize
    raw = np.frombuffer(data, np.uint8, count=nbytes, offset=off).copy()
    return torch.from_numpy(raw).view(dtype).reshape(ne), name
