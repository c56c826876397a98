"""Prefill RoPE + head-major repack (batch-1 prompt processing).

Port of the reference's ``ops/prefill_fuse.py`` (``rope_pack_prefill`` and
its ``_rope_pack_kernel``). One pass over the wqkv GEMM output emits q, k and
v in the head-major layout that flash attention and the cache take, with
rotate-half RoPE applied in f32 on the way:

    y [T, (Hq + 2 Hkv) D]  ->  qT [Hq, T, D], kT [Hkv, T, D], vT [Hkv, T, D]

The cos/sin tables are made in PyTorch, as the reference's wrapper makes
them (``rope_tables``), and handed to the kernel (``csrc/rope_pack.cu``),
which rounds each product and the sum on their own: kernel and plain
version agree bit for bit, and both equal ``models.llama.rope`` followed by
the transposes. They depend on the positions alone, so a prefill makes them
once and hands them to every layer's call (``tables=``); without them the
function makes its own.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"rope_pack": 0}
# calls of rope_tables (every device): one a prefill on the model's path
BUILDS = {"rope_tables": 0}


def rope_tables(positions: torch.Tensor, D: int, theta: float):
    """C = [cos | cos], S2 = [-sin | sin], f32 [T, D] on positions' device,
    for rotate-half at ``positions`` [T]."""
    BUILDS["rope_tables"] += 1
    freqs = theta ** (-torch.arange(0, D // 2, dtype=torch.float32,
                                    device=positions.device) / (D // 2))
    ang = positions.float()[:, None] * freqs                  # [T, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return (torch.cat([cos, cos], dim=1).contiguous(),
            torch.cat([-sin, sin], dim=1).contiguous())


def _split(y, n_heads, n_kv_heads, head_dim):
    T, width = y.shape
    if width != (n_heads + 2 * n_kv_heads) * head_dim or head_dim % 2:
        raise ValueError(f"y {tuple(y.shape)} for heads {n_heads}/"
                         f"{n_kv_heads} x {head_dim}")
    return T


def _tables(tables, positions, T, D, theta, device):
    """The given (C, S2), checked (contiguous f32 [T, D] on ``device``), or
    rope_tables at ``positions``."""
    if tables is None:
        return rope_tables(positions, D, theta)
    C, S2 = tables
    for name, t in (("C", C), ("S2", S2)):
        if t.dtype != torch.float32 or tuple(t.shape) != (T, D) \
                or t.device != device or not t.is_contiguous():
            raise ValueError(f"tables: {name} must be contiguous f32 "
                             f"[{T}, {D}] on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    return C, S2


def rope_pack_prefill_ref(y, positions, *, n_heads, n_kv_heads, head_dim,
                          rope_theta=10000.0, tables=None):
    """Plain version: same arguments and outputs as ``rope_pack_prefill``."""
    T = _split(y, n_heads, n_kv_heads, head_dim)
    D, nr = head_dim, n_heads + n_kv_heads
    C, S2 = _tables(tables, positions, T, D, rope_theta, y.device)
    x = y[:, :nr * D].float().reshape(T, nr, D)
    r = x * C[:, None] + torch.roll(x, D // 2, dims=-1) * S2[:, None]
    r = r.to(torch.bfloat16).transpose(0, 1)                  # [nr, T, D]
    v = y[:, nr * D:].reshape(T, n_kv_heads, D).transpose(0, 1)
    return (r[:n_heads].contiguous(), r[n_heads:].contiguous(),
            v.to(torch.bfloat16).contiguous())


def rope_pack_prefill(y, positions, *, n_heads, n_kv_heads, head_dim,
                      rope_theta=10000.0, tables=None):
    """y [T, (Hq + 2 Hkv) D] bf16, positions [T] int -> (qT [Hq, T, D] and
    kT [Hkv, T, D] roped, vT [Hkv, T, D]), all bf16. ``tables``: (C, S2) of
    ``rope_tables(positions, D, rope_theta)``, made once for the layers of
    one prefill; made here when not given. The kernel takes D a multiple of
    16 and y on 16 bytes."""
    if not kernels_for(y):
        return rope_pack_prefill_ref(
            y, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta, tables=tables)
    T = _split(y, n_heads, n_kv_heads, head_dim)
    if y.dtype != torch.bfloat16 or not y.is_contiguous():
        raise ValueError(f"y: need contiguous bf16, got {y.dtype}")
    if positions.shape != (T,) or positions.device != y.device:
        raise ValueError(f"positions: need [{T}] on {y.device}")
    D = head_dim
    if D % 16 or D > 4096 or y.data_ptr() % 16:
        raise ValueError(f"rope_pack: the kernel takes head_dim a multiple "
                         f"of 16 up to 4096 and y on 16 bytes (D = {D})")
    C, S2 = _tables(tables, positions, T, D, rope_theta, y.device)
    if (C.data_ptr() | S2.data_ptr()) % 16:
        raise ValueError("rope_pack: the tables must start on 16 bytes")
    new = y.new_empty
    q = new((n_heads, T, D))
    k = new((n_kv_heads, T, D))
    v = new((n_kv_heads, T, D))
    rc = _build.lib().rope_pack(
        y.data_ptr(), C.data_ptr(), S2.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), T, n_heads, n_kv_heads, D,
        _build.stream_of(y))
    _build.check(rc, "rope_pack")
    LAUNCHES["rope_pack"] += 1
    return q, k, v
