"""Prefill RoPE + head-major repack (batch-1 prompt processing).

Port of the reference's ``ops/prefill_fuse.py`` (``rope_pack_prefill`` and
its ``_rope_pack_kernel``). One pass over the wqkv GEMM output emits q, k and
v in the head-major layout that flash attention and the cache take, with
rotate-half RoPE applied in f32 on the way:

    y [T, (Hq + 2 Hkv) D]  ->  qT [Hq, T, D], kT [Hkv, T, D], vT [Hkv, T, D]

The cos/sin tables are made here in PyTorch, as the reference's wrapper
makes them, and handed to the kernel (``csrc/rope_pack.cu``), which rounds
each product and the sum on their own: kernel and plain version agree bit
for bit, and both equal ``models.llama.rope`` followed by the transposes.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"rope_pack": 0}


def _rope_tables(positions: torch.Tensor, D: int, theta: float):
    """C = [cos | cos], S2 = [-sin | sin], f32 [T, D], for rotate-half."""
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


def rope_pack_prefill_ref(y, positions, *, n_heads, n_kv_heads, head_dim,
                          rope_theta=10000.0):
    """Plain version: same arguments and outputs as ``rope_pack_prefill``."""
    T = _split(y, n_heads, n_kv_heads, head_dim)
    D, nr = head_dim, n_heads + n_kv_heads
    C, S2 = _rope_tables(positions, D, rope_theta)
    x = y[:, :nr * D].float().reshape(T, nr, D)
    r = x * C[:, None] + torch.roll(x, D // 2, dims=-1) * S2[:, None]
    r = r.to(torch.bfloat16).transpose(0, 1)                  # [nr, T, D]
    v = y[:, nr * D:].reshape(T, n_kv_heads, D).transpose(0, 1)
    return (r[:n_heads].contiguous(), r[n_heads:].contiguous(),
            v.to(torch.bfloat16).contiguous())


def rope_pack_prefill(y, positions, *, n_heads, n_kv_heads, head_dim,
                      rope_theta=10000.0):
    """y [T, (Hq + 2 Hkv) D] bf16, positions [T] int -> (qT [Hq, T, D] and
    kT [Hkv, T, D] roped, vT [Hkv, T, D]), all bf16."""
    if not kernels_for(y):
        return rope_pack_prefill_ref(
            y, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
            head_dim=head_dim, rope_theta=rope_theta)
    T = _split(y, n_heads, n_kv_heads, head_dim)
    if y.dtype != torch.bfloat16 or not y.is_contiguous():
        raise ValueError(f"y: need contiguous bf16, got {y.dtype}")
    if positions.shape != (T,) or positions.device != y.device:
        raise ValueError(f"positions: need [{T}] on {y.device}")
    D = head_dim
    C, S2 = _rope_tables(positions, D, rope_theta)
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
