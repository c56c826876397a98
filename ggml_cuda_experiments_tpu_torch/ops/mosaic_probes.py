"""The JAX package's Mosaic probes (``tools/probe_mosaic_r3.py``) as
kernels of the port (``csrc/mosaic_probes.cu``), one wrapper each, each
with its plain version:

- ``transpose_dot(x, e)``: x^T e (the probe contracts dim 0 of x [32, 128]
  with an eye [32, 32]: a transpose by a product);
- ``lane_concat(x)``: x [128, 128] -> [32, 128], four 32-row blocks' first
  32 lanes side by side;
- ``roll64(x)``: x [R, 128] rolled by 64 along the lanes;
- ``dyn_sublane(x)``: 2 x, each 8-row slice written by the block whose
  index selects it;
- ``lane_extract(x)``: x [1, 4096] as 32 rows of 128;
- ``read_output(x)``: (3 x + 1, 3 x) through a value written in one step
  and read back in the next;
- ``tiny_call(x)``: x * 1.0001, the kernel whose launch cost
  ``tools/probe_mosaic_r3.py`` measures eager and in a CUDA graph.

Each was a limit of the TPU's Mosaic compiler (the JAX tool asks whether it
lowers at all); Hopper has none of them. Each result is exact against
NumPy. A wrapper runs its plain version for a CPU tensor and launches its
kernel, or raises, for a CUDA tensor; launches are counted in
``LAUNCHES``.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

PROBES = ("transpose_dot", "lane_concat", "roll64", "dyn_sublane",
          "lane_extract", "read_output", "tiny_call")
LAUNCHES = {f"mosaic_{p}": 0 for p in PROBES}


def _launch(name: str, x: torch.Tensor, out_shape, e=None, two=False):
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"{name}: x contiguous f32 2-D, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if e is not None and (e.dtype != torch.float32 or e.device != x.device
                          or not e.is_contiguous() or e.dim() != 2):
        raise ValueError(f"{name}: e contiguous f32 2-D on x's device")
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    out2 = torch.empty_like(x) if two else None
    rc = _build.lib().mosaic_probe(
        PROBES.index(name), x.data_ptr(), 0 if e is None else e.data_ptr(),
        out.data_ptr(), 0 if out2 is None else out2.data_ptr(), x.shape[0],
        x.shape[1], 0 if e is None else e.shape[1], _build.stream_of(x))
    _build.check(rc, f"mosaic_probe {name}")
    LAUNCHES[f"mosaic_{name}"] += 1
    return (out, out2) if two else out


def transpose_dot(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x^T e for x [R, C], e [R, C2] (f32)."""
    if not kernels_for(x):
        return x.T @ e
    if e.shape[0] != x.shape[0]:
        raise ValueError("transpose_dot: x and e need the same rows")
    return _launch("transpose_dot", x, (x.shape[1], e.shape[1]), e)


def lane_concat(x: torch.Tensor) -> torch.Tensor:
    """x [128, 128] -> [32, 128]: out[:, 32c:32c+32] = x[32c:32c+32, :32]."""
    if not kernels_for(x):
        return torch.cat([x[32 * c:32 * (c + 1), :32] for c in range(4)], 1)
    return _launch("lane_concat", x, (32, 128))


def roll64(x: torch.Tensor) -> torch.Tensor:
    """x [R, 128] rolled by 64 lanes."""
    if not kernels_for(x):
        return torch.roll(x, 64, dims=1)
    return _launch("roll64", x, tuple(x.shape))


def dyn_sublane(x: torch.Tensor) -> torch.Tensor:
    """2 x, for x [8 m, C], slice by slice."""
    if not kernels_for(x):
        return x * 2.0
    return _launch("dyn_sublane", x, tuple(x.shape))


def lane_extract(x: torch.Tensor) -> torch.Tensor:
    """x [1, 4096] -> [32, 128], row h = x[0, 128h : 128h + 128]."""
    if not kernels_for(x):
        return x.reshape(32, 128).clone()
    return _launch("lane_extract", x, (32, 128))


def read_output(x: torch.Tensor):
    """(3 x + 1, 3 x): the second written in step 0, read back in step 1."""
    if not kernels_for(x):
        s = x * 3.0
        return s + 1.0, s
    return _launch("read_output", x, tuple(x.shape), two=True)


def tiny_call(x: torch.Tensor) -> torch.Tensor:
    """x * 1.0001 (f32)."""
    if not kernels_for(x):
        return x * 1.0001
    return _launch("tiny_call", x, tuple(x.shape))
