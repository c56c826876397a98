"""Staging and reduction primitives: ``stage_pad``, ``grid_sum`` and
``lane_reduce``.

The JAX package keeps these three Pallas kernels inside its tests
(``tests/test_dma.py::_stage_kernel``, ``tests/test_reductions.py::
_gridsum_kernel`` and ``_lane_reduce_kernel``), the analogs of the
reference's ``memcpy_async`` staging and its warp / block reductions. The
port gives them a module, so that they can be launched and measured, and
one kernel file, ``csrc/primitives.cu``:

- ``stage_pad(x, dpad)``: x [R, D] -> [R, dpad] with zeros in [D, dpad),
  copied through shared memory with 16-byte ``cp.async`` (the JAX kernel's
  HBM -> VMEM async copy). Exact.
- ``grid_sum(x)``: the sum of every element of x [n, d], as a 0-d tensor of
  x's dtype (int32 or f32), in one launch: x streamed flat in 16-byte
  vectors, a partial a CTA, and the CTA that finishes last folding the
  partials in index order (the JAX kernel accumulates its (1, d) partial
  row across grid steps and sums it outside). int32 is exact; f32 gives the
  same bits on every run.
- ``lane_reduce(x)``: (max [n, 1], sum [n, 1]) of x [n, d] in x's dtype
  (f32 or bf16, summed in f32), one warp per row with shuffle trees. The
  max is exact.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel, or raises, for a CUDA tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"stage_pad": 0, "grid_sum": 0, "lane_reduce": 0}
_SUM_KIND = {torch.int32: 0, torch.float32: 1}
_REDUCE_KIND = {torch.float32: 0, torch.bfloat16: 1}


def _check_2d(name: str, x: torch.Tensor, kinds=None) -> None:
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"{name}: a non-empty 2-D tensor, got "
                         f"{tuple(x.shape)}")
    if kinds is not None and x.dtype not in kinds:
        raise ValueError(f"{name}: dtype among {tuple(kinds)}, got {x.dtype}")


def _check_kernel_input(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def stage_pad_ref(x: torch.Tensor, dpad: int = 128) -> torch.Tensor:
    """Plain version: zero-pad the last dim of x [R, D] to ``dpad``."""
    _check_2d("stage_pad", x)
    if x.shape[1] > dpad:
        raise ValueError(f"stage_pad: D = {x.shape[1]} > dpad = {dpad}")
    return F.pad(x, (0, dpad - x.shape[1]))


def stage_pad(x: torch.Tensor, dpad: int = 128) -> torch.Tensor:
    """x [R, D], D <= dpad -> [R, dpad], zeros in [D, dpad)."""
    if not kernels_for(x):
        return stage_pad_ref(x, dpad)
    _check_2d("stage_pad", x)
    _check_kernel_input("stage_pad", x)
    R, D = x.shape
    if D > dpad:
        raise ValueError(f"stage_pad: D = {D} > dpad = {dpad}")
    out = torch.empty((R, dpad), dtype=x.dtype, device=x.device)
    es = x.element_size()
    rc = _build.lib().stage_pad(x.data_ptr(), out.data_ptr(), R, D * es,
                                dpad * es, _build.stream_of(x))
    _build.check(rc, "stage_pad")
    LAUNCHES["stage_pad"] += 1
    return out


def grid_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the sum of x [n, d] as a 0-d tensor of x's dtype."""
    _check_2d("grid_sum", x, _SUM_KIND)
    return x.sum(dtype=x.dtype)


# one ticket a device for grid_sum's last-CTA merge (the kernel leaves it 0)
_TICKETS: dict[int, torch.Tensor] = {}


def _ticket(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("grid_sum: call it once outside a CUDA graph "
                               "capture first (its ticket is made then)")
        t = _TICKETS[device.index] = torch.zeros(1, dtype=torch.int32,
                                                 device=device)
    return t


def grid_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every element of x [n, d] (int32 or f32), 0-d, x's
    dtype. One launch, whose last CTA merges the partials through a ticket
    kept a device: two streams must not run grid_sum at once."""
    if not kernels_for(x):
        return grid_sum_ref(x)
    _check_2d("grid_sum", x, _SUM_KIND)
    _check_kernel_input("grid_sum", x)
    lib = _build.lib()
    count = x.numel()
    part = torch.empty(lib.grid_sum_blocks(count), dtype=x.dtype,
                       device=x.device)
    total = torch.empty((), dtype=x.dtype, device=x.device)
    rc = lib.grid_sum(x.data_ptr(), part.data_ptr(),
                      _ticket(x.device).data_ptr(), total.data_ptr(), count,
                      _SUM_KIND[x.dtype], _build.stream_of(x))
    _build.check(rc, "grid_sum")
    LAUNCHES["grid_sum"] += 1
    return total


def lane_reduce_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per-row (max, sum) of x [n, d], each [n, 1] in x's
    dtype (the sum taken in f32)."""
    _check_2d("lane_reduce", x, _REDUCE_KIND)
    return (x.amax(dim=1, keepdim=True),
            x.float().sum(dim=1, keepdim=True).to(x.dtype))


def lane_reduce(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row (max [n, 1], sum [n, 1]) of x [n, d] (f32 or bf16)."""
    if not kernels_for(x):
        return lane_reduce_ref(x)
    _check_2d("lane_reduce", x, _REDUCE_KIND)
    _check_kernel_input("lane_reduce", x)
    n, d = x.shape
    mx = torch.empty((n, 1), dtype=x.dtype, device=x.device)
    sm = torch.empty((n, 1), dtype=x.dtype, device=x.device)
    rc = _build.lib().lane_reduce(x.data_ptr(), mx.data_ptr(), sm.data_ptr(),
                                  n, d, _REDUCE_KIND[x.dtype],
                                  _build.stream_of(x))
    _build.check(rc, "lane_reduce")
    LAUNCHES["lane_reduce"] += 1
    return mx, sm
