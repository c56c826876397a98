"""Device mesh and the collectives the reference names, over
``torch.distributed``.

Port of the reference's ``parallel/mesh.py``. There a ``Mesh`` names the axes
of a device array and ``shard_map`` runs one program per device, whose
collectives take an axis name. Here each rank of the default process group
is one process running the same program; a ``Mesh`` lays the ranks out as an
array with named axes and holds one process group per axis line (the ranks
that differ only in that axis's coordinate). Where the reference calls
``jax.lax.psum(x, "model")`` inside ``shard_map``, the port calls
``psum(x, mesh, "model")`` on every rank.

The backend is the process group's, chosen explicitly when it is made
(``parallel/launch.py`` ``run_spmd``, ``parallel/multihost.py``
``init_distributed``): ``nccl`` takes one card per rank; ``gloo`` takes any
number of ranks on one card or on the CPU. On a gloo group a CUDA tensor is
staged through host memory inside each collective: copied to the CPU,
reduced or sent there, and copied back. That is correct at any size and
measures no interconnect. Floating reductions run in f32 (bf16 inputs are
widened first and rounded once at the end).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")


class Mesh:
    """Ranks of the default process group as an array with named axes.

    ``devices``: an integer array of global ranks, one dimension per name
    of ``axis_names``, each rank at most once (a mesh over some ranks of
    the group: a rank outside it has no coordinates). Every rank of the
    group builds the same meshes in the same order: making the per-axis
    groups is itself a collective."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized process group "
                               "(launch.run_spmd or "
                               "multihost.init_distributed)")
        arr = np.asarray(devices, dtype=np.int64)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of rank {arr.ndim} for axes "
                             f"{axis_names}")
        flat = arr.ravel().tolist()
        if len(set(flat)) != len(flat) or not all(
                0 <= r < dist.get_world_size() for r in flat):
            raise ValueError(f"mesh ranks {flat}: each rank of the group "
                             "at most once")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.backend = dist.get_backend()
        if self.backend not in BACKENDS:
            raise ValueError(f"backend {self.backend!r}: one of {BACKENDS}")
        self.rank = dist.get_rank()
        hit = np.nonzero(arr == self.rank)
        self.coords = ({a: int(c[0]) for a, c in zip(self.axis_names, hit)}
                       if len(hit[0]) else {})
        # one group per axis line; every rank creates every group, in order
        self._lines: dict[str, tuple[object, list[int]]] = {}
        for ax, name in enumerate(self.axis_names):
            lines = np.moveaxis(arr, ax, -1).reshape(-1, arr.shape[ax])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.new_group(ranks, backend=self.backend)
                         if len(ranks) > 1 else None)
                if self.rank in ranks:
                    self._lines[name] = (group, ranks)

    def line(self, axis: str) -> tuple[object, list[int]]:
        """(process group, global ranks by axis index) of this rank's line
        along ``axis``; the group is None for an axis of size 1."""
        if axis not in self._lines:
            raise ValueError(f"no axis {axis!r} in {self.axis_names}")
        return self._lines[axis]


def make_mesh(model: int = 1, data: int | None = None) -> Mesh:
    """A (data, model) mesh over the ranks of the default group: rank
    r = data_index * model + model_index, so the model axis runs over
    consecutive ranks."""
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"data {data} x model {model} != {world} ranks")
    return Mesh(np.arange(world).reshape(data, model), ("data", "model"))


# ---------------------------------------------------------------------------
# collectives (the jax.lax names; call on every rank of the axis line)
# ---------------------------------------------------------------------------

def axis_size(mesh: Mesh, axis: str) -> int:
    return len(mesh.line(axis)[1])


def axis_index(mesh: Mesh, axis: str) -> int:
    mesh.line(axis)                     # raises for an unknown axis
    return mesh.coords[axis]


def _staged(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """x as the backend takes it: contiguous, and on the host for gloo."""
    if mesh.backend == "gloo" and x.device.type != "cpu":
        return x.detach().to("cpu").contiguous()
    return x.detach().contiguous()


def _widened(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.is_floating_point() and x.element_size() < 4 else x


def _all_reduce(x, mesh, axis, op):
    group, _ = mesh.line(axis)
    if group is None:
        return x.clone()
    buf = _staged(mesh, _widened(x))
    if buf.data_ptr() == x.data_ptr():
        buf = buf.clone()
    dist.all_reduce(buf, op=op, group=group)
    return buf.to(device=x.device, dtype=x.dtype)


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of x over the ranks of ``axis`` (every rank gets it)."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Elementwise max of x over the ranks of ``axis``."""
    return _all_reduce(x, mesh, axis, dist.ReduceOp.MAX)


def _exchange(mesh: Mesh, axis: str, sends, recvs) -> None:
    """Point-to-point: sends [(axis index, tensor)], recvs [(axis index,
    buffer)], all in flight at once (``batch_isend_irecv``)."""
    group, ranks = mesh.line(axis)
    ops = [dist.P2POp(dist.isend, t, ranks[j], group) for j, t in sends]
    ops += [dist.P2POp(dist.irecv, t, ranks[j], group) for j, t in recvs]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm) -> torch.Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) axis
    indices; a rank that is no destination gets zeros."""
    n, me = axis_size(mesh, axis), axis_index(mesh, axis)
    perm = [(int(s) % n, int(d) % n) for s, d in perm]
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"perm {perm}: one destination and one source a "
                         "rank")
    if dst == [me]:
        return x.clone()
    buf = _staged(mesh, x)
    out = torch.empty_like(buf) if src else None
    _exchange(mesh, axis, [(dst[0], buf)] if dst else [],
              [(src[0], out)] if src else [])
    if out is None:
        return torch.zeros_like(x)
    return out.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, *, dim: int = 0,
               tiled: bool = False) -> torch.Tensor:
    """``jax.lax.all_gather``: the ranks' x in axis order, stacked on a new
    ``dim`` or, ``tiled``, concatenated along ``dim``."""
    group, ranks = mesh.line(axis)
    if group is None:
        parts = [x]
    else:
        buf = _staged(mesh, x)
        parts = [torch.empty_like(buf) for _ in ranks]
        dist.all_gather(parts, buf, group=group)
        parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: x cut into n blocks along
    ``split_axis``, block j sent to axis index j; the blocks received are
    concatenated along ``concat_axis`` in source order."""
    n, me = axis_size(mesh, axis), axis_index(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of {tuple(x.shape)} not "
                         f"divisible by {n}")
    blocks = [_staged(mesh, b) for b in x.chunk(n, split_axis)]
    got = [None] * n
    got[me] = blocks[me]
    recvs = [(j, torch.empty_like(blocks[j])) for j in range(n) if j != me]
    _exchange(mesh, axis, [(j, blocks[j]) for j in range(n) if j != me],
              recvs)
    for j, b in recvs:
        got[j] = b
    return torch.cat([b.to(x.device) for b in got], concat_axis)


def transport(mesh: Mesh, device) -> str:
    """How a collective moves tensors of ``device`` on this mesh."""
    dev = torch.device(device)
    if mesh.backend == "gloo":
        return ("gloo, host-staged (device -> host copy, gloo over the "
                "host, copy back)" if dev.type == "cuda" else "gloo, host")
    return "nccl, device to device"
