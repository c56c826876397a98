"""Multi-host execution: the process-group bootstrap, host-aware meshes and
per-host serving.

Port of the reference's ``parallel/multihost.py``. There one process drives
each host's chips and ``jax.distributed`` joins the processes; here every
rank is a process, and a host is a group of ranks named by the launcher
(``launch.run_spmd(..., hosts=)`` or the ``GCT_HOST_ID`` variable of any
other launcher).

- ``init_distributed``: ``torch.distributed.init_process_group`` with an
  explicit backend and rendezvous.
- ``group_devices_by_process``: host id -> the ranks on it (each rank's
  ``RankDevice``: its global rank ``id`` and its host ``process_index``,
  the attribute names of a JAX device).
- ``make_pod_mesh``: a (data, model) mesh whose model lines stay inside one
  host, so the per-token psums of tensor parallelism never leave it.
- ``HostShardedEngine``: one ``Engine`` per host over the host's model
  group; admission is host-local.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch.distributed as dist

from ggml_cuda_experiments_tpu_torch.parallel.mesh import BACKENDS, Mesh
from ggml_cuda_experiments_tpu_torch.parallel import launch


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str,
                     timeout: float = 300.0) -> None:
    """Join this process to a ``num_processes``-rank group as rank
    ``process_id`` over ``backend`` ("gloo" or "nccl"; never chosen here).
    ``coordinator_address``: "host:port" (TCP rendezvous) or an init URL
    ("tcp://...", "file://..."). A no-op when ``num_processes`` is None
    (no distributed run); unlike the reference, one process still makes a
    group of one, which the collectives need."""
    if num_processes is None:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if coordinator_address is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address and "
                         "process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """One rank as the placement logic sees it."""
    id: int                   # global rank
    process_index: int        # its host


def host_id() -> int:
    """This rank's host, as the launcher numbered it (0 without one)."""
    return int(os.environ.get(launch.HOST_ENV, "0"))


def devices() -> list[RankDevice]:
    """Every rank of the group with its host (an all-gather)."""
    hosts = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, host_id())
    return [RankDevice(r, h) for r, h in enumerate(hosts)]


def group_devices_by_process(devices_=None) -> dict[int, list]:
    """Stable host -> devices map (``devices()`` unless given)."""
    devs = list(devices_ if devices_ is not None else devices())
    groups: dict[int, list] = {}
    for d in devs:
        groups.setdefault(d.process_index, []).append(d)
    return dict(sorted(groups.items()))


def pod_layout(model_parallel: int | None = None, devices_=None
               ) -> np.ndarray:
    """The [data, model] array of devices of ``make_pod_mesh``: each row
    a model group of ``model_parallel`` devices of one host (default: all
    of a host's), rows enumerating (host, group). Raises on uneven hosts."""
    groups = group_devices_by_process(devices_)
    per_host = {p: len(ds) for p, ds in groups.items()}
    n_local = min(per_host.values())
    if n_local != max(per_host.values()):
        raise ValueError(f"uneven ranks per host: {per_host}")
    if model_parallel is None:
        model_parallel = n_local
    if n_local % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} must divide the "
                         f"ranks of a host ({n_local})")
    rows = [ds[g * model_parallel:(g + 1) * model_parallel]
            for ds in groups.values()
            for g in range(n_local // model_parallel)]
    arr = np.empty((len(rows), model_parallel), dtype=object)
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            arr[i, j] = d
    return arr


def make_pod_mesh(model_parallel: int | None = None, devices_=None) -> Mesh:
    """(data, model) mesh with the model axis inside each host."""
    arr = pod_layout(model_parallel, devices_)
    ranks = np.vectorize(lambda d: d.id, otypes=[np.int64])(arr)
    return Mesh(ranks, ("data", "model"))


def host_mesh(model: int) -> Mesh:
    """The (data, model) mesh of this rank's host: its ranks in order,
    ``model`` to a row. Every rank makes every host's mesh (a collective),
    and keeps its own."""
    mine = None
    for ds in group_devices_by_process().values():
        ranks = [d.id for d in ds]
        m = Mesh(np.asarray(ranks).reshape(-1, model), ("data", "model"))
        if m.coords:
            mine = m
    return mine


class HostShardedEngine:
    """Serving across hosts: one local Engine per host over the host's
    model-parallel group, each host's batch independent.

    Every rank constructs it with the same arguments; ``make_local_engine(
    host, mesh)`` builds the rank's part of its host's engine."""

    def __init__(self, make_local_engine, mesh: Mesh):
        self.mesh = mesh
        self.process_id = host_id()
        self.engine = make_local_engine(self.process_id, mesh)

    def add_request(self, prompt, **kw):
        return self.engine.add_request(prompt, **kw)

    def step(self):
        return self.engine.step()

    def run_to_completion(self, **kw):
        return self.engine.run_to_completion(**kw)
