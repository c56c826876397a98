"""Run one program on every rank: the port's counterpart of ``shard_map``'s
"this function on every device".

``run_spmd(fn, world, backend, device, timeout, args)`` spawns ``world``
processes (the spawn start method: each child is a fresh interpreter that
imports the port and ``fn``'s module, nothing of the parent's state), joins
them into one process group through a ``file://`` rendezvous in a fresh
temporary directory (so concurrent runs never share a port), calls
``fn(*args)`` on each and returns the ranks' results in rank order. Tensors
in a result come back on the host, by value.

A rank that raises, exits, or is still running at ``timeout`` seconds fails
the whole call: every rank is then killed and the call raises with the
failing rank's traceback. Nothing is retried, and the backend is never
changed: ``nccl`` needs a card per rank (refused otherwise), ``gloo`` runs
any number of ranks on one card (``device="cuda"``: every rank on card 0,
their collectives staged through host memory) or on the CPU.

``hosts`` splits the ranks into that many equal consecutive groups and
tells each rank its group (``multihost.host_id``): the launcher's host ids,
by which ``multihost.make_pod_mesh`` keeps the model axis inside a host.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch

from ggml_cuda_experiments_tpu_torch.parallel.mesh import BACKENDS
from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda

HOST_ENV = "GCT_HOST_ID"          # the launcher's host id of a rank


def _to_host(obj):
    """obj with every tensor in it moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):   # NamedTuple
        return type(obj)(*(_to_host(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def loaded_modules(*imports: str) -> list[str]:
    """The modules this process has imported once it has imported
    ``imports`` (a rank's, for the check that no rank of the port imports
    jax or the JAX package)."""
    import importlib
    import sys
    for name in imports:
        importlib.import_module(name)
    return sorted(sys.modules)


def _rank_main(fn, args, rank, world, backend, device, init_method,
               timeout, hosts, out):
    try:
        os.environ[HOST_ENV] = str(rank // (world // hosts))
        if device == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank if backend == "nccl" else 0)
        from ggml_cuda_experiments_tpu_torch.parallel import multihost
        multihost.init_distributed(init_method, world, rank, backend=backend,
                                   timeout=timeout)
        try:
            result = _to_host(fn(*args))
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
        # plain pickle: the result travels by value (multiprocessing's own
        # pickler would share tensors with a process about to exit)
        out.put((rank, True, pickle.dumps(result)))
    except BaseException:                       # reported, then re-raised
        out.put((rank, False, traceback.format_exc()))
        raise


def run_spmd(fn, world: int, backend: str, device: str | None = None,
             timeout: float = 300.0, args: tuple = (), hosts: int = 1
             ) -> list:
    """``fn(*args)`` on ``world`` ranks over a ``backend`` process group;
    returns the results in rank order. ``fn`` must be importable by name
    (a module-level function). ``device``: "cuda" or "cpu"; None is the
    card (raising without one), as every entry point of the port."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if device is None:
        device = require_cuda().type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if backend == "nccl" and (device != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(f"nccl takes one card per rank: {world} ranks, "
                         f"{torch.cuda.device_count()} cards")
    if world < 1 or world % hosts:
        raise ValueError(f"{world} ranks over {hosts} hosts")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="gct_spmd_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, world, backend, device,
                               init_method, timeout, hosts, out))
             for r in range(world)]
    results: dict[int, object] = {}
    failure = None
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < world and failure is None:
            try:
                rank, ok, payload = out.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    failure = (f"rank {dead[0]} exited with code "
                               f"{procs[dead[0]].exitcode} and no result")
                elif time.monotonic() > deadline:
                    failure = (f"timeout: {world - len(results)} of {world} "
                               f"ranks still running after {timeout} s")
                continue
            if ok:
                results[rank] = pickle.loads(payload)
            else:
                failure = f"rank {rank} raised:\n{payload}"
        if failure is None:
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    failure = f"a rank exited with code {p.exitcode}"
    finally:
        for p in procs:
            if p.pid is None:                  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5)
        out.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_spmd({getattr(fn, '__name__', fn)}, "
                           f"world={world}, {backend}, {device}): {failure}")
    return [results[r] for r in range(world)]
