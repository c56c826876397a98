"""Multi-rank execution over ``torch.distributed``: the port of the
reference's ``parallel/`` (``shard_map`` programs over a JAX ``Mesh``).

Each rank is one process running the same program (``launch.run_spmd``); a
``mesh.Mesh`` names the axes of the rank array and the collectives of
``mesh`` take (mesh, axis name) where the reference takes an axis name.

- ``mesh``               the mesh, ``make_mesh`` and the collectives
- ``launch``             ``run_spmd``: spawn, rendezvous, results, timeout
- ``ring_attention``     ring and Ulysses attention, context-parallel decode
- ``tp``                 Megatron tensor parallelism (+ data)
- ``collective_matmul``  all-gather / reduce-scatter matmuls as ring hops
- ``pipeline``           GPipe microbatched layer stages
- ``full``               the 5-axis (data, pipe, seq, model, expert) step
- ``multihost``          process-group bootstrap, host-aware meshes
"""

from ggml_cuda_experiments_tpu_torch.parallel.mesh import make_mesh
