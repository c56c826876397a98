"""Collective matmul: all-gather / reduce-scatter decomposed into ring hops
around per-chunk products.

Port of the reference's ``parallel/collective_matmul.py``. Each function
runs on every rank of a mesh axis; the ring hops are ``ppermute`` and the
chunk products ``torch.matmul`` in f32 (in the reference they are
``jax.lax.dot_general`` outside any Pallas kernel). The reference's point is
the overlap of hop s + 1 with product s that XLA's scheduler finds; eager
PyTorch runs them in program order, so here the decomposition is the same
arithmetic, not an overlap.

- ``matmul_ag(x_shard, w_local)``: ``all_gather(x) @ w_local^T``, x
  row-sharded [Bs, K], w column-parallel [N_loc, K] -> [Bs * n, N_loc].
- ``matmul_rs(x, w_local)``: ``reduce_scatter(x @ w_local^T)`` over rows,
  x [B, K_loc], w row-parallel [N, K_loc] -> rows of [B / n, N].
- ``sp_mlp_block``: the sequence-parallel SwiGLU MLP (Megatron-SP) made of
  the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ggml_cuda_experiments_tpu_torch.parallel.mesh import (
    Mesh, axis_index, axis_size, ppermute)


def _ring_perm(n: int, reverse: bool = False):
    if reverse:
        return [(i, (i - 1) % n) for i in range(n)]
    return [(i, (i + 1) % n) for i in range(n)]


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [M, K] . w [N, K]^T in f32."""
    return x.float() @ w.float().T


def matmul_ag(x_shard: torch.Tensor, w_local: torch.Tensor, mesh: Mesh,
              axis_name: str) -> torch.Tensor:
    """``all_gather(x_shard) @ w_local^T`` with the gather as ring hops.
    x_shard [Bs, K] (this rank's rows of x [Bs * n, K]); w_local
    [N_loc, K]. Returns [Bs * n, N_loc] f32."""
    n, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    bs = x_shard.shape[0]
    out = torch.zeros((bs * n, w_local.shape[0]), dtype=torch.float32,
                      device=x_shard.device)
    perm = _ring_perm(n, reverse=True)   # receive from i + 1: the chunk
    chunk = x_shard                      # owners walk forward in row order
    for s in range(n):
        nxt = ppermute(chunk, mesh, axis_name, perm) if s < n - 1 else None
        owner = (idx + s) % n            # whose rows we hold
        out[owner * bs:(owner + 1) * bs] = _dot(chunk, w_local)
        chunk = nxt
    return out


def matmul_rs(x: torch.Tensor, w_local: torch.Tensor, mesh: Mesh,
              axis_name: str) -> torch.Tensor:
    """``reduce_scatter(x @ w_local^T)`` over output rows, each chunk's
    partial product made at the ring step that adds it. x [B, K_loc]
    (B % n == 0); w_local [N, K_loc]. Returns rows idx * B / n ..
    (idx + 1) * B / n of the reduced product, [B / n, N] f32."""
    n, idx = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by axis size {n}")
    bc = b // n
    perm = _ring_perm(n)

    def chunk_dot(t):
        return _dot(x[t * bc:(t + 1) * bc], w_local)

    # acc starts at rank i aimed at chunk i - 1; after n - 1 forward hops
    # it reaches its owner holding all n partials
    acc = chunk_dot((idx - 1) % n)
    for s in range(1, n):
        acc = ppermute(acc, mesh, axis_name, perm)
        acc = acc + chunk_dot((idx - 1 - s) % n)
    return acc


def sp_mlp_block(x_shard: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor, mesh: Mesh,
                 axis_name: str) -> torch.Tensor:
    """Sequence-parallel SwiGLU MLP: token-sharded [Ts, d] in and out;
    w_gate / w_up column-parallel [I_loc, d], w_down row-parallel
    [d, I_loc]. Equal to the replicated MLP with a psum."""
    gate = matmul_ag(x_shard, w_gate, mesh, axis_name)      # [T, I_loc]
    up = matmul_ag(x_shard, w_up, mesh, axis_name)
    h = (F.silu(gate) * up).to(x_shard.dtype)
    return matmul_rs(h, w_down, mesh, axis_name)            # [Ts, d]
