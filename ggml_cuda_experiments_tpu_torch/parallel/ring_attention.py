"""Context parallelism: ring attention (prefill), Ulysses attention, and the
LSE-merged context-parallel decode.

Port of the reference's ``parallel/ring_attention.py``; each function runs
on every rank of a mesh axis with the sequence dimension sharded over it
(block-contiguous: rank i holds positions [i * S_loc, (i + 1) * S_loc)).

- ``ring_attention``: K / V blocks rotate around the axis (``ppermute``)
  while each rank runs ``flash_attention`` with its lse residual on the
  block in front of it, folding the per-step partials with ``lse_combine``.
  Under causality the diagonal block runs the kernel's causal mode and a
  block from an earlier rank runs unmasked; a block from a later rank is
  wholly in the future and launches nothing (the reference masks it with an
  additive -inf block, lse = -inf: the identity of the merge).
- ``ulysses_attention``: two all-to-alls re-shard heads <-> sequence, so
  each rank runs ``flash_attention`` on all positions of H / n heads.
- ``decode_context_parallel``: each rank's ``flash_decode`` partial over its
  KV shard, merged by ``lse_combine_axis`` (a pmax and two psums).
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops.flash_attention import flash_attention
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
from ggml_cuda_experiments_tpu_torch.ops.lse import (
    AttnPartial, lse_combine, lse_combine_axis, lse_finalize)
from ggml_cuda_experiments_tpu_torch.parallel.mesh import (
    Mesh, all_to_all, axis_index, axis_size, ppermute)


def _partial_from_residuals(o: torch.Tensor, lse: torch.Tensor
                            ) -> AttnPartial:
    """(normalized o in q's dtype, lse) -> the (o, m = lse, s = 1) partial
    (o_unnorm = o * s with s = exp(lse - m) = 1); s = 0 where lse = -inf."""
    m = lse[..., None]
    return AttnPartial(o.float(), m, (m != -torch.inf).float())


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Mesh, axis_name: str, *, causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Ring attention over sequence-sharded q / k / v [B, H(kv), S_loc, D]
    (the global sequence is the concatenation over ``axis_name``). causal:
    global causal masking (query i attends key j <= i). Returns the local
    output shard [B, Hq, S_loc, D] in q's dtype."""
    n, me = axis_size(mesh, axis_name), axis_index(mesh, axis_name)
    B, H, S_loc, D = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    acc = AttnPartial(
        torch.zeros((B, H, S_loc, D), dtype=torch.float32, device=q.device),
        torch.full((B, H, S_loc, 1), -torch.inf, device=q.device),
        torch.zeros((B, H, S_loc, 1), device=q.device))
    k_blk, v_blk = k, v
    for step in range(n):
        src = (me - step) % n                   # owner of the current block
        # under causality a block from a later rank is wholly in the
        # future: no launch; the diagonal block is the kernel's causal case
        if not causal or src <= me:
            o, lse = flash_attention(q, k_blk, v_blk, scale=scale,
                                     causal=causal and src == me,
                                     return_residuals=True)
            acc = lse_combine(acc, _partial_from_residuals(o, lse))
        if step != n - 1:
            # send the block on to the right neighbour
            k_blk = ppermute(k_blk, mesh, axis_name, perm)
            v_blk = ppermute(v_blk, mesh, axis_name, perm)
    return lse_finalize(acc, out_dtype=q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh: Mesh, axis_name: str, *, causal: bool = False,
                      scale: float | None = None) -> torch.Tensor:
    """Ulysses sequence parallelism: [B, H, S_loc, D] in and out, heads
    divisible by the axis size. Two all-to-alls put all positions of H / n
    heads on each rank around one ``flash_attention``."""
    n = axis_size(mesh, axis_name)
    if q.shape[1] % n or k.shape[1] % n:
        raise ValueError(f"Ulysses needs heads {q.shape[1]} / {k.shape[1]} "
                         f"divisible by the axis size {n}")

    def to_heads(x):
        # [B, H, S_loc, D] -> [B, H / n, S, D]: split heads, join sequence
        return all_to_all(x, mesh, axis_name, 1, 2).contiguous()

    o2 = flash_attention(to_heads(q), to_heads(k), to_heads(v),
                         causal=causal, scale=scale)
    # back to sequence sharding: split sequence, join heads
    return all_to_all(o2, mesh, axis_name, 2, 1).contiguous()


def decode_context_parallel(q: torch.Tensor, k_shard: torch.Tensor,
                            v_shard: torch.Tensor,
                            lengths_local: torch.Tensor, mesh: Mesh,
                            axis_name: str, *, scale: float | None = None,
                            kv_splits: int | None = None) -> torch.Tensor:
    """Context-parallel single-token decode. q [B, Hq, D] the same on
    every rank of the axis; k / v_shard this rank's [B, Hkv, S_loc, D]
    slice of the cache; lengths_local [B] int32 the valid tokens within the
    shard. Returns [B, Hq, D] in q's dtype, the same on every rank."""
    part = flash_decode(q, k_shard, v_shard, lengths_local, scale=scale,
                        kv_splits=kv_splits, return_partial=True)
    return lse_finalize(lse_combine_axis(part, mesh, axis_name),
                        out_dtype=q.dtype)
