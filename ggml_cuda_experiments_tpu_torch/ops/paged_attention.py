"""Paged-KV decode: single-token attention over a shared page pool.

Port of the reference's ``ops/paged_attention.py`` (``paged_decode`` and its
``_paged_kernel``). The KV cache lives in a pool of pages, page-major across
heads, ``[(L,) n_pages, Hkv, page_size, D]``; each sequence owns a row of
page indices. Pages are bf16, or int8 / fp8 (e4m3) with f32 per-token
scales ``[(L,) n_pages, Hkv, page_size]`` that multiply the score row (k)
and the probability row (v). With a 5-D pool, ``layer`` picks the layer by a
pointer offset in the kernel: no layer slice of the pool is ever copied.

The CUDA kernel (``csrc/paged_attention.cu``) is one launch a call over a
grid of (sequence, KV head) x splits: each CTA takes a split of its
sequence's valid 64-key tiles (``flash_decode.split_tiles``' rule, the
count from ``flash_decode.pick_splits`` over pages_per_seq * page_size),
reading the lengths and the page table on the card, so a launch needs no
host value from them and a captured graph replays with new lengths. With
more than one split, the last CTA of each (sequence, KV head) merges the
splits' partials in split order through a ticket (``_tickets``: one int32
a (sequence, KV head) up to the kernel's limit of ``MAX_HEAD_ROWS``, made
once a device outside any graph capture and never replaced, left 0 by the
kernel; two streams must not run ``paged_decode`` at once). The plain
version with ``kv_splits`` gathers the pages and follows the same
partition (``flash_decode._partials_ref`` + ``_merge_ref``).
``pages_per_compute_block`` is the reference's DMA block (pages per grid
step); it is validated as there, and the kernel stages 64 keys at a time
whatever its value.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.flash_decode import (
    _merge_ref, _partials_ref, _sm_count, pick_splits)
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"paged_decode": 0}

_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_MAX_GROUP = 16            # query heads per KV head the kernel takes
MAX_HEAD_ROWS = 65535      # B * Hkv the kernel takes (its grid's y)


def _args(q, k_pages, v_pages, page_indices, k_scale_pages, v_scale_pages,
          pages_per_compute_block, layer):
    """Validate the reference's contract; returns (pages_per_seq, layer)."""
    layered = k_pages.dim() == 5
    if layered != (layer is not None):
        raise ValueError("pass `layer` iff the page pools carry a leading "
                         "layer dimension")
    if k_pages.shape != v_pages.shape or k_pages.dim() not in (4, 5):
        raise ValueError(f"k/v pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)}")
    layer = int(layer) if layered else 0
    if not 0 <= layer < (k_pages.shape[0] if layered else 1):
        raise ValueError(f"layer {layer} out of range")
    Hkv = k_pages.shape[-3]
    B, Hq, D = q.shape
    if Hq % Hkv or k_pages.shape[-1] != D:
        raise ValueError(f"q {tuple(q.shape)} against pages "
                         f"{tuple(k_pages.shape)}")
    quantized = k_scale_pages is not None
    if (v_scale_pages is not None) != quantized:
        raise ValueError("pass both scale pools or neither")
    if quantized != (k_pages.dtype in (torch.int8, torch.float8_e4m3fn)):
        raise ValueError(f"{k_pages.dtype} pages need scale pools iff they "
                         "are int8 or fp8")
    pps = page_indices.shape[1]
    ppcb = min(pages_per_compute_block, pps)
    if pps % ppcb:
        raise ValueError(f"pages_per_seq {pps} % {ppcb} != 0")
    return pps, layer


def paged_decode_ref(q, k_pages, v_pages, lengths, page_indices, *,
                     k_scale_pages=None, v_scale_pages=None, scale=None,
                     pages_per_compute_block=4, layer=None, kv_splits=1):
    """Plain version: gather each sequence's pages, then the kernel's
    partition of its first ``lengths[b]`` keys into ``kv_splits`` spans of
    whole 64-key tiles, an f32 softmax partial a span (p * v_scale kept in
    f32), merged in split order. Same arguments as ``paged_decode``;
    returns [B, Hq, D] in q's dtype."""
    _, layer = _args(q, k_pages, v_pages, page_indices, k_scale_pages,
                     v_scale_pages, pages_per_compute_block, layer)
    if k_pages.dim() == 5:
        k_pages, v_pages = k_pages[layer], v_pages[layer]
        if k_scale_pages is not None:
            k_scale_pages = k_scale_pages[layer]
            v_scale_pages = v_scale_pages[layer]
    B, Hq, D = q.shape
    n_pages, Hkv, ps, _ = k_pages.shape
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    pages = page_indices.long().clamp(max=n_pages - 1)       # [B, P]
    P = pages.shape[1]

    def seq(pool):                      # [B, Hkv, P * ps, ...]
        g = pool[pages]                                      # [B, P, Hkv, ps..]
        return g.transpose(1, 2).reshape(B, Hkv, P * ps, *pool.shape[3:])

    ks = vs = None
    if k_scale_pages is not None:
        ks, vs = seq(k_scale_pages), seq(v_scale_pages)
    parts = _partials_ref(q, seq(k_pages), seq(v_pages), lengths, scale,
                          kv_splits, ks, vs, round_pv=False)
    return _merge_ref(parts, q.dtype)


# one ticket a (sequence, KV head) a device for the kernel's last-CTA merge
# (the kernel leaves each 0); made once at the kernel's limit, so a graph
# captured at any batch keeps a live buffer whatever is called after it
_TICKETS: dict[int, torch.Tensor] = {}


def _tickets(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("paged_decode: call it once outside a CUDA "
                               "graph capture first (its tickets are made "
                               "then)")
        t = _TICKETS[device.index] = torch.zeros(
            MAX_HEAD_ROWS, dtype=torch.int32, device=device)
    return t


def paged_decode(q, k_pages, v_pages, lengths, page_indices, *,
                 k_scale_pages=None, v_scale_pages=None, scale=None,
                 pages_per_compute_block=4, layer=None):
    """Single-token attention over a paged KV cache.

    q: [B, Hq, D] bf16; k/v_pages: [n_pages, Hkv, page_size, D], or the
    whole per-layer pool [L, n_pages, Hkv, page_size, D] with ``layer``;
    bf16, int8 or float8_e4m3fn. lengths: [B] int32 valid keys (>= 1);
    page_indices: [B, pages_per_seq] int32. k/v_scale_pages: f32
    [(L,) n_pages, Hkv, page_size] for int8 / fp8 pages. On the card the
    kernel splits each sequence's keys over ``pick_splits(B, Hkv,
    pages_per_seq * page_size, SMs)`` CTAs; B * Hkv <= ``MAX_HEAD_ROWS``.
    Returns [B, Hq, D] bf16."""
    if not kernels_for(q):
        return paged_decode_ref(
            q, k_pages, v_pages, lengths, page_indices,
            k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
            scale=scale, pages_per_compute_block=pages_per_compute_block,
            layer=layer)
    pps, layer = _args(q, k_pages, v_pages, page_indices, k_scale_pages,
                       v_scale_pages, pages_per_compute_block, layer)
    B, Hq, D = q.shape
    n_pages, Hkv, ps = k_pages.shape[-4:-1]
    kind = _KINDS.get(k_pages.dtype)
    if kind is None or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"pages: bf16, int8 or float8_e4m3fn, got "
                         f"{k_pages.dtype} / {v_pages.dtype}")
    if D not in (64, 128) or Hq // Hkv > _MAX_GROUP \
            or B * Hkv > MAX_HEAD_ROWS:
        raise ValueError(f"paged_decode kernel: D in (64, 128), Hq/Hkv <= "
                         f"{_MAX_GROUP}, B * Hkv <= {MAX_HEAD_ROWS} (got "
                         f"D={D}, B={B}, Hq={Hq}, Hkv={Hkv})")
    tensors = [("q", q, torch.bfloat16, (B, Hq, D)),
               ("lengths", lengths, torch.int32, (B,)),
               ("page_indices", page_indices, torch.int32, (B, pps)),
               ("k_pages", k_pages, k_pages.dtype, tuple(k_pages.shape)),
               ("v_pages", v_pages, k_pages.dtype, tuple(k_pages.shape))]
    if kind:
        for name, t in (("k_scale_pages", k_scale_pages),
                        ("v_scale_pages", v_scale_pages)):
            tensors.append((name, t, torch.float32, tuple(k_pages.shape[:-1])))
    for name, t, dt, shape in tensors:
        if t.device != q.device or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dt} {shape} on "
                             f"{q.device}, got {t.dtype} {tuple(t.shape)}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("page pools must be 16-byte aligned")
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    n = pick_splits(B, Hkv, pps * ps, _sm_count(q.device.index or 0))
    out = torch.empty_like(q)
    part = tickets = None
    if n > 1:
        part = torch.empty(B * Hq * n * (D + 2), dtype=torch.float32,
                           device=q.device)
        tickets = _tickets(q.device)
    rc = _build.lib().paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale_pages.data_ptr() if kind else None,
        v_scale_pages.data_ptr() if kind else None,
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        part.data_ptr() if n > 1 else None,
        tickets.data_ptr() if n > 1 else None,
        B, Hq, Hkv, n_pages, ps, D, pps, layer, n, kind, scale,
        _build.stream_of(q))
    _build.check(rc, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out
