"""Paged-KV decode: single-token attention over a shared page pool.

Port of the reference's ``ops/paged_attention.py`` (``paged_decode`` and its
``_paged_kernel``). The KV cache lives in a pool of pages, page-major across
heads, ``[(L,) n_pages, Hkv, page_size, D]``; each sequence owns a row of
page indices. Pages are bf16, or int8 / fp8 (e4m3) with f32 per-token
scales ``[(L,) n_pages, Hkv, page_size]`` that multiply the score row (k)
and the probability row (v). With a 5-D pool, ``layer`` picks the layer by a
pointer offset in the kernel: no layer slice of the pool is ever copied.

The CUDA kernel (``csrc/paged_attention.cu``) runs one CTA per (sequence,
KV head) and reads the lengths and the page table from device memory, so a
launch needs no host value from them. ``pages_per_compute_block`` is the
reference's DMA block (pages per grid step); it is validated as there, and
the kernel stages 64 keys at a time whatever its value.
"""

from __future__ import annotations

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for

LAUNCHES = {"paged_decode": 0}

_KINDS = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_MAX_GROUP = 16            # query heads per KV head the kernel takes


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
                     pages_per_compute_block=4, layer=None):
    """Plain version: gather each sequence's pages, then one f32 softmax
    over its first ``lengths[b]`` keys. Same arguments as ``paged_decode``;
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
    G = Hq // Hkv
    if scale is None:
        scale = float(1.0 / D ** 0.5)
    pages = page_indices.long().clamp(max=n_pages - 1)       # [B, P]
    P = pages.shape[1]

    def seq(pool):                      # [B, Hkv, P * ps, ...] f32
        g = pool[pages].float()                              # [B, P, Hkv, ps..]
        return g.transpose(1, 2).reshape(B, Hkv, P * ps, *pool.shape[3:])

    k, v = seq(k_pages), seq(v_pages)
    s = torch.einsum("bhgd,bhsd->bhgs", q.float().reshape(B, Hkv, G, D), k)
    if k_scale_pages is not None:
        s = s * (seq(k_scale_pages) * scale)[:, :, None, :]
    else:
        s = s * scale
    valid = torch.arange(P * ps, device=q.device)[None] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, -torch.inf)
    m = s.amax(-1, keepdim=True)
    p = torch.where(m == -torch.inf, 0.0, torch.exp(s - m))
    l = p.sum(-1, keepdim=True)
    if v_scale_pages is not None:
        p = p * seq(v_scale_pages)[:, :, None, :]
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / torch.where(l == 0, 1.0, l)
    return o.reshape(B, Hq, D).to(q.dtype)


def paged_decode(q, k_pages, v_pages, lengths, page_indices, *,
                 k_scale_pages=None, v_scale_pages=None, scale=None,
                 pages_per_compute_block=4, layer=None):
    """Single-token attention over a paged KV cache.

    q: [B, Hq, D] bf16; k/v_pages: [n_pages, Hkv, page_size, D], or the
    whole per-layer pool [L, n_pages, Hkv, page_size, D] with ``layer``;
    bf16, int8 or float8_e4m3fn. lengths: [B] int32 valid keys (>= 1);
    page_indices: [B, pages_per_seq] int32. k/v_scale_pages: f32
    [(L,) n_pages, Hkv, page_size] for int8 / fp8 pages. Returns [B, Hq, D]
    bf16."""
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
    if D not in (64, 128) or Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"paged_decode kernel: D in (64, 128), Hq/Hkv <= "
                         f"{_MAX_GROUP} (got D={D}, Hq={Hq}, Hkv={Hkv})")
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
    out = torch.empty_like(q)
    rc = _build.lib().paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale_pages.data_ptr() if kind else None,
        v_scale_pages.data_ptr() if kind else None,
        lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, n_pages, ps, D, pps, layer, kind, scale,
        _build.stream_of(q))
    _build.check(rc, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out
