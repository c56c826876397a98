"""Serving engine: continuous batching over a paged (optionally int8 / fp8)
KV pool.

Port of the reference's ``models/engine.py`` with its python scheduler. The
scheduler is host-side Python over NumPy state: admission, page allocation
and completion. The device side is four plain functions on tensors: the
per-request paged prefill (whole prompt, or one chunk of it), the batched
paged decode step, and a window of decode steps with on-device sampling.
Requests join and leave the running batch between steps, and the pool's
pages are recycled through a free list. Page accounting is conservative
(no preemption): a request is admitted only if pages for its whole
prompt + max_new_tokens fit, so decode never fails to allocate.

What differs from the reference, on purpose:

- PyTorch runs eagerly and the pool is updated IN PLACE (index writes on
  the device with index tensors on the device), where the reference
  threads a donated pool through jitted functions. The device functions
  return the pool they were given.
- A decode window is a host loop of W steps with no sync inside (the
  reference's ``lax.scan``); sampling draws from one ``torch.Generator``
  on the device, not from JAX's PRNG.
- The device mirror of (lengths, page table, active) advances on the
  device after single steps too, so a steady run uploads nothing.
- ``Engine(mesh=)`` (tensor parallelism, ``make_tp_engine_steps``) runs
  on every rank of the mesh with the rank's params shard
  (``parallel/tp.py``): the same requests on every rank, the pool's KV
  heads on "model", the logits gathered over "model" before sampling, so
  every rank makes the same choices.
- ``scheduler="native"`` takes admission, page allocation and completion
  from the C++ scheduler (``utils/native_sched.py``, the port's own copy
  of the reference's ``gct_sched.cpp``, built at first use), which makes
  the python scheduler's decisions; with the reference's limits: one
  decode step a scheduler pass, whole prefills. It runs in both the
  deferred mode (no ``eos_id``) and the eager one. The reference's CPU
  readiness barrier, an XLA-CPU artifact, is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.models.sampling import (
    SamplingParams, sample)
from ggml_cuda_experiments_tpu_torch.ops.flash_attention import (
    flash_attention)
from ggml_cuda_experiments_tpu_torch.ops.paged_attention import paged_decode
from ggml_cuda_experiments_tpu_torch.utils.platform import resolve_device

Params = dict[str, Any]


# ---------------------------------------------------------------------------
# paged pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PagedKVPool:
    """Shared page pool: k / v [L, n_pages, Hkv, ps, D] (bf16, int8 or
    float8_e4m3fn), plus f32 per-token scales [L, n_pages, Hkv, ps] when
    quantized. Page-major across heads, as the reference's."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def quant_fmt(self) -> str | None:
        if not self.quantized:
            return None
        return "int8" if self.k.dtype == torch.int8 else "fp8"

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.k, self.v, self.k_scale, self.v_scale)
                   if t is not None)

    @staticmethod
    def create(cfg: ModelConfig, n_pages: int, page_size: int,
               quantized: bool | str = False, dtype=torch.bfloat16,
               device=None) -> "PagedKVPool":
        """``quantized``: False, True / "int8", or "fp8" (float8_e4m3fn);
        on the card unless ``device`` is named."""
        device = resolve_device(device)
        shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size,
                 cfg.head_dim)
        if quantized:
            qdt = torch.float8_e4m3fn if quantized == "fp8" else torch.int8
            return PagedKVPool(
                k=torch.zeros(shape, dtype=qdt, device=device),
                v=torch.zeros(shape, dtype=qdt, device=device),
                k_scale=torch.zeros(shape[:-1], device=device),
                v_scale=torch.zeros(shape[:-1], device=device))
        return PagedKVPool(k=torch.zeros(shape, dtype=dtype, device=device),
                           v=torch.zeros(shape, dtype=dtype, device=device))


_bytes = llama._bytes        # one-byte pools as uint8 for index writes


def _pool_write(pool, li, pages_b, offs_b, val):
    """Decode writes: val [B, Hkv, ...] -> pool [L, n_pages, Hkv, ps, ...]
    at (li, pages_b[b], :, offs_b[b]), in place (pages_b / offs_b: [B]
    index tensors on the device). The advanced dims lead across the head
    slice, so the indexed view is [B, Hkv, ...]. The same write serves the
    k / v pools and their scale pools (the reference's _pool_write_scale)."""
    _bytes(pool)[li][pages_b, :, offs_b] = _bytes(val.to(pool.dtype))
    return pool


def _run_index(run_pages, T, run_len, run_offs):
    """Per-token (page, offset) [T] of a [.., T, ..] value cut into runs of
    ``run_len`` tokens, run i starting at run_offs[i] (default 0) of page
    run_pages[i]."""
    t = torch.arange(T, device=run_pages.device)
    run = t // run_len
    off = t % run_len
    if run_offs is not None:
        off = off + run_offs[run]
    return run_pages[run].long(), off


def _pool_write_pages(pool, li, run_pages, val, run_len, run_offs=None):
    """Prefill writes: val [Hkv, T, ...] cut into page runs, one index write
    for all of them (k / v pools and scale pools alike: the reference's
    _pool_write_pages_scale). A run past the valid length writes its owner
    page's unread tail, which is harmless; wholly invalid runs go to the
    trash page (run_pages says so)."""
    pages, offs = _run_index(run_pages, val.shape[1], run_len, run_offs)
    _bytes(pool)[li][pages, :, offs] = _bytes(
        val.transpose(0, 1).to(pool.dtype))
    return pool


def _write_kv(pool: PagedKVPool, kt, vt, write):
    """Write a layer's fresh bf16 K and V, quantized to the pool's format
    first when it has one; ``write(array, value)`` puts one array in
    place."""
    if pool.quantized:
        for arr, scales, x in ((pool.k, pool.k_scale, kt),
                               (pool.v, pool.v_scale, vt)):
            q, sc = llama._quantize_rowwise(x, pool.quant_fmt)
            write(arr, q)
            write(scales, sc)
    else:
        write(pool.k, kt)
        write(pool.v, vt)


# ---------------------------------------------------------------------------
# device steps
# ---------------------------------------------------------------------------

def _qkv(layer, cfg, h, positions):
    """rms_norm -> q/k/v projections -> RoPE: q [B, T, Hq, D], k / v
    [B, T, Hkv, D]."""
    B, T, _ = h.shape
    x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = llama.qkv_proj(layer, x, cfg)
    q = llama.rope(q.reshape(B, T, cfg.n_heads, cfg.head_dim), positions,
                   cfg.rope_theta)
    k = llama.rope(k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim), positions,
                   cfg.rope_theta)
    return q, k, v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)


def _finish_layer(layer, cfg, h, o, reduce_axis=None, mesh=None):
    """Attention output o [B, T, Hq, D] -> wo, residual, MLP, residual;
    ``reduce_axis``: the wo and w_down products psum'd over it."""
    B, T = o.shape[:2]
    o = o.reshape(B, T, cfg.n_heads * cfg.head_dim).to(h.dtype)
    h = h + llama.row_parallel(o, layer["wo"], mesh=mesh,
                               reduce_axis=reduce_axis)
    return h + llama._mlp_block(layer, cfg, h, reduce_axis=reduce_axis,
                                mesh=mesh)


def _run_pages(page_row, run_starts, length, ps, trash):
    """Page of each run: its own page while the run starts before
    ``length``, else the trash page."""
    idx = torch.clamp(run_starts // ps, max=page_row.shape[0] - 1)
    return torch.where(run_starts < length, page_row[idx], trash)


@torch.no_grad()
def _paged_prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   length: int, page_row: torch.Tensor, pool: PagedKVPool,
                   reduce_axis: str | None = None, mesh=None
                   ) -> tuple[torch.Tensor, PagedKVPool]:
    """Prefill ONE request: tokens [1, T] (T = padded prompt), ``length`` the
    true prompt length, page_row [pages_per_seq] on the device. Writes the
    prompt's KV into the pool and returns the logits [1, V] of the last
    valid token. Runs of the padded tail wholly past ``length`` go to the
    trash page (the pool's last), so they cannot touch another sequence.
    Attention runs over the fresh bf16 K / V, even for a quantized pool.
    ``reduce_axis`` / ``mesh``: tensor parallelism (cfg the rank's shard;
    the logits are then its vocabulary shard)."""
    B, T = tokens.shape
    dev = tokens.device
    ps = pool.k.shape[3]
    trash = pool.k.shape[1] - 1
    h = params["embed"][tokens]
    positions = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T)
    run_starts = torch.arange(-(-T // ps), device=dev) * ps
    run_pages = _run_pages(page_row, run_starts, length, ps, trash)
    # the padded tail is masked by length on top of the causal cut
    mask = torch.where(torch.arange(T, device=dev) < length, 0.0,
                       -torch.inf)[None, None, None, :]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, cfg, h, positions)
        kt = k.transpose(1, 2)[0]                # [Hkv, T, D]
        vt = v.transpose(1, 2)[0]
        _write_kv(pool, kt, vt, lambda arr, x: _pool_write_pages(
            arr, li, run_pages, x, ps))
        o = flash_attention(q.transpose(1, 2).contiguous(),
                            kt[None].contiguous(), vt[None].contiguous(),
                            mask, causal=True).transpose(1, 2)
        h = _finish_layer(layer, cfg, h, o, reduce_axis, mesh)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h[:, length - 1], params["lm_head"])
    return logits.float(), pool


def _gather_seq(pool: PagedKVPool, li: int, page_row: torch.Tensor):
    """Layer li's pages of one sequence as contiguous bf16 [1, Hkv, S, D]
    (dequantized for an int8 / fp8 pool): the plain-torch gather of the
    reference's chunked prefill."""
    rows = page_row.long()

    def seq(t):
        g = _bytes(t)[li][rows].view(t.dtype)              # [P, Hkv, ps..]
        return g.transpose(0, 1).reshape(1, g.shape[1], -1, *g.shape[3:])
    if pool.quantized:
        k = seq(pool.k).float() * seq(pool.k_scale)[..., None]
        v = seq(pool.v).float() * seq(pool.v_scale)[..., None]
        return k.to(torch.bfloat16), v.to(torch.bfloat16)
    return seq(pool.k), seq(pool.v)


@torch.no_grad()
def _paged_prefill_chunk(params: Params, cfg: ModelConfig,
                         tokens: torch.Tensor, pos0: int, length: int,
                         page_row: torch.Tensor, pool: PagedKVPool, *,
                         with_logits: bool = False
                         ) -> tuple[torch.Tensor | None, PagedKVPool]:
    """Chunked prefill: forward ONE window tokens [1, C] of a prompt, the
    slice [pos0, pos0 + C) (tail padded past ``length``), against the pool.
    Earlier chunks' KV is gathered back from the pool, so a long prompt runs
    in C-token steps between decode steps. Returns (the last valid
    position's logits if ``with_logits`` else None, the pool)."""
    B, C = tokens.shape
    dev = tokens.device
    ps = pool.k.shape[3]
    trash = pool.k.shape[1] - 1
    S = page_row.shape[0] * ps
    h = params["embed"][tokens]
    t_glob = pos0 + torch.arange(C, dtype=torch.int32, device=dev)
    positions = t_glob.expand(B, C)
    # runs never straddle a page: Engine takes C % ps == 0 or ps % C == 0,
    # and pos0 is a multiple of C
    n_runs, run_len = (C // ps, ps) if C % ps == 0 else (1, C)
    run_starts = pos0 + torch.arange(n_runs, device=dev) * run_len
    run_pages = _run_pages(page_row, run_starts, length, ps, trash)
    run_offs = run_starts % ps
    kv_pos = torch.arange(S, device=dev)[None, :]
    mask = torch.where((kv_pos <= t_glob[:, None]) & (kv_pos < length),
                       0.0, -torch.inf)[None, None]          # [1, 1, C, S]
    for li, layer in enumerate(params["layers"]):
        q, k, v = _qkv(layer, cfg, h, positions)
        _write_kv(pool, k.transpose(1, 2)[0], v.transpose(1, 2)[0],
                  lambda arr, x: _pool_write_pages(arr, li, run_pages, x,
                                                   run_len, run_offs))
        kseq, vseq = _gather_seq(pool, li, page_row)
        o = flash_attention(q.transpose(1, 2).contiguous(), kseq, vseq,
                            mask).transpose(1, 2)
        h = _finish_layer(layer, cfg, h, o)
    if not with_logits:
        return None, pool
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h[:, length - 1 - pos0], params["lm_head"])
    return logits.float(), pool


def _decode_slots(lengths, page_indices, active, pool: PagedKVPool):
    """Where each slot's new token goes: (page [B], offset [B]) on the
    device; idle slots write to the trash page."""
    ps = pool.k.shape[3]
    col = torch.clamp(lengths.long() // ps, max=page_indices.shape[1] - 1)
    pages = page_indices.gather(1, col[:, None])[:, 0]
    pages = torch.where(active, pages, pool.k.shape[1] - 1).long()
    return pages, (lengths % ps).long()


def _decode_layer(layer, cfg, li, h, lengths, page_indices, pages_b,
                  offs_b, pool: PagedKVPool, ppcb: int = 1,
                  reduce_axis: str | None = None, mesh=None):
    """One decoder layer of the batched decode step: h [B, 1, dim] -> the
    next h, with this token's K / V written into the pool first."""
    q, k, v = _qkv(layer, cfg, h, lengths[:, None])
    _write_kv(pool, k[:, 0], v[:, 0],                        # [B, Hkv, D]
              lambda arr, x: _pool_write(arr, li, pages_b, offs_b, x))
    o = paged_decode(q[:, 0].contiguous(), pool.k, pool.v, lengths + 1,
                     page_indices, k_scale_pages=pool.k_scale,
                     v_scale_pages=pool.v_scale,
                     pages_per_compute_block=ppcb, layer=li)
    return _finish_layer(layer, cfg, h, o[:, None], reduce_axis, mesh)


@torch.no_grad()
def _paged_decode_step(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, lengths: torch.Tensor,
                       page_indices: torch.Tensor, pool: PagedKVPool,
                       active: torch.Tensor, ppcb: int = 1,
                       reduce_axis: str | None = None, mesh=None
                       ) -> tuple[torch.Tensor, PagedKVPool]:
    """One decode step for the whole running batch, with no host sync.

    tokens [B] last sampled token per slot; lengths [B] int32 current
    lengths (BEFORE this token); page_indices [B, pages_per_seq]; active
    [B] bool. Idle slots keep lengths >= 1 and a valid page row, and write
    to the trash page (their logits are ignored). Returns logits [B, V] and
    the pool holding this token's KV. ``reduce_axis`` / ``mesh``: as for
    ``_paged_prefill``."""
    pages_b, offs_b = _decode_slots(lengths, page_indices, active, pool)
    h = params["embed"][tokens[:, None]]                     # [B, 1, dim]
    for li, layer in enumerate(params["layers"]):
        h = _decode_layer(layer, cfg, li, h, lengths, page_indices, pages_b,
                          offs_b, pool, ppcb, reduce_axis, mesh)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h[:, 0], params["lm_head"])
    return logits.float(), pool


def _paged_decode_window(decode_step, tokens: torch.Tensor,
                         lengths: torch.Tensor, page_indices: torch.Tensor,
                         pool: PagedKVPool, active: torch.Tensor,
                         generator: torch.Generator | None,
                         sampling: SamplingParams, steps: int):
    """``steps`` decode steps with on-device sampling and no host sync: the
    caller sizes the window so that no running request can finish inside
    it. ``decode_step(tokens, lengths, page_indices, pool, active)`` ->
    (logits, pool) is the engine's step (``_paged_decode_step`` on its
    params, or the tensor-parallel one). Returns (tokens [steps, B], last
    tokens [B], lengths [B], pool); lengths advance for active slots only,
    so they can feed the next window as they are."""
    adv = active.to(torch.int32)
    trace = []
    for _ in range(steps):
        logits, pool = decode_step(tokens, lengths, page_indices, pool,
                                   active)
        tokens = sample(logits, generator, sampling)
        lengths = lengths + adv
        trace.append(tokens)
    return torch.stack(trace), tokens, lengths, pool


# ---------------------------------------------------------------------------
# tensor-parallel steps (the engine over a model mesh)
# ---------------------------------------------------------------------------

def make_tp_engine_steps(cfg: ModelConfig, mesh, params: Params,
                         pool: PagedKVPool):
    """(prefill, make_decode) for a tensor-parallel engine, run on every
    rank: ``params`` this rank's shard (``parallel/tp.py``), cfg GLOBAL,
    ``pool`` the rank's KV heads. The logits come back whole (gathered
    over "model", the reference's out spec).

    prefill(params, tokens, length, page_row, pool) -> (logits, pool);
    make_decode(ppcb)(params, tokens, lengths, page_indices, pool, active)
    -> (logits, pool)."""
    from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm, tp
    tp.param_specs(params)                  # refuses fused projections
    lcfg = tp.local_config(cfg, pm.axis_size(mesh, "model"))
    if pool.k.shape[2] != lcfg.n_kv_heads:
        raise ValueError(f"pool of {pool.k.shape[2]} KV heads, the rank "
                         f"holds {lcfg.n_kv_heads}")

    def whole(logits):
        return pm.all_gather(logits, mesh, "model", dim=-1, tiled=True)

    def prefill(params, tokens, length, page_row, pool):
        logits, pool = _paged_prefill(params, lcfg, tokens, length,
                                      page_row, pool, reduce_axis="model",
                                      mesh=mesh)
        return whole(logits), pool

    def make_decode(ppcb):
        def decode(params, tokens, lengths, page_indices, pool, active):
            logits, pool = _paged_decode_step(
                params, lcfg, tokens, lengths, page_indices, pool, active,
                ppcb, reduce_axis="model", mesh=mesh)
            return whole(logits), pool
        return decode

    return prefill, make_decode


# ---------------------------------------------------------------------------
# host-side scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    slot: int | None = None
    pages: list[int] | None = None
    done: bool = False
    # deferred-fetch bookkeeping (token VALUES stay on the device)
    n_generated: int = 0
    first_dev: Any = None
    start_step: int = 0
    # chunked prefill progress (tokens of the prompt already processed)
    prefill_pos: int = 0

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.generated)


class PageAllocator:
    def __init__(self, n_pages: int):
        self.free = list(range(n_pages))

    def alloc(self, n: int) -> list[int] | None:
        if len(self.free) < n:
            return None
        out, self.free = self.free[:n], self.free[n:]
        return out

    def release(self, pages: list[int]) -> None:
        self.free.extend(pages)


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> device tensor without a device sync (pinned staging on
    a CUDA device)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t.clone().to(device)
    return t.pin_memory().to(device, non_blocking=True)


class Engine:
    """Continuous-batching inference engine. ``params`` lie on the device
    the engine runs on. ``scheduler``: "python" (host-side Python over
    NumPy state) or "native" (the C++ scheduler; no ``decode_window`` > 1,
    no ``prefill_chunk``). ``mesh``: a (data, model) mesh of
    ``parallel/mesh.py``; the engine then runs on every rank with the
    rank's TP shard of the params (``tp.shard_params``)."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 max_batch: int = 8, page_size: int = 64,
                 n_pages: int = 256, max_seq_len: int | None = None,
                 quantized_kv: bool | str = False, eos_id: int | None = None,
                 sampling: SamplingParams | None = None, seed: int = 0,
                 scheduler: str = "python", mesh=None,
                 decode_window: int = 1, prefill_chunk: int | None = None):
        if scheduler not in ("python", "native"):
            raise ValueError(f"scheduler: 'python' or 'native', got "
                             f"{scheduler!r}")
        if scheduler == "native" and prefill_chunk is not None:
            raise ValueError("prefill_chunk needs the python scheduler")
        if scheduler == "native" and decode_window > 1:
            raise ValueError("decode_window > 1 is not supported with the "
                             "native scheduler")
        if mesh is not None and prefill_chunk is not None:
            raise ValueError("prefill_chunk is not supported with a mesh")
        if mesh is not None and decode_window > 1:
            raise ValueError("decode_window is not supported with a mesh")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        # default greedy (temperature 0)
        self.sampling = sampling or SamplingParams(temperature=0.0)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_seq_len = max_seq_len or cfg.max_seq_len
        self.pages_per_seq = -(-self.max_seq_len // page_size)
        self.mesh = mesh
        pool_cfg = cfg
        if mesh is not None:
            from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
            from ggml_cuda_experiments_tpu_torch.parallel import tp
            pool_cfg = tp.local_config(cfg, pm.axis_size(mesh, "model"))
        self.pool = PagedKVPool.create(pool_cfg, n_pages, page_size,
                                       quantized=quantized_kv,
                                       device=self.device)
        # the last page is the reserved trash page (padding / idle slots)
        self.trash_page = n_pages - 1
        self.allocator = PageAllocator(n_pages - 1)
        self._nsched = None
        if scheduler == "native":
            from ggml_cuda_experiments_tpu_torch.utils import native_sched
            self._nsched = native_sched.NativeScheduler(
                max_batch, n_pages - 1, self.pages_per_seq, page_size,
                self.max_seq_len)
        self.eos_id = eos_id
        # largest pages-per-compute-block (<= 4) dividing pages_per_seq
        self.ppcb = next(c for c in (4, 2, 1) if self.pages_per_seq % c == 0)
        # the device steps: plain, or tensor-parallel over the mesh
        if mesh is not None:
            prefill_s, make_decode = make_tp_engine_steps(cfg, mesh, params,
                                                          self.pool)
            decode_s = make_decode(self.ppcb)
            self._prefill_fn = lambda *a: prefill_s(self.params, *a)
            self._decode_fn = lambda *a: decode_s(self.params, *a)
        else:
            self._prefill_fn = lambda *a: _paged_prefill(
                self.params, self.cfg, *a)
            self._decode_fn = lambda *a: _paged_decode_step(
                self.params, self.cfg, *a, self.ppcb)

        # Chunked prefill: prompts longer than ``prefill_chunk`` run one
        # chunk per scheduler step, between the running batch's decode
        # steps, so one long prompt cannot stall every decode.
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None and (prefill_chunk % page_size
                                          and page_size % prefill_chunk):
            raise ValueError("prefill_chunk must divide or be a multiple of "
                             "page_size (page runs must not straddle pages)")

        self.waiting: list[Request] = []
        self.prefilling: list[Request] = []
        self.running: list[Request] = []
        self._next_rid = 0
        # fixed-shape slot state, mirrored on the device
        self.slot_req: list[Request | None] = [None] * max_batch
        self.lengths = np.ones((max_batch,), np.int32)
        self.tokens = np.zeros((max_batch,), np.int32)
        self.page_table = np.full((max_batch, self.pages_per_seq),
                                  self.trash_page, np.int32)

        # Deferred fetch (no EOS to scan for): sampled tokens stay on the
        # device and feed the next step; the host fetches a request's
        # tokens once, when it finishes (completion is decided by counts).
        self._defer = eos_id is None
        self._tokens_dev = torch.zeros((max_batch,), dtype=torch.int32,
                                       device=self.device)
        self._trace: list[torch.Tensor] = []   # per-step [max_batch] tokens
        # Device mirror of (lengths, page_table, active), invalidated by
        # any host change (admit / finish prefill / release).
        self._dev_state = None

        # Multi-step decode window: up to ``decode_window`` steps per
        # scheduler pass, sized so that no running request can finish
        # inside the window. Needs the deferred fetch.
        self.decode_window = decode_window
        if decode_window > 1 and not self._defer:
            raise ValueError("decode_window needs eos_id=None")

    # -- API ---------------------------------------------------------------

    def add_request(self, prompt: list[int], max_new_tokens: int = 16) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(Request(rid, list(prompt), max_new_tokens))
        if self._nsched is not None:
            self._nsched.add_request(rid, len(prompt), max_new_tokens)
        return rid

    def step(self) -> dict[int, list[int]]:
        """Admit, prefill, and decode one window (or one token) for every
        running request. Returns {rid: generated tokens} of the requests
        finishing in this step."""
        self._admit()
        finished: dict[int, list[int]] = {}
        # every prefilling request's next chunk goes before the decode
        for req in list(self.prefilling):
            self._prefill_step(req)
        if not self.running:
            return finished

        # prefilling slots hold pages but do not decode yet
        active = np.array([r is not None and r in self.running
                           for r in self.slot_req])
        if self._dev_state is None:
            self._dev_state = (_upload(self.lengths, self.device),
                               _upload(self.page_table, self.device),
                               _upload(active, self.device))
        lens_dev, pt_dev, act_dev = self._dev_state

        if not self._defer:
            logits, self.pool = self._decode_fn(
                _upload(self.tokens, self.device), lens_dev, pt_dev,
                self.pool, act_dev)
            next_tokens = self._sample(logits).cpu().numpy()
            self._dev_state = None
            hit = np.zeros((self.max_batch,), np.uint8)
            done = []
            for req in list(self.running):
                s = req.slot
                self.lengths[s] += 1
                tok = int(next_tokens[s])
                req.generated.append(tok)
                self.tokens[s] = tok
                hit[s] = tok == self.eos_id
                if (tok == self.eos_id
                        or len(req.generated) >= req.max_new_tokens
                        or req.length >= self.max_seq_len):
                    done.append(req)
            if self._nsched is not None:
                done = self._native_done(hit)
            for req in done:
                finished[req.rid] = list(req.generated)
                self._release(req)
            return finished

        # window: the largest step count no running request can finish
        # within; the tail runs single steps
        W = 1
        if self.decode_window > 1:
            room = min(min(r.max_new_tokens - r.n_generated,
                           self.max_seq_len - len(r.prompt) - r.n_generated)
                       for r in self.running)
            W = self.decode_window if room >= self.decode_window else 1
        trace_w, last, lens_out, self.pool = _paged_decode_window(
            self._decode_fn, self._tokens_dev, lens_dev, pt_dev, self.pool,
            act_dev, self._gen, self.sampling, steps=W)
        self._dev_state = (lens_out, pt_dev, act_dev)
        self._tokens_dev = last
        self._trace.extend(trace_w.unbind(0))
        done = []
        for req in list(self.running):
            self.lengths[req.slot] += W
            req.n_generated += W
            if (req.n_generated >= req.max_new_tokens
                    or len(req.prompt) + req.n_generated >= self.max_seq_len):
                done.append(req)
        if self._nsched is not None:
            # no EOS is scanned for: completion by counts alone
            done = self._native_done(np.zeros((self.max_batch,), np.uint8))
        if done:
            # ONE host fetch for every request finishing in this pass
            devs = [self._collect_device(r) for r in done]
            flat = torch.cat(devs).cpu().numpy()
            sizes = np.cumsum([int(d.shape[0]) for d in devs])[:-1]
            for req, vals in zip(done, np.split(flat, sizes)):
                finished[req.rid] = [int(t) for t in vals]
                self._release(req)
        if not self.running:
            self._trace.clear()
        return finished

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {}
        for _ in range(max_steps):
            out.update(self.step())
            if not self.waiting and not self.running and not self.prefilling:
                break
        return out

    # -- internals ---------------------------------------------------------

    def _native_done(self, hit: np.ndarray) -> list[Request]:
        """The requests the native scheduler finishes at this step (it
        advances its own lengths and releases their pages)."""
        done = []
        for rid, slot in self._nsched.step_complete(hit):
            req = self.slot_req[slot]
            if req is None or req.rid != rid:
                raise RuntimeError(f"native scheduler finished request {rid}"
                                   f" in slot {slot}, which holds "
                                   f"{None if req is None else req.rid}")
            done.append(req)
        return done

    def _admit(self) -> None:
        if self._nsched is not None:
            for rid, slot, row in self._nsched.admit():
                req = next(r for r in self.waiting if r.rid == rid)
                self.waiting.remove(req)
                self._dev_state = None  # page table / active change
                req.slot = slot
                req.pages = [int(p) for p in row if p != self.trash_page]
                self.slot_req[slot] = req
                self.page_table[slot] = row
                self.running.append(req)
                self._prefill_slot(req, row)
            return
        while (self.waiting and
               len(self.running) + len(self.prefilling) < self.max_batch):
            req = self.waiting[0]
            need = -(-min(len(req.prompt) + req.max_new_tokens,
                          self.max_seq_len) // self.page_size)
            pages = self.allocator.alloc(need)
            if pages is None:
                break
            self.waiting.pop(0)
            self._dev_state = None      # page table / active change
            slot = self.slot_req.index(None)
            req.slot, req.pages = slot, pages
            self.slot_req[slot] = req
            row = np.full((self.pages_per_seq,), self.trash_page, np.int32)
            row[:len(pages)] = pages
            self.page_table[slot] = row
            if (self.prefill_chunk is not None
                    and len(req.prompt) > self.prefill_chunk):
                self.prefilling.append(req)   # chunked, via _prefill_step
            else:
                self.running.append(req)
                self._prefill_slot(req, row)

    def _prefill_slot(self, req: Request, row: np.ndarray) -> None:
        """Whole-prompt prefill (T padded to max(16, next power of 2)) and
        the first token."""
        T = max(16, 1 << (len(req.prompt) - 1).bit_length())
        toks = np.zeros((1, T), np.int64)
        toks[0, :len(req.prompt)] = req.prompt
        logits, self.pool = self._prefill_fn(
            _upload(toks, self.device), len(req.prompt),
            _upload(row, self.device), self.pool)
        self._finish_prefill(req, logits)

    def _prefill_step(self, req: Request) -> None:
        """The next chunk of one prefilling request."""
        C = self.prefill_chunk
        pos0 = req.prefill_pos
        last = pos0 + C >= len(req.prompt)
        toks = np.zeros((1, C), np.int64)
        sl = req.prompt[pos0:pos0 + C]
        toks[0, :len(sl)] = sl
        logits, self.pool = _paged_prefill_chunk(
            self.params, self.cfg, _upload(toks, self.device), pos0,
            len(req.prompt), _upload(self.page_table[req.slot], self.device),
            self.pool, with_logits=last)
        req.prefill_pos = pos0 + C
        if last:
            self.prefilling.remove(req)
            self.running.append(req)
            self._finish_prefill(req, logits)

    def _finish_prefill(self, req: Request, logits: torch.Tensor) -> None:
        """Sample the first token from the prefill's last-position logits."""
        slot = req.slot
        if self._defer:
            first_dev = self._sample(logits)[0:1]
            req.first_dev = first_dev
            req.start_step = len(self._trace)
            req.n_generated = 1
            self._tokens_dev[slot] = first_dev[0]
        else:
            first = int(self._sample(logits)[0])
            req.generated.append(first)
            self.tokens[slot] = first
        self.lengths[slot] = len(req.prompt)
        self._dev_state = None          # new active slot and length

    def _collect_device(self, req: Request) -> torch.Tensor:
        """Device-side 1-D tokens of a finished request (deferred mode)."""
        rows = self._trace[req.start_step:
                           req.start_step + req.n_generated - 1]
        parts = [req.first_dev]
        if rows:
            parts.append(torch.stack(rows)[:, req.slot])
        return torch.cat(parts)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        return sample(logits, self._gen, self.sampling)

    def _release(self, req: Request) -> None:
        self._dev_state = None          # the slot leaves the active set
        self.running.remove(req)
        self.slot_req[req.slot] = None
        if self._nsched is None:        # the native one released its own
            self.allocator.release(req.pages)
        self.lengths[req.slot] = 1
        self.tokens[req.slot] = 0
        self.page_table[req.slot] = self.trash_page
        req.slot = req.pages = None
        req.done = True
