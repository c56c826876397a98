"""Speculative decoding and chunked verify / prefill.

Port of the reference's ``models/speculative.py``, same function names and
signatures. A draft model proposes ``gamma`` tokens one by one; the target
scores the whole window in one forward pass (``chunk_step``: the window's
K / V written at ``lengths``, the masked ``flash_attention`` over the whole
cache, the q4_k GEMM at M = gamma + 1), and greedy acceptance keeps the
output that of the target's own greedy decoding (exact in f32; in bf16 the
verify pass and the decode step are different kernels, so near-tied argmaxes
can flip). Rejected draft tokens cost nothing to undo: ``rewind`` moves the
cache's ``lengths`` back and later writes overwrite the stale slots.

What differs, on purpose:

- The cache is updated IN PLACE, as ``llama.prefill`` / ``decode_step`` do:
  ``chunk_step`` writes the window's K / V and bumps ``lengths`` of the
  cache it is given, and ``rewind`` subtracts from ``lengths`` on the
  device. So a CUDA graph replay sees the same storage.
- ``speculative_scan`` (the reference's ``lax.scan`` over windows) is one
  CUDA graph of a window, replayed ``windows`` times (``llama.replay_graph``)
  on the card, with no host round trip; on the CPU the same window runs
  eagerly. Its outputs are device tensors.
- ``speculative_generate`` fetches each window's draft and verdict in one
  host read, not one per draft token.
"""

from __future__ import annotations

import numpy as np
import torch

from ggml_cuda_experiments_tpu_torch.models import llama
from ggml_cuda_experiments_tpu_torch.models.config import ModelConfig
from ggml_cuda_experiments_tpu_torch.ops.flash_attention import flash_attention


def _chunk_attention(layer, cfg: ModelConfig, h: torch.Tensor,
                     cache: llama.KVCache, li: int, positions: torch.Tensor):
    """Attention for a T-token window at positions lengths..lengths+T over
    the cache prefix; writes the window's K / V into the cache (in place).
    Returns (attn_out, cache)."""
    B, T, _ = h.shape
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if cache.quantized:
        raise ValueError("chunked verify needs an unquantized (bf16 or f32) "
                         "cache")
    x = llama.rms_norm(h, layer["attn_norm"], cfg.rms_eps)
    q, k, v = llama.qkv_proj(layer, x, cfg)
    q = llama.rope(q.reshape(B, T, Hq, D), positions, cfg.rope_theta)
    k = llama.rope(k.reshape(B, T, Hkv, D), positions, cfg.rope_theta)
    v = v.reshape(B, T, Hkv, D)
    llama._write_cache_layer(cache.k, li, k.transpose(1, 2), cache.lengths)
    llama._write_cache_layer(cache.v, li, v.transpose(1, 2), cache.lengths)

    # attend over the whole (static-size) cache, masked to kv_pos <= q_pos
    S = cache.k.shape[3]
    kv_pos = torch.arange(S, device=h.device)[None, None, None, :]
    q_pos = positions[:, None, :, None]                  # [B, 1, T, 1]
    mask = torch.where(kv_pos <= q_pos, 0.0, -torch.inf)
    o = flash_attention(q.transpose(1, 2).contiguous(), cache.k[li],
                        cache.v[li], mask).transpose(1, 2)   # [B, T, Hq, D]
    o = o.reshape(B, T, Hq * D).to(h.dtype)
    return llama.apply_linear(o, layer["wo"], cfg.x_quant8), cache


@torch.no_grad()
def chunk_step(params: llama.Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: llama.KVCache) -> tuple[torch.Tensor, llama.KVCache]:
    """Forward a T-token window against the cache prefix.

    tokens: [B, T] appended at positions lengths..lengths+T. Returns (f32
    logits [B, T, vocab] for every window position, the cache with the
    window's K / V written and lengths += T). For verify-then-rollback,
    rewind with ``rewind(cache, n)``."""
    T = tokens.shape[1]
    positions = cache.lengths[:, None] + torch.arange(
        T, dtype=torch.int32, device=tokens.device)
    h = params["embed"][tokens]
    for li, layer in enumerate(params["layers"]):
        attn, cache = _chunk_attention(layer, cfg, h, cache, li, positions)
        h = h + attn
        h = h + llama._mlp_block(layer, cfg, h)
    h = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)
    logits = llama.apply_linear(h, params["lm_head"], cfg.x_quant8)
    cache.lengths += T
    return logits.float(), cache


def rewind(cache: llama.KVCache, n) -> llama.KVCache:
    """Roll the cache back ``n`` tokens (an int or a device tensor), in
    place; stale K / V past lengths is masked and later overwritten."""
    cache.lengths -= n
    return cache


def prefill_chunked(params: llama.Params, cfg: ModelConfig,
                    tokens: torch.Tensor, cache: llama.KVCache,
                    chunk: int = 256) -> tuple[torch.Tensor, llama.KVCache]:
    """Chunked prefill: a [B, T] prompt ``chunk`` tokens at a time against
    the growing cache (activation memory O(chunk), not O(T)). Returns the
    last position's logits and the filled cache."""
    logits = None
    for t0 in range(0, tokens.shape[1], chunk):
        logits, cache = chunk_step(params, cfg, tokens[:, t0:t0 + chunk],
                                   cache)
    return logits[:, -1], cache


def speculative_window(tparams, tcfg: ModelConfig, dparams,
                       dcfg: ModelConfig, cur: torch.Tensor,
                       tcache: llama.KVCache, dcache: llama.KVCache, *,
                       gamma: int, windows: int):
    """The window ``speculative_scan`` repeats, as a closure over device
    state: ``gamma`` draft decode steps with argmax, one target
    ``chunk_step`` over [cur, d1..dgamma], the leading-accept count by
    cumprod, the bonus token, the target rewound by gamma - n_acc, one
    unconditional draft fill step with dgamma and the draft rewound by
    gamma - n_acc (uniform control flow in place of the host loop's
    accept-dependent branch), its row written at a device slot.

    Returns (window, state: the tensors it moves forward, (tokens
    [windows, gamma+1] int32, counts [windows], cur' [1])); cur' is a copy
    of ``cur``, updated in place."""
    if tcache.lengths.shape[0] != 1:
        raise ValueError("speculative decoding is the batch-1 latency path")
    dev = cur.device
    cur = cur.to(torch.int32).clone()
    toks = torch.full((windows, gamma + 1), -1, dtype=torch.int32,
                      device=dev)
    counts = torch.zeros((windows,), dtype=torch.int32, device=dev)
    slot = torch.zeros((1,), dtype=torch.long, device=dev)
    idx = torch.arange(gamma + 1, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)

    def window():
        tok, draft = cur, []
        for _ in range(gamma):
            logits, _ = llama.decode_step(dparams, dcfg, tok, dcache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            draft.append(tok)
        draft = torch.cat(draft)                           # [gamma]
        vlogits, _ = chunk_step(tparams, tcfg,
                                torch.cat([cur, draft])[None], tcache)
        preds = torch.argmax(vlogits[0], -1).to(torch.int32)   # [gamma+1]
        match = (preds[:gamma] == draft).to(torch.int32)
        n_acc = torch.cumprod(match, 0).sum().to(torch.int32)  # leading
        bonus = preds.gather(0, n_acc.long().view(1))          # [1]
        emitted = torch.where(idx < n_acc, torch.cat([draft, zero]),
                              torch.where(idx == n_acc, bonus, -1))
        # the target wrote gamma+1 positions; its pointer belongs at
        # +(n_acc+1). The draft wrote gamma (cur, d1..dgamma-1): fill
        # dgamma, then rewind
        rewind(tcache, gamma - n_acc)
        llama.decode_step(dparams, dcfg, draft[-1:], dcache)
        rewind(dcache, gamma - n_acc)
        toks.index_copy_(0, slot, emitted[None].to(torch.int32))
        counts.index_copy_(0, slot, (n_acc + 1).view(1))
        cur.copy_(bonus)
        slot.add_(1)

    return (window, [cur, slot, tcache.lengths, dcache.lengths],
            (toks, counts, cur))


@torch.no_grad()
def speculative_scan(tparams, tcfg: ModelConfig, dparams, dcfg: ModelConfig,
                     cur: torch.Tensor, tcache: llama.KVCache,
                     dcache: llama.KVCache, *, gamma: int = 4,
                     windows: int = 8):
    """``windows`` greedy speculative windows (``speculative_window``) with
    no host round trip. On the card the window is one CUDA graph, replayed
    ``windows`` times; on the CPU it runs eagerly.

    cur: [1] the current greedy token (already emitted). Returns (tokens
    [windows, gamma+1] int32 with row w valid through counts[w], counts
    [windows] = n_acc + 1, cur' [1], tcache, dcache), on cur's device. The
    valid rows, concatenated, equal greedy decoding of the target."""
    window, state, (toks, counts, cur) = speculative_window(
        tparams, tcfg, dparams, dcfg, cur, tcache, dcache, gamma=gamma,
        windows=windows)
    if cur.is_cuda:
        llama.replay_graph(window, windows, state)
    else:
        for _ in range(windows):
            window()
    return toks, counts, cur, tcache, dcache


def speculative_generate(
    tparams: llama.Params, tcfg: ModelConfig,
    dparams: llama.Params, dcfg: ModelConfig,
    prompt: torch.Tensor, steps: int, *, gamma: int = 4,
    max_len: int | None = None, cache_dtype=torch.bfloat16,
) -> tuple[np.ndarray, dict]:
    """Greedy speculative decoding through a host loop: the output of the
    target's own greedy decoding (exact in f32; in bf16 up to near-tied
    argmaxes, the verify pass and the decode step being different kernels),
    with up to (gamma+1)x fewer target weight streams.

    prompt: [1, T] (the batch-1 latency path); the caches are made on its
    device. Returns (tokens [1, steps], stats with ``verify_calls``,
    ``drafted`` and ``accepted``)."""
    B, T = prompt.shape
    if B != 1:
        raise ValueError("speculative decoding is the batch-1 latency path")
    dev = prompt.device
    max_len = max_len or llama._round_up(T + steps + gamma + 2, 256)
    tcache = llama.KVCache.create(tcfg, B, max_len, cache_dtype, device=dev)
    dcache = llama.KVCache.create(dcfg, B, max_len, cache_dtype, device=dev)
    tlogits, tcache = llama.prefill(tparams, tcfg, prompt, tcache)
    _, dcache = llama.prefill(dparams, dcfg, prompt, dcache)

    def as_tokens(ids):
        return torch.tensor(ids, dtype=torch.int32, device=dev)

    out: list[int] = []
    stats = {"verify_calls": 0, "drafted": 0, "accepted": 0}
    cur = int(torch.argmax(tlogits, -1)[0])
    while len(out) < steps:
        out.append(cur)
        if len(out) >= steps:
            break
        # draft gamma tokens autoregressively, on the device
        dtok, draft = as_tokens([cur]), []
        for _ in range(gamma):
            dlogits, dcache = llama.decode_step(dparams, dcfg, dtok, dcache)
            dtok = torch.argmax(dlogits, -1).to(torch.int32)
            draft.append(dtok)
        # the target verifies the whole window in one pass
        window = torch.cat([as_tokens([cur]), *draft])[None]   # [1, γ+1]
        vlogits, tcache = chunk_step(tparams, tcfg, window, tcache)
        preds = torch.argmax(vlogits[0], -1).to(torch.int32)
        fetched = torch.cat([window[0, 1:], preds]).tolist()
        draft, preds = fetched[:gamma], fetched[gamma:]
        stats["verify_calls"] += 1
        stats["drafted"] += gamma

        n_acc = 0
        while n_acc < gamma and preds[n_acc] == draft[n_acc]:
            n_acc += 1
        stats["accepted"] += n_acc
        # tokens at global indices n+1..n+n_acc+1 (n = cur's index): the
        # accepted draft prefix and the target's own next token
        emitted = draft[:n_acc] + [preds[n_acc]]
        # the target cache holds [cur, d1..dγ] at n..n+γ: rewind the
        # rejected tail
        rewind(tcache, gamma - n_acc)
        # the draft cache holds [cur, d1..dγ-1]: rewinding to n+n_acc+1
        # keeps K / V that is already right; only the all-accepted case
        # lacks dγ's and takes one fill step
        if n_acc < gamma:
            rewind(dcache, gamma - n_acc - 1)
        else:
            llama.decode_step(dparams, dcfg, as_tokens([draft[-1]]), dcache)
        out.extend(emitted[:-1])
        out = out[:steps]
        cur = emitted[-1]
    return np.asarray(out[:steps], np.int32)[None], stats
