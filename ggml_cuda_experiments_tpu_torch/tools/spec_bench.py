"""Speculative decoding on the card: the window's cost against plain greedy
decoding. The port's counterpart of the JAX package's
``tools/spec_bench.py``, with its flags, defaults and method:

  - per-window device cost of ``speculative_scan``'s window, captured once
    as a CUDA graph: the marginal between ``--w-small`` and ``--w-big``
    replays, each run from the same state and timed by CUDA events (the
    JAX tool compiles once and times two scan lengths; here one capture
    plays the compile's part, so no run pays for a capture);
  - the plain per-token cost: the marginal between 8 and 40 replays of
    ``generate_scan``'s captured step;
  - tokens per window and acceptance for draft = target (acceptance 1: the
    mechanics' overhead only) and for the real draft, and the speedup over
    plain decoding, speedup(a) = (E[accepted | a] + 1) * t_plain / t_window
    with E[accepted | a] = sum_{i=1..gamma} a^i (leading accepts); the
    break-even acceptance where it is 1;
  - with ``--draft-layers K``, the draft is the target's first K layers
    (shared embed, norm and head, no copy), and its teacher-forced
    acceptance is measured first: one all-logits draft pass over the
    target's own greedy sequence.

    python -m ggml_cuda_experiments_tpu_torch.tools.spec_bench
        [--target llama2-7b] [--draft tinyllama-1.1b] [--draft-layers K]
        [--gamma 4] [--w-small 4] [--w-big 16] [--plen 16]

Weights are made from seed 0 (``init_weights(cfg, seed=0)``, as the JAX
tool's) and quantized to q4_k on the card, the configuration ``x_quant8`` as
in the JAX tool, through each model's GCTC cache file
(``profile_decode.cached_params`` at its default ``ckpt_path``: loaded
where it exists, else built and saved), as the JAX tool caches its
quantized weights. Runs on the card; the measuring functions take any
device, so the CPU tests call them at the ``debug`` size.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

MAX_LEN = 1024


def load(model: str, device, fmt: str = "q4_k"):
    """(params, cfg) of ``model`` from seed 0, quantized to ``fmt``, through
    its GCTC cache file (``profile_decode.cached_params``)."""
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools.profile_decode import (
        cached_params)
    cfg = dataclasses.replace(PRESETS[model], x_quant8=True)
    return cached_params(cfg, fmt, 0, device), cfg


def truncated(params, cfg, k: int):
    """The target's first ``k`` layers as a draft: embed, final norm and
    head shared with the target, not copied."""
    return ({"embed": params["embed"], "layers": params["layers"][:k],
             "final_norm": params["final_norm"],
             "lm_head": params["lm_head"]},
            dataclasses.replace(cfg, n_layers=k))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def replay_seconds(step, state, runs) -> dict:
    """Seconds of ``n`` calls of ``step`` for each ``n`` in ``runs``, each
    run from the state as it was before the first (the faster of two). On
    the card the step is captured once (``llama.capture_graph``) and each
    run is ``n`` replays between CUDA events; on the CPU, ``n`` eager calls
    on the host clock, one run (a CPU time is no device metric: the CPU
    path checks the mechanics). The step's output buffers hold the last
    run's."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    saved = [t.clone() for t in state]
    cuda = saved[0].is_cuda
    call = llama.capture_graph(step, state).replay if cuda else step
    out = {}
    for n in runs:
        best = float("inf")
        for _ in range(2 if cuda else 1):
            for t, s in zip(state, saved):
                t.copy_(s)
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for _ in range(n):
                    call()
                end.record()
                end.synchronize()
                secs = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                for _ in range(n):
                    call()
                secs = time.perf_counter() - t0
            best = min(best, secs)
        out[n] = best
    return out


@torch.no_grad()
def plain_per_token(tparams, tcfg, prompt, max_len: int = MAX_LEN) -> float:
    """Seconds per greedy step of ``generate_scan``'s step after the
    prompt's prefill (a batch of prompt.shape[0] sequences): the marginal
    between 8 and 40 replays of one captured step (``replay_seconds``)."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    cache = llama.KVCache.create(tcfg, prompt.shape[0], max_len,
                                 device=prompt.device)
    logits, cache = llama.prefill(tparams, tcfg, prompt, cache)
    step, state, _ = llama.greedy_scan_step(
        tparams, tcfg, torch.argmax(logits, -1).to(torch.int32), cache, 40)
    t = replay_seconds(step, state, (8, 40))
    return (t[40] - t[8]) / 32


@torch.no_grad()
def window_cost(tparams, tcfg, dparams, dcfg, prompt, gamma: int,
                w_small: int, w_big: int, max_len: int = MAX_LEN):
    """(seconds per window, counts [w_big], the emitted stream) after both
    prefills: the marginal between ``w_small`` and ``w_big`` replays of one
    captured ``speculative_window`` (``replay_seconds``). The stream is the
    ``w_big`` run's: the first greedy token, then each window's accepted
    tokens and bonus token."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models import speculative as spec
    dev = prompt.device
    tcache = llama.KVCache.create(tcfg, 1, max_len, device=dev)
    dcache = llama.KVCache.create(dcfg, 1, max_len, device=dev)
    tlogits, tcache = llama.prefill(tparams, tcfg, prompt, tcache)
    llama.prefill(dparams, dcfg, prompt, dcache)
    cur = torch.argmax(tlogits, -1).to(torch.int32)
    window, state, (toks, counts, _) = spec.speculative_window(
        tparams, tcfg, dparams, dcfg, cur, tcache, dcache, gamma=gamma,
        windows=w_big)
    t = replay_seconds(window, state, (w_small, w_big))
    toks, counts = toks.cpu().numpy(), counts.cpu().numpy()
    stream = [int(cur[0])]
    for w in range(w_big):
        stream.extend(toks[w, :counts[w]].tolist())
    return (t[w_big] - t[w_small]) / (w_big - w_small), counts, stream


def teacher_forced_acceptance(tparams, tcfg, dparams, dcfg, prompt,
                              n_eval: int = 192, max_len: int = MAX_LEN
                              ) -> float:
    """P(draft argmax == the target's next token | the true prefix) over
    the target's own greedy continuation of ``prompt``: one all-logits draft
    prefill over [prompt, sequence] (padded to a multiple of 128), scored
    at the generated positions only."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    dev = prompt.device
    seq = llama.generate_scan(
        tparams, tcfg, prompt,
        llama.KVCache.create(tcfg, 1, max_len, device=dev), n_eval)
    full = np.concatenate([prompt.cpu().numpy(), seq], axis=1)
    T = full.shape[1] - 1
    Tp = -(-T // 128) * 128
    padded = np.pad(full[:, :-1], ((0, 0), (0, Tp - T)))
    dlogits, _ = llama.prefill(
        dparams, dcfg, torch.from_numpy(padded).to(dev),
        llama.KVCache.create(dcfg, 1, max(max_len, Tp), device=dev),
        all_logits=True)
    dpred = torch.argmax(dlogits[0, :T], -1).cpu().numpy()
    gen0 = prompt.shape[1] - 1
    return float((dpred[gen0:] == full[0, 1:][gen0:]).mean())


def speedup(toks_per_window: float, t_plain: float, t_window: float
            ) -> float:
    return toks_per_window * t_plain / t_window


def break_even(t_window: float, t_plain: float, gamma: int) -> float | None:
    """The least acceptance a (0.01 steps) where speculation pays: the
    expected tokens of a window, sum a^i + 1, times the plain per-token cost
    reach the window's cost. None if not even a = 1 does."""
    for a in np.linspace(0, 1, 101):
        if (sum(a ** i for i in range(1, gamma + 1)) + 1) * t_plain \
                >= t_window:
            return float(a)
    return None


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", default="llama2-7b")
    ap.add_argument("--draft", default="tinyllama-1.1b")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="build the draft from the target's first K layers "
                         "(shared embed / norm / head) and measure its "
                         "teacher-forced acceptance first")
    ap.add_argument("--gamma", type=int, default=4)
    ap.add_argument("--w-small", type=int, default=4)
    ap.add_argument("--w-big", type=int, default=16)
    ap.add_argument("--plen", type=int, default=16)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    print(f"card: {card_line()}")
    tparams, tcfg = load(args.target, dev)
    if args.draft_layers:
        dparams, dcfg = truncated(tparams, tcfg, args.draft_layers)
        draft_name = f"target[:{args.draft_layers} layers]"
    else:
        dparams, dcfg = load(args.draft, dev)
        draft_name = args.draft
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(
        0, min(tcfg.vocab_size, dcfg.vocab_size), (1, args.plen))).to(dev)
    gamma = args.gamma

    if args.draft_layers:
        acc_tf = teacher_forced_acceptance(tparams, tcfg, dparams, dcfg,
                                           prompt)
        print(f"teacher-forced acceptance of {draft_name}: {acc_tf:.3f} "
              f"over 192 generated positions (draft cost "
              f"~{args.draft_layers}/{tcfg.n_layers} of target)")

    t_plain = plain_per_token(tparams, tcfg, prompt)
    print(f"plain decode (generate_scan): {t_plain * 1e3:.3f} ms/token "
          f"({1 / t_plain:.1f} tok/s)")
    for name, dp, dc in (("draft=target (acc=1 bound)", tparams, tcfg),
                         (f"draft={draft_name}", dparams, dcfg)):
        t_win, counts, _ = window_cost(tparams, tcfg, dp, dc, prompt, gamma,
                                       args.w_small, args.w_big)
        toks_win = float(counts.mean())
        print(f"{name}: {t_win * 1e3:.3f} ms/window, {toks_win:.2f} "
              f"tok/window (acceptance {(toks_win - 1) / gamma:.2f}), tok/s "
              f"{toks_win / t_win:.1f} = "
              f"{speedup(toks_win, t_plain, t_win):.2f}x plain")
        if dp is tparams:
            a = break_even(t_win, t_plain, gamma)
            print(f"  break-even acceptance (gamma={gamma}): "
                  f"{'none' if a is None else f'~{a:.2f}'} (window cost "
                  f"{t_win / t_plain:.2f}x a plain token)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
