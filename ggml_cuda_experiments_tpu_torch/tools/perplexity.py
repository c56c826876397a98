"""Perplexity and logits parity: the port's prefill against the full-model
NumPy oracle on the same weights and tokens. The port's counterpart of the
JAX package's ``tools/perplexity.py``.

    python -m ggml_cuda_experiments_tpu_torch.tools.perplexity
        [--model debug|tinyllama-1.1b|...] [--fmt q4_k] [--tokens 256]
        [--batch 1] [--seed 0] [--skip-oracle] [--cpu] [--gguf PATH]

Weights are random, drawn from ``--seed`` by ``llama.init_weights`` (bf16;
f32 with ``--fmt f32``, which also keeps an f32 cache) and quantized to
``--fmt`` (q8_0, q4_0, q4_k or q6_k) by ``llama.quantize_params``; the
tokens are drawn from the same seed with NumPy. ``llama.prefill(...,
all_logits=True)`` gives the logits of every position; ``oracle.model``
gives the oracle's from the same (quantized) weights. Prints both PPLs,
the largest logit difference and the PPL's relative difference, and exits
1 when the PPLs differ by more than ``PPL_TOL`` or a logit by more than
``LOGIT_TOL`` (the JAX package's bounds, ``tests/test_oracle_model.py``).
With ``--gguf PATH`` the model is a llama.cpp GGUF file instead, loaded by
``utils/gguf.load_gguf`` (its configuration from the file's metadata, its
quantized tensors as they are stored; ``--model`` and ``--fmt`` are not
used).
"""

from __future__ import annotations

import argparse
import sys
import time

PPL_TOL = 0.02        # largest relative PPL difference to the oracle
LOGIT_TOL = 0.35      # largest logit difference to the oracle


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="debug")
    ap.add_argument("--fmt", default="q4_k")
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU")
    ap.add_argument("--gguf", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-oracle", action="store_true",
                    help="the port's PPL only (the oracle is O(T^2) NumPy)")
    return ap


def weights(cfg, fmt: str, seed: int, device):
    """(dense, served) parameters: the seeded dense weights and what the
    model runs (``dense`` itself for f32)."""
    import torch

    from ggml_cuda_experiments_tpu_torch.models import llama
    dtype = torch.float32 if fmt == "f32" else torch.bfloat16
    dense = llama.init_weights(cfg, seed=seed, device=device, dtype=dtype)
    if fmt == "f32":
        return dense, dense
    return dense, llama.quantize_params(dense, fmt)


def tokens_for(cfg, batch: int, n: int, seed: int):
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)


def run(cfg, fmt: str, n_tokens: int, batch: int, seed: int, device,
        skip_oracle: bool = False, params=None) -> dict:
    """The port's prefill and (unless skipped) the oracle on one model
    (``params``, else ``weights(cfg, fmt, seed)``): {"logits", "ppl",
    "tokens", "prefill_s"; "ref_logits", "ppl_ref", "max_diff", "rel",
    "oracle_s"}."""
    import numpy as np
    import torch

    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.oracle import model as oracle_model

    if params is None:
        _, params = weights(cfg, fmt, seed, device)
    tokens = tokens_for(cfg, batch, n_tokens, seed)
    cache = llama.KVCache.create(
        cfg, batch, max(256, n_tokens), device=device,
        dtype=torch.float32 if fmt == "f32" else torch.bfloat16)
    t0 = time.perf_counter()
    logits, _ = llama.prefill(params, cfg,
                              torch.from_numpy(tokens).to(device, torch.long),
                              cache, all_logits=True)
    logits = logits.float().cpu().numpy()
    out = {"logits": logits, "tokens": tokens,
           "ppl": oracle_model.perplexity(logits, tokens),
           "prefill_s": time.perf_counter() - t0}
    if not skip_oracle:
        t0 = time.perf_counter()
        ref = oracle_model.forward_logits(params, cfg, tokens)
        ppl_ref = oracle_model.perplexity(ref, tokens)
        out.update(ref_logits=ref, ppl_ref=ppl_ref,
                   max_diff=float(np.abs(logits - ref).max()),
                   rel=abs(out["ppl"] - ppl_ref) / ppl_ref,
                   oracle_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import torch

    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = torch.device("cpu") if args.cpu else require_cuda()
    params = None
    if args.gguf:
        from ggml_cuda_experiments_tpu_torch.utils.gguf import load_gguf
        t0 = time.perf_counter()
        params, cfg = load_gguf(args.gguf, device=dev)
        args.fmt = "gguf"
        print(f"loaded {args.gguf} in {time.perf_counter() - t0:.2f} s "
              "(host clock)")
    else:
        cfg = PRESETS[args.model]
    print(f"model {cfg.name}: {cfg.n_layers} layers, dim {cfg.dim}, "
          f"{args.fmt}, {args.batch} x {args.tokens} tokens, on {dev}")
    r = run(cfg, args.fmt, args.tokens, args.batch, args.seed, dev,
            args.skip_oracle, params)
    print(f"engine  PPL ({args.fmt}): {r['ppl']:.4f}  (prefill "
          f"{r['prefill_s']:.2f} s, host clock)")
    if args.skip_oracle:
        return 0
    print(f"oracle  PPL ({args.fmt}): {r['ppl_ref']:.4f}  (NumPy "
          f"{r['oracle_s']:.1f} s)")
    print(f"max |logit diff|: {r['max_diff']:.4f}   PPL rel diff: "
          f"{r['rel']:.2%}")
    if not r["rel"] <= PPL_TOL:
        print(f"FAIL: PPL rel diff {r['rel']:.4f} > {PPL_TOL}")
        return 1
    if not r["max_diff"] <= LOGIT_TOL:
        print(f"FAIL: max |logit diff| {r['max_diff']:.4f} > {LOGIT_TOL}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
