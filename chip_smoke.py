#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --kernels-only  # build + kernel checks, no model

Phases, each printing its own lines; any failure ends the run nonzero:
  1. environment: torch/CUDA versions, nvcc, the card and its power limit;
  2. build: compile csrc/*.cu for sm_90a, one nvcc per source, all at
     once (seconds, ptxas register lines; the redesigned kernels' by name;
     the attention kernels', the exact-f32 matvec's and paged decode's
     shared memory and CTAs per SM);
  3. device quantizer against the NumPy oracle, bit for bit;
  4. every kernel against its plain PyTorch version on the card at the
     paths' shapes: max error, bound, and both times (CUDA events, 20
     calls in one CUDA graph, median of 5 replays, weights rotated past
     the 50 MB L2), and a PyTorch call computing the same function where
     one exists; the dequantizing GEMM at every 7B linear and both
     routes' edges, beside torch.matmul on the weight already dequantized
     (logged), its launches by route logged at the end; the exact-f32
     matvecs at every 7B and tinyllama linear (tools/qgemm_bench.py's
     cases and timing, the split matvec_splits picks); 4b. the engine
     path's kernels (paged decode over bf16, int8 and fp8 pools at the
     ragged headline and the Engine's shape, and with GQA 32/8 where its
     split count is 2 and 8, masked flash attention: the prompt's length mask,
     a chunk mask, the speculative verify window beside SDPA; rope_pack
     with its tables given and made by the call, and bit-exact at one
     token, a ragged 130 and GQA 32/8);
     4c. the fused batch-1 decode kernels (int8-activation matvec, fused
     MLP, fused attention at MHA and GQA 32/8 and 32/4 on bf16 and f32
     caches of 1024 keys and at 57 keys, one layer of the layer kernel) at
     the 7B shapes; 4d. the Q4_K_M head's q6_k matvecs (exact f32 at
     tinyllama's 32000 x 2048, hybrid int8 at 7B's 32000 x 4096) and flash
     decode on
     int8 / fp8 caches at length 1024 (7B and tinyllama);
  5. the generate path: llama2-7b at full width and all 32 layers, random
     weights from a seed, quantized to q4_k on the card, the preset's
     default decode (fused MLP), three greedy requests through
     ``generate`` with every kernel's launch count asserted (and the
     RoPE tables made once a rope_pack prefill, asserted), then TTFT /
     decode rate per request, then request 1 teacher-forced through the
     plain versions on the card (logits within 2e-2 * max);
  5b. the same weights in bench.py's decode configuration (x_quant8,
     ``permute_hidden_params``, hperm): the same three requests through
     ``model_step`` (every layer in one launch), launch counts asserted,
     TTFT / decode rate; the two sibling paths (x_quant8 alone: fused
     attention + fused MLP; the per-layer ``layer_step``) with their
     counts, and the first's generate_scan in ms a token; every
     layer_step against its plain version at its forced
     input (5e-3 * max), model_step against the chained layer_step
     launches (equal), logits within 2e-2 * max;
  5c. the Q4_K_M mix: phase 5's layers with a q6_k head, through generate
     in the preset's configuration, bench.py's and on an int8 cache (each
     with launch counts, TTFT / decode rate), the int8-cache path forced
     layer by layer, and 4 requests through the Engine;
  6. the engine path on the same weights: 12 greedy requests through an
     int8-pool ``Engine`` of 8 slots, then three 512-token prompts in
     128-token chunks, each run with its launch counts asserted; TTFT,
     steady-state tok/s, pool bytes, peak memory and the device's busy
     share of one engine step; one batched decode step forced layer by
     layer against the plain versions (within 2e-2 * max);
  6c. (after 6, on the same weights) serving: the 12 requests through
     Engine(scheduler="native") and the python scheduler at W = 1,
     token-identical, each run's counts asserted; tools/engine_bench.py
     (steady tok/s from one pair of 24 and 8 requests of 64 tokens
     generating 32, TTFT, pool bytes, peak memory, busy share, the host
     time of a step by part) for python at W = 1 and 16 and native at
     W = 1; tools/profile_decode.py at batch 1 (cache 1024)
     and batch 8 (cache 512, bench.py's batch-8 step) in the x_quant8
     configuration, each component beside its bound and the step's
     kernels under torch.profiler, and the prefill marginal at 512;
  4e. the Q8_0 / Q4_0 kernels (q80_matvec and q40_matvec at every 7B and
     tinyllama linear and the start cases, q40_q8_matvec, q80_gemm,
     q40_gemm) and the device quantizer of both formats against the
     oracle;
  5e. (after 6, on the same seed's dense weights, made again) llama2-7b in
     Q8_0: the three requests through generate in the preset's
     configuration (unfused: q80_matvec per decode linear and the head,
     q80_gemm per prefill linear), counts asserted, TTFT / decode rate,
     request 1 forced layer by layer; then generate_scan's ms a token
     (one captured step replayed), counts asserted;
  5f. the same in Q4_0, in the preset's configuration (q40_matvec,
     q40_gemm; forced layer by layer) and bench.py's (q40_q8_matvec on
     every decode linear and the head);
  6b. the Engine on the Q4_0 weights over an int8 pool: 4 ragged requests
     through 8 slots, prefills in 128-token chunks, q40_gemm at M = 8 in
     every decode step, counts asserted, one batched decode step forced;
  5d. (on its own weights) tinyllama-1.1b at full width and 22 layers with
     a q6_k head: three requests through generate, the counts asserted
     (q6k_matvec per prefill and step, q4k_matvec launches by K, w_down at
     K = 5632), TTFT / decode rate, and request 1 forced layer by layer
     against the plain versions;
  5g. the same tinyllama weights in Q8_0 and in Q4_0 (w_down at K = 5632
     on q80_matvec / q40_matvec, asserted by K), each forced;
  4f. (after 4e, also with --kernels-only) the kernel lab's kernels: the
     dense GEMM (matmul: bf16 and f16 at 4096^3, int8 at 4096^3 bitwise,
     f32 at 2048^3, the three transposes, a ragged 1000^3, the batch-1
     matvec at 4096 x 4096), stage_pad, grid_sum (int32 exact, f32 the
     same bits on every run) and lane_reduce, each against its plain
     version, with the library call's time beside it; grid_sum's int32
     and f32 cases also timed against torch.sum in 3 interleaved pairs
     (each side's median and min-max);
  4g. (after 4f, also with --kernels-only) the VPU attention op: its
     partials kernel (the split over the keys) against the plain partials,
     its merge kernel on those partials, and the op's o and lse against the
     unsplit plain version at the 7B verify window (T 5, S 1024, D 128,
     bf16), a tinyllama-width draft window (D 64), the JAX test's
     small-head shapes at card size (D 40 / 80, T 16, S 4096, f32) and a
     batch row with no visible key, with SDPA's time beside each; then its
     gradient through torch.autograd against autograd of the plain formula
     (within 5e-5);
  8. (after 6, on phase 5's weights) speculative decoding: prefill_chunked
     (512 tokens in 128-token chunks) against prefill; speculative_generate
     with draft = target (48 tokens, gamma 4; launch counts asserted)
     against generate and the target's decode path teacher-forced over its
     stream: every departure from that path's argmax (so every rejection)
     a near-tie within 2e-2 * max|logit| (the share of near-tied positions
     logged), acceptance at least 0.8; generate_scan's per-token cost (8
     and 40 replays of one captured step, CUDA events); then
     speculative_scan's window captured once per draft (the target, its
     first 8 layers, tinyllama-1.1b q4_k) and replayed 4 and 16 times,
     each stream equal to speculative_generate's: ms / window, tokens /
     window, acceptance, tok/s, speedup and break-even acceptance; the
     speculative_scan entry point (16 windows, draft = target) equal to
     the timed graph's stream. Graph paths' launch counts are what
     LAUNCHES saw (the prefills, one eager step or window and its
     capture); the replays are reported apart;
  4h. (after 4g, also with --kernels-only) the probe kernels: every rung
     of the q4_k stage ladder (csrc/q4_probe.cu: floor, chunk, chunk32,
     ponly, loonly, nochunk, floorhi, bf16, dma, zponly, zlonly, full,
     noand, cols256, split_f32) on bench.py's 32768 x 4096 weight and
     q8_prep, full_pre bit-equal to q4k_q8_matvec, the q6_k head's rungs
     (csrc/q6_probe.cu: stream, bits2, the nib prologue and epilogue, and
     nib_global / nib_seg through the int8 GEMM) on q6_probe's operands at
     32768 rows, and the seven Mosaic probes (csrc/mosaic_probes.cu), each
     against its plain version, with the library call's time where one
     computes the same function (the floor: torch.sum over its bytes);
     dyn_sublane, lane_extract and tiny_call also timed against their
     library calls in 3 interleaved pairs;
  9. (decode: after 8 on phase 5's weights, and in 5d on its weights in
     q4_k) the benchmark entry's --decode (tools/bench.py): tok/s at batch
     1 (8 and 40 replays of one captured step), TTFT p50 at 512 tokens,
     batch 8, the stream bound, launch counts asserted; then (after 7) its
     kernel metric (q8_0, q4_k and the floor ceiling by bench.py's pair
     protocol; one JSON line with value and ceiling_pct in (0, 100]) and
     the probe tools through their main: exp_q4, exp_q4_r2 --check,
     shape_probe --preprep at the four 7B shapes, roofline_sweep,
     q6_probe, probe_mosaic_r3, membench, each path's counts asserted;
  4i. (after 4h, also with --kernels-only) flash_attention's lse output
     (#14's residual) against its plain version at ring attention's 7B
     shapes (H 32, D 128: one ring step at 256 with the causal block mask
     and with a block wholly in the future, 512 causal), beside the
     memory-efficient SDPA with compute_log_sumexp;
  10. (after 9's decode, on phase 5's weights) the distributed paths:
     ranks are processes sharing this card over a gloo group (collectives
     staged through host memory), spawned after the kernels are built;
     10a ring attention (causal and not), Ulysses and the context-parallel
     decode at 4 ranks (H 32, D 128, S 2048; decode over 4096) against
     one-rank flash_attention / flash_decode (2e-2 * max); 10b llama2-7b
     q4_k at 2 ranks: seq = 2 (ring prefill of 512 tokens, 8
     context-parallel decode steps), model = 2 (the TP step) and pipe = 2
     (2 microbatches of 2, 128 tokens), each forced at the single-rank
     generate tokens (free-running logits logged, greedy departures
     near-ties) and again layer by layer on the single-rank path's input
     (each layer and the logits within 2e-2 * max); 10c Engine(mesh=) at
     model = 2, 4 requests against the single-rank Engine on the same
     weights; every rank's launch counts asserted, peak memory and wall
     times (shared card, host transport: no scaling figure) printed;
  7. (before 9) the kernel lab's path through its tools: kernel_test (flash
     decode against the NumPy oracle, GQA 32/8, kv 4096: split-KV x8,
     single-pass, int8 cache; each must PASS), gemm_bench (2048, 4096,
     8192), the JAX package's primitive tests' cases through the port's
     ops, and perplexity on tinyllama-1.1b (22 layers, q4_k, 256 tokens:
     PPL within 2% of the NumPy oracle's), with each path's counts.
  11. (after 9, on its own weights) the checkpoint path: llama2-7b's
     seeded weights exported as a Q4_K_M-style GGUF file (utils/gguf.py's
     export_llama: quantize_blocks on the card, q4_k layers, q6_k attn_v /
     ffn_down where llama.cpp's use_more_bits picks, q6_k output, q4_k
     token_embd, attn_q / attn_k in llama.cpp's row order, an SPM
     vocabulary of 32,000), loaded by load_gguf (the load's wall seconds
     and GB/s, host peak RSS: getrusage here, sampled in a fresh process,
     the card's memory after) and load_tokenizer; every loaded weight
     bit-equal to the same weights quantized on the card; a text prompt
     through generate (16 tokens equal to the direct params', launch
     counts asserted, each layer forced against the plain versions); the
     GCTC round trip (save_params / load_params, bit-equal, both times);
     perplexity --gguf on a tinyllama-shaped file (22 layers) within its
     PPL_TOL / LOGIT_TOL. The files live in a temporary directory the
     phase deletes.
  12. (after 11, every earlier model freed) mixtral-8x7b at full width and
     depth (32 layers, dim 4096, GQA 32/8, 8 experts of intermediate 14336,
     top-2), built on the card one layer at a time from a seed (q4_k
     attention and experts through quantize + moe.stack_expert_quant, a
     q6_k head; build seconds, streamed bytes and peak memory logged);
     q4k_matvec and q4k_gemm (M 8, 512) at the experts' two shapes on the
     model's expert weights against their plain versions and bounds;
     phase 5's three prompts, 8 tokens generated each, through generate
     (launch counts asserted, q4k_matvec by K and q4k_gemm by route too),
     TTFT / decode rate; a decode step under torch.profiler; generate_scan
     (CUDA graphs) token-equal to generate, its counts asserted, and its
     ms a token beside the stream bound; request 1 forced layer by layer
     against the plain versions (2e-2 * max).
  13. (after 12, on its own memory) llama3-8b at full width and depth (32
     layers, GQA 32/8, vocab 128256, intermediate 14336 padded to 16384 by
     quantize_params, rope_theta 5e5), q4_k layers and head, weights drawn
     on the card from a seed: its new shapes' kernels on the model's own
     weights (q4k_matvec / q4k_gemm at w_gu and w_down K 16384, both
     matvecs at the 128256-row head, fused_mlp at Kd 16384, fused_attention
     at GQA 32/8, rope_pack at theta 5e5) against their plain versions and
     bounds, the layer kernel's occupancy at Kd 16384; phase 5's three
     requests through generate and generate_scan (token-equal) in the
     preset's configuration (the fused MLP) and under x_quant8
     (fused_attention + fused_mlp, the int8 head), counts asserted, TTFT /
     decode rate, each forced layer by layer (2e-2 * max), the x_quant8
     step's graph ms a token and profile; bench.py's decode configuration
     forced layer by layer (layer_step within 5e-3 * max, model_step equal
     to the chained launches) and model_step timed at Kd 16384; then the
     benchmark entry's --decode --model=llama3-8b with its counts.
  14. (after 13, on its own memory) llama2-70b at full width and depth (80
     layers, dim 8192, GQA 64/8, intermediate 28672), q4_k layers and head,
     built on the card one layer at a time; every fused gate is closed at
     dim 8192. q4k_matvec and q4k_gemm (M 16, 128, 512) at every linear
     and the head, flash_decode at 8 query heads a KV head, flash_attention
     and rope_pack at 64/8 heads, each against its plain version and bound;
     phase 5's prompts, 8 tokens generated each, through generate and
     generate_scan (token-equal; counts asserted, q4k_matvec by K and
     q4k_gemm by route too), TTFT / decode rate, graph ms a token, a
     profiled decode step, request 1 forced layer by layer; peak memory.
  15. (after 14, on its own memory) llama2-7b with every q4_k linear in
     the s6 encoding (quantize_params' tree, each linear through
     quantize(..., enc="s6")), at full width and depth: each s6 kernel
     (q4k_s6_matvec and q4k_s6_q8_matvec at wqkv, W_o, w_gu, w_down and
     the head; q4k_s6_gemm there at M 4, 16, 512; fused_mlp_s6;
     fused_attention_s6 at length 1024) against its plain version, its us
     beside the Q4_K-E kernel's on the same shapes timed here and both
     bounds; phase 5's prompts, 8 tokens each, through generate and
     generate_scan (token-equal) in the preset's configuration and under
     x_quant8, counts asserted (s6 kernels only: no Q4_K-E kernel and no
     kernel-path scales_to_e), each forced layer by layer (2e-2 * max,
     3e-2 under x_quant8), graph ms a token beside the s6 stream bound;
     a ragged batch of 4 rows (prompts 17, 64, 200, 511, each prefilled
     alone) decoded together through q4k_s6_gemm's stream route and
     flash_decode over unequal lengths, each layer and the logits forced
     against each row's batch-1 run (2e-2 * max), counts asserted.
  16. (after 15) tools/profile_decode.py's probe modes, each once at
     reduced reps on tinyllama-1.1b where it takes a model (--ladder,
     --layer-marginal --ablate, --nonlayer --head-fmt q6_k, --blocks,
     --embed 512, --pipe, --enc s6, --host), every JSON row asserted;
     q4k_gemm's tc phases at the two --pipe shapes, M 512 (phase "all"
     bit-equal to the production call, "stream" zeros, "dequant" and
     "dot" launched); the tools' GCTC weight cache on tinyllama (built
     and saved, loaded: the same tree, the same logits); the launches
     counted as one path, "profile_decode".
Each phase's wall seconds are printed on a line of their own ("phase 13:
<seconds> s") and kept in the JSON line's "phase_seconds". The last line is
the contract line {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that one JSON object with every
kernel's route, source, launches per path, error, times and bound. Imports
nothing of jax or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
REQUESTS = ((16, 32), (128, 32), (512, 16))      # (prompt, generated)


def log(*a):
    print(*a, flush=True)


def time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of fn(i), in ms (``utils/bench.py``: ``calls``
    calls captured into one CUDA graph, the median of ``replays``
    replays)."""
    from ggml_cuda_experiments_tpu_torch.utils import bench
    return bench.time_ms(fn, calls, replays)


def rel_err(got, ref) -> tuple[float, float]:
    """(max |got - ref|, max |ref|), taken in f64 (int32 sums above 2^24
    stay exact); raises on non-finite output."""
    import torch
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite values in kernel output")
    return float((got - ref).abs().max()), float(ref.abs().max())


class Results:
    """Per-kernel worst error and headline times for the JSON line."""

    def __init__(self):
        self.kernels = {}

    def add(self, name, case, err, scale, tol, ms, plain_ms, bound,
            headline=False, library_ms=None):
        """``bound``: (ms, "bytes" | "operations"), the least time the card
        could take for the case's work (``CardSpec.bound_ms``)."""
        ok = err <= tol * scale
        lib = "" if library_ms is None else f"  library {library_ms:.4f} ms"
        log(f"  {name:16s} {case:44s} max_abs_err {err:.3e} "
            f"(bound {tol:g}*{scale:.3e} = {tol * scale:.3e}) "
            f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"least {bound[0]:.4f} ms ({bound[1]}){lib}  "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {case}: error {err} > "
                                 f"{tol} * {scale}")
        k = self.kernels.setdefault(name, {"max_abs_err": 0.0})
        k["max_abs_err"] = max(k["max_abs_err"], err)
        if headline or "ms" not in k:
            k.update(ms=ms, plain_ms=plain_ms, shape=case, bound_ms=bound[0],
                     bound_by=bound[1], library_ms=library_ms)


KERNELS = {
    "q4k_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_matmul.cu",
                   "ggml_cuda_experiments_tpu/ops/quant_matmul.py:670",
                   ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1034",
                    "ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    "q4k_gemm": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_gemm.cu",
                 "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1084",
                 ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1154",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1115"]),
    "flash_decode": ("ggml_cuda_experiments_tpu_torch/csrc/flash_decode.cu",
                     "ggml_cuda_experiments_tpu/ops/flash_decode.py:143",
                     ["ggml_cuda_experiments_tpu/ops/flash_decode.py:49"]),
    "lse_merge": ("ggml_cuda_experiments_tpu_torch/csrc/flash_decode.cu",
                  "ggml_cuda_experiments_tpu/ops/flash_decode.py:386",
                  ["ggml_cuda_experiments_tpu/ops/lse.py:69"]),
    "flash_attention": (
        "ggml_cuda_experiments_tpu_torch/csrc/flash_attention.cu",
        "ggml_cuda_experiments_tpu/ops/flash_attention.py:51", []),
    "rope_pack": ("ggml_cuda_experiments_tpu_torch/csrc/rope_pack.cu",
                  "ggml_cuda_experiments_tpu/ops/prefill_fuse.py:34", []),
    "paged_decode": (
        "ggml_cuda_experiments_tpu_torch/csrc/paged_attention.cu",
        "ggml_cuda_experiments_tpu/ops/paged_attention.py:47", []),
    "q4k_q8_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_q8.cu",
                      "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1465",
                      ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1540"]),
    "fused_mlp": ("ggml_cuda_experiments_tpu_torch/csrc/fused_decode.cu",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1937", []),
    "fused_attention": (
        "ggml_cuda_experiments_tpu_torch/csrc/fused_decode.cu",
        "ggml_cuda_experiments_tpu/ops/fused_attention.py:76", []),
    "q6k_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q6k_matvec.cu",
                   "ggml_cuda_experiments_tpu/ops/quant_matmul.py:734", []),
    "q6k_q8_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q6k_matvec.cu",
                      "ggml_cuda_experiments_tpu/ops/quant_matmul.py:841",
                      []),
    # the scale path of flash_decode_partials (an int8 / fp8 cache)
    "flash_decode_q": ("ggml_cuda_experiments_tpu_torch/csrc/flash_decode.cu",
                       "ggml_cuda_experiments_tpu/ops/flash_decode.py:49",
                       ["ggml_cuda_experiments_tpu/ops/flash_decode.py:143"]),
    # one kernel, two entries: model_step (every layer) and layer_step
    "layer_kernel": ("ggml_cuda_experiments_tpu_torch/csrc/fused_decode.cu",
                     "ggml_cuda_experiments_tpu/ops/layer_kernel.py:113", []),
    # the Q8_0 / Q4_0 routes of #1-#7
    "q80_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q80_matvec.cu",
                   "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1154",
                   ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    "q40_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_matmul.cu",
                   "ggml_cuda_experiments_tpu/ops/quant_matmul.py:670",
                   ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1034",
                    "ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    "q40_q8_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_q8.cu",
                      "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1465",
                      ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1540"]),
    "q80_gemm": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_gemm.cu",
                 "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1084",
                 ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1154",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1115",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    "q40_gemm": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_gemm.cu",
                 "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1084",
                 ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1154",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1115",
                  "ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    # the kernel lab: the dense GEMM (#18) and the primitives (#19)
    "matmul": ("ggml_cuda_experiments_tpu_torch/csrc/matmul.cu",
               "ggml_cuda_experiments_tpu/ops/matmul.py:40", []),
    "stage_pad": ("ggml_cuda_experiments_tpu_torch/csrc/primitives.cu",
                  "tests/test_dma.py:21", []),
    "grid_sum": ("ggml_cuda_experiments_tpu_torch/csrc/primitives.cu",
                 "tests/test_reductions.py:22", []),
    "lane_reduce": ("ggml_cuda_experiments_tpu_torch/csrc/primitives.cu",
                    "tests/test_reductions.py:60", []),
    # #14's lse residual: the same kernel with one more store
    "flash_attention_lse": (
        "ggml_cuda_experiments_tpu_torch/csrc/flash_attention.cu",
        "ggml_cuda_experiments_tpu/ops/flash_attention.py:51",
        ["ggml_cuda_experiments_tpu/ops/flash_attention.py:119"]),
    # the CUDA-core attention op (#17): per-split partials, then their
    # fixed-order merge
    "vpu_attention": ("ggml_cuda_experiments_tpu_torch/csrc/vpu_attention.cu",
                      "ggml_cuda_experiments_tpu/ops/vpu_attention.py:53",
                      []),
    "vpu_attention_merge": (
        "ggml_cuda_experiments_tpu_torch/csrc/vpu_attention.cu",
        "ggml_cuda_experiments_tpu/ops/vpu_attention.py:53", []),
    # the s6 instances of the q4_k kernels (phase 15)
    "q4k_s6_matvec": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_matmul.cu",
                      "ggml_cuda_experiments_tpu/ops/quant_matmul.py:670",
                      ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1034",
                       "ggml_cuda_experiments_tpu/ops/quant_matmul.py:616"]),
    "q4k_s6_gemm": ("ggml_cuda_experiments_tpu_torch/csrc/q4k_gemm.cu",
                    "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1084",
                    ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1154",
                     "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1115"]),
    "q4k_s6_q8_matvec": (
        "ggml_cuda_experiments_tpu_torch/csrc/q4k_q8.cu",
        "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1465",
        ["ggml_cuda_experiments_tpu/ops/quant_matmul.py:1540"]),
    "fused_mlp_s6": ("ggml_cuda_experiments_tpu_torch/csrc/fused_decode.cu",
                     "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1937",
                     []),
    "fused_attention_s6": (
        "ggml_cuda_experiments_tpu_torch/csrc/fused_decode.cu",
        "ggml_cuda_experiments_tpu/ops/fused_attention.py:76", []),
}
# the probe kernels (#20): the q4_k stage ladder (one template, a mode per
# JAX rung; floor is also bench.py's stream-only ceiling), q8_prep, the
# q6_k head's rungs and the Mosaic probes
_Q4P = "ggml_cuda_experiments_tpu_torch/csrc/q4_probe.cu"
_EXP_Q4, _EXP_R2 = "tools/exp_q4.py", "tools/exp_q4_r2.py"
KERNELS.update({
    "q4_ladder_floor": (_Q4P, f"{_EXP_Q4}:213", [
        f"{_EXP_Q4}:162", "ggml_cuda_experiments_tpu/ops/quant_matmul.py:1506"]),
    **{f"q4_ladder_{m}": (_Q4P, f"{_EXP_Q4}:183", [f"{_EXP_Q4}:68"])
       for m in ("chunk", "chunk32")},
    **{f"q4_ladder_{m}": (_Q4P, f"{_EXP_Q4}:138", [f"{_EXP_Q4}:89"])
       for m in ("ponly", "loonly", "nochunk", "floorhi", "bf16")},
    **{f"q4_ladder_{m}": (_Q4P, f"{_EXP_R2}:267", [f"{_EXP_R2}:{line}"])
       for m, line in (("dma", 90), ("zponly", 98), ("zlonly", 110),
                       ("noand", 182), ("cols256", 166), ("split_f32", 197))},
    "q4_ladder_full": (_Q4P, f"{_EXP_R2}:267", [
        f"{_EXP_R2}:{line}" for line in (123, 128, 146, 216)]),
    "q8_prep": (_Q4P, "tools/shape_probe.py:103", []),
    **{name: ("ggml_cuda_experiments_tpu_torch/csrc/q6_probe.cu",
              "tools/q6_probe.py:136", ["tools/q6_probe.py:63"])
       for name in ("q6_stream", "q6_bits2", "q6_nib_lhs", "q6_nib_fold")},
    **{f"mosaic_{name}": ("ggml_cuda_experiments_tpu_torch/csrc/"
                          "mosaic_probes.cu",
                          f"tools/probe_mosaic_r3.py:{line}", [])
       for name, line in (("transpose_dot", 46), ("lane_concat", 61),
                          ("roll64", 73), ("dyn_sublane", 87),
                          ("lane_extract", 103), ("read_output", 123),
                          ("tiny_call", 146))},
})
# the wrappers of each weight format's linears: (one-row matvec, GEMM)
FORMAT_KERNELS = {"q4_k": ("q4k_matvec", "q4k_gemm"),
                  "q8_0": ("q80_matvec", "q80_gemm"),
                  "q4_0": ("q40_matvec", "q40_gemm")}
# launch-count keys of each kernel above (one wrapper each, but two for
# the layer kernel)
COUNT_KEYS = {"layer_kernel": ("model_step", "layer_step")}


# ---------------------------------------------------------------- phases

def phase_env():
    import torch
    log("== 1. environment")
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"torch.version.cuda {torch.version.cuda}")
    sys.path.insert(0, ROOT)
    from ggml_cuda_experiments_tpu_torch.ops import _build
    from ggml_cuda_experiments_tpu_torch.utils import device_info
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nv = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                        text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nv[-1] if nv else '?'}")
    card = device_info.card_line()
    log(f"card: {card}")
    log(f"device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs, "
        f"count {torch.cuda.device_count()}")
    return card


def phase_build():
    from ggml_cuda_experiments_tpu_torch.ops import _build
    log("== 2. build")
    t0 = time.perf_counter()
    _build.lib()
    log(f"built {_build.BUILD_INFO['path']} in "
        f"{_build.BUILD_INFO['seconds']:.1f} s (load {time.perf_counter() - t0:.1f} s)")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            log("  ptxas:", line.strip())
    # the kernels redesigned for Hopper (attention, the wgmma GEMM, the
    # split-KV decode, the one-launch grid sum, dyn_sublane, both routes of
    # the dequantizing GEMM): ptxas's
    # registers, spills and static shared memory by function, and the
    # runtime's view of the attention kernels at their launch shapes
    # (dynamic shared memory, CTAs resident per SM)
    fn = None
    redesigned = ("flash_attention_kernel", "vpu_attention_",
                  "wgmma_gemm_kernel", "flash_decode_partials_kernel",
                  "lse_merge_kernel", "grid_sum_kernel", "mp_dyn_sublane",
                  "gemm_stream_kernel", "gemm_tc_kernel", "q4_matvec_kernel",
                  "paged_decode_kernel", "layer_decode_kernel",
                  "rope_pack_kernel", "q80_matvec_kernel")
    for line in _build.BUILD_INFO["log"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn and any(r in fn for r in redesigned) \
                and ("Used" in line or "spill" in line):
            log(f"  ptxas {fn[:60]}: {line.strip()}")
    from ggml_cuda_experiments_tpu_torch.ops.probes import _info
    lib = _build.lib()
    for D in (128, 64):
        log(f"  flash_attention_kernel D={D}: "
            f"{_info(lib.flash_attention_info, D)}")
    for dtype, D in ((1, 128), (1, 64), (0, 80), (0, 40)):
        log(f"  vpu_attention_partials_kernel {('f32', 'bf16')[dtype]} "
            f"D={D}: {_info(lib.vpu_attention_info, dtype, D)}")
    # the exact-f32 matvec (16-byte scale instance) at each K it serves, and
    # the engine's paged_decode instances (MHA, D 128, a 16-page row)
    for fmt, K in ((0, 2048), (0, 4096), (0, 5632), (0, 11008), (0, 12288),
                   (1, 4096)):
        log(f"  q4_matvec_kernel {('q4_k', 'q4_0')[fmt]} K={K}: "
            f"{_info(lib.q4_matvec_info, fmt, K)}")
    # q80_matvec (16-byte scale instance) at the ring q80_stages picks
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    for K in (2048, 4096, 5632, 11008, 12288):
        stages = qm.q80_stages(K)[0]
        log(f"  q80_matvec_kernel K={K} ({stages} stages): "
            f"{_info(lib.q80_matvec_info, K, stages)}")
    for kind in (0, 1, 2):
        log(f"  paged_decode_kernel {('bf16', 'int8', 'fp8')[kind]} D=128 "
            f"G=1: {_info(lib.paged_decode_info, kind, 16)}")
    # the layer kernel (7B, intermediate 12288) and its attention block
    # (fused_attention)
    for block in (0, 1):
        log(f"  layer_decode_kernel {('layers', 'attention block')[block]}: "
            f"{_info(lib.layer_kernel_info, block, 3 * 4096)}")


def phase_quantizer(dev, seed):
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    log("== 3. device quantizer vs oracle")
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((256, 4096), generator=g, device=dev) / 64.0
    t0 = time.perf_counter()
    got = qm.quantize(w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want = qm.from_oracle(quant_ref.quantize_q4_k(w.cpu().numpy()),
                          device="cpu")
    for f in ("qs", "es", "em"):
        if not torch.equal(getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"device quantizer: {f} differs from the "
                                 "oracle")
    log(f"  [256, 4096] bit-equal to the oracle (qs, es, em); "
        f"{secs * 1e3:.1f} ms on the card")


def _rotating(make, nbytes):
    """Enough independent copies that cycling them streams past L2."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    return rotating(make, nbytes)


def _spec():
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_spec
    spec = card_spec()
    if spec is None:
        raise AssertionError("no published peaks for this card: the bounds "
                             "cannot be computed")
    return spec


def _rate(nbytes, flops, ms, kind="bf16"):
    """Achieved rates, and the share of the card's published peaks (the
    operations' against the peak of their ``kind``: bf16, int8 or f32)."""
    spec = _spec()
    gbs, tfs = nbytes / ms / 1e6, flops / ms / 1e9
    return (f"{gbs:.0f} GB/s ({100 * gbs * 1e9 / spec.hbm_bytes_per_s:.1f}"
            f"% of {spec.name} HBM), {tfs:.1f} TFLOP/s "
            f"({100 * tfs * 1e12 / spec.peak(kind):.1f}% of {kind})")


def _gemm_cases(res, spec, fmt, make):
    """The dequantizing GEMM of ``fmt`` at its cases in
    ``tools/qgemm_bench.py`` (the same cases, x and timing as that tool's):
    x [m, k] bf16 against weight copies ``make(n, k)`` that stream past the
    L2, the kernel against its plain version; at M = 8 and 512 a log line
    with torch.matmul of bf16 x against the weight already dequantized to
    bf16 (the product alone: not the same function, so not the library
    column). The headline: w_gu at M = 512."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    name = qb.NAMES[fmt]
    fn = getattr(qm, name)
    ws = key = None
    for _, layer, (n, k), m in qb.cases(fmt):
        if key != layer:
            ws = key = None
            torch.cuda.empty_cache()
            ws, key = _rotating(lambda i: make(n, k), make(8, k).nbytes
                                * n // 8), layer
        x = qb.gemm_x(m, n, k, ws[0].qs.device)
        y = fn(x, ws[0])
        with plain_versions():
            ref = fn(x, ws[0])
        err, sc = rel_err(y, ref)
        t = qb.gemm_times(qm, fn, x, ws)
        with plain_versions():
            pms = time_ms(lambda i: fn(x, ws[i % len(ws)]), calls=2,
                             replays=3)
        nbytes = ws[0].nbytes + 2 * m * k + 4 * m * n
        res.add(name, f"M={m} N={n} K={k} ({qm.gemm_route(m)}, {len(ws)} "
                f"weight copies)", err, sc, 2e-2, t["ms"], pms,
                spec.bound_ms(nbytes, 2 * m * n * k, "bf16"),
                headline=(layer, m) == ("w_gu", 512))
        log(f"    {layer}: {_rate(nbytes, 2 * m * n * k, t['ms'])}")
        if "matmul_ms" in t:
            log(f"    torch.matmul of bf16 x [{m}, {k}] against the "
                f"dequantized bf16 W: {t['matmul_ms']:.4f} ms (the kernel "
                f"{t['ms'] / t['matmul_ms']:.2f}x)")


def _matvec_cases(res, spec, fmt, g, randn):
    """The batch-1 matvec of ``fmt`` (q4_k, q4_0: the exact-f32 one; q8_0:
    ``q80_matvec``) at ``tools/qgemm_bench.py``'s linears and start cases,
    timed as that tool times them: against its plain version at 1e-4 *
    max, the split its plan picks logged, the bound by bytes. The
    headline: the 7B w_gu."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    name = qb.MATVECS[fmt]
    fn = getattr(qm, name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kind = "bf16" if fmt == "q8_0" else "f32"
    for layer, (n, k) in qb.LINEARS + qb.STARTS:
        torch.cuda.empty_cache()
        ws = qb.matvec_weights(qm, fmt, n, k, g)
        x = randn(1, k)
        y = fn(x, ws[0])
        with plain_versions():
            ref = fn(x, ws[0])
        err, sc = rel_err(y, ref)
        t = qb.matvec_case(qm, fmt, ws, x)
        with plain_versions():
            pms = time_ms(lambda i: fn(x, ws[i % len(ws)]), calls=2,
                          replays=3)
        res.add(name, f"{layer} N={n} K={k} (splits "
                f"{qb.matvec_split(qm, fmt, n, k, sms)}, {len(ws)} weight "
                "copies)", err, sc, 1e-4, t["ms"], pms,
                spec.bound_ms(t["bytes"], t["flops"], kind),
                headline=layer == "w_gu")
        log(f"    {_rate(t['bytes'], t['flops'], t['ms'], kind)}")
        del ws


def _flash_decode_cases(res, spec, randn, shapes, tag=""):
    """flash_decode (+ lse_merge) over stacked caches [L, 1, Hkv, S, D] of
    ``shapes`` (L, Hq, Hkv, S, D) against their plain versions, beside one
    SDPA over the layer with a length mask; the split count at half and
    twice pick_splits' choice logged. The headline: MHA at length 1024
    (untagged)."""
    import torch
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    tag = f"{tag} " if tag else ""
    for (L, Hq, Hkv, S, D) in shapes:
        kc = randn(L, 1, Hkv, S, D, dtype=torch.bfloat16)
        vc = randn(L, 1, Hkv, S, D, dtype=torch.bfloat16)
        q = randn(1, Hq, D, dtype=torch.bfloat16)
        dev = q.device
        for length in ((1, 300, 1024) if Hq == Hkv else (300, 1024)):
            lens = torch.full((1,), length, dtype=torch.int32, device=dev)
            layer = 5 if L > 5 else 1
            y = fd.flash_decode(q, kc, vc, lens, layer=layer)
            with plain_versions():
                ref = fd.flash_decode(q, kc, vc, lens, layer=layer)
            err, sc = rel_err(y, ref)
            n = fd.pick_splits(1, Hkv, S, fd._sm_count(0))
            scale = D ** -0.5
            ms = time_ms(lambda i: fd.flash_decode_partials(
                q, kc, vc, lens, scale=scale, n_splits=n, layer=i % L))
            with plain_versions():
                pms = time_ms(lambda i: fd.flash_decode_partials(
                    q, kc, vc, lens, scale=scale, n_splits=n, layer=i % L))
            mask = (torch.arange(S, device=dev) < length)[None, None, None]
            lib = time_ms(lambda i: F.scaled_dot_product_attention(
                q[:, :, None], kc[i % L], vc[i % L], attn_mask=mask,
                enable_gqa=Hq != Hkv))
            case = (f"{tag}[{L},1,{Hkv},{S},{D}] Hq={Hq} len={length} "
                    f"splits={n}")
            part_bytes = n * Hq * (D + 2) * 4
            res.add("flash_decode", case, err, sc, 1e-2, ms, pms,
                    spec.bound_ms(2 * Hkv * length * D * 2 + Hq * D * 2
                                  + part_bytes, 4 * Hq * length * D, "bf16"),
                    headline=Hq == Hkv and length == 1024 and not tag,
                    library_ms=lib)
            parts = fd.flash_decode_partials(q, kc, vc, lens, scale=scale,
                                             n_splits=n, layer=layer)
            y2 = fd.lse_merge(parts)
            with plain_versions():
                ref2 = fd.lse_merge(parts)
            err2, sc2 = rel_err(y2, ref2)
            ms2 = time_ms(lambda i: fd.lse_merge(parts))
            with plain_versions():
                pms2 = time_ms(lambda i: fd.lse_merge(parts))
            res.add("lse_merge", case, err2, sc2, 1e-2, ms2, pms2,
                    spec.bound_ms(part_bytes + Hq * D * 2, 3 * n * Hq * D,
                                  "f32"),
                    headline=Hq == Hkv and length == 1024 and not tag)
            # the split count at about half and twice pick_splits' choice
            for nn in (max(1, n // 2), n, 2 * n):
                t1 = time_ms(lambda i: fd.flash_decode_partials(
                    q, kc, vc, lens, scale=scale, n_splits=nn, layer=i % L))
                pp = fd.flash_decode_partials(q, kc, vc, lens, scale=scale,
                                              n_splits=nn, layer=layer)
                t2 = time_ms(lambda i: fd.lse_merge(pp))
                log(f"    kv_splits {nn:3d}: partials {t1 * 1e3:.1f} us + "
                    f"lse_merge {t2 * 1e3:.1f} us = "
                    f"{(t1 + t2) / lib:.3f}x SDPA")
        del kc, vc


def _flash_attention_cases(res, spec, randn, shapes, tag=""):
    """flash_attention, a causal prefill of ``shapes`` (T, Hq, Hkv, D),
    against its plain version, beside causal SDPA. The headline: T 512
    (untagged)."""
    import torch
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    tag = f"{tag} " if tag else ""
    for (T, Hq, Hkv, D) in shapes:
        q = randn(1, Hq, T, D, dtype=torch.bfloat16)
        k = randn(1, Hkv, T, D, dtype=torch.bfloat16)
        v = randn(1, Hkv, T, D, dtype=torch.bfloat16)
        y = fa.flash_attention(q, k, v, causal=True)
        with plain_versions():
            ref = fa.flash_attention(q, k, v, causal=True)
        err, sc = rel_err(y, ref)
        ms = time_ms(lambda i: fa.flash_attention(q, k, v, causal=True))
        with plain_versions():
            pms = time_ms(lambda i: fa.flash_attention(q, k, v, causal=True))
        lib = time_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=Hq != Hkv))
        pairs = T * (T + 1) // 2                   # visible (query, key)
        res.add("flash_attention",
                f"{tag}T={T} Hq={Hq} Hkv={Hkv} D={D} causal", err, sc, 1e-2,
                ms, pms,
                spec.bound_ms(2 * (2 * Hq + 2 * Hkv) * T * D,
                              4 * Hq * pairs * D, "bf16"),
                headline=T == 512 and not tag, library_ms=lib)


def phase_kernels(dev, seed, res: Results):
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    log("== 4. kernels vs plain versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    spec = _spec()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def weight(n, k):
        return qm.quantize(randn(n, k, scale=k ** -0.5))

    # q4k_matvec at every decode linear of llama2-7b (wqkv, W_o, w_gu,
    # w_down padded and unpadded, the head) and of tinyllama (K = 2048, and
    # w_down at K = 5632, K/32 outside the reference's repeat-aligned
    # counts): tools/qgemm_bench.py's cases and timing
    _matvec_cases(res, spec, "q4_k", g, randn)

    # q4k_gemm at every llama2-7b linear: w_gu at both routes' edges (the
    # speculative verify rows, the engine's batch-8 decode, the crossover, a
    # prefill chunk and a 512-token prompt), the others at M = 8 and 512
    _gemm_cases(res, spec, "q4_k", weight)

    # flash_decode (+ lse_merge) on the stacked 7B MHA cache, and GQA 32/8;
    # the PyTorch call for the same function: one SDPA over the layer with
    # a length mask
    _flash_decode_cases(res, spec, randn, ((32, 32, 32, 1024, 128),
                                           (2, 32, 8, 1024, 128)))

    # flash_attention, causal prefill; the PyTorch call: causal SDPA
    _flash_attention_cases(res, spec, randn, ((128, 32, 32, 128),
                                              (512, 32, 32, 128),
                                              (128, 32, 4, 64)))


PAGED_LENGTHS = (1, 63, 64, 65, 300, 512, 777, 1024)


def _check(name, case, got, ref, bound):
    """A check outside Results: max error against bound * max|ref|."""
    err, sc = rel_err(got, ref)
    ok = err <= bound * sc
    log(f"  {name:16s} {case:44s} max_abs_err {err:.3e} (bound {bound:g}*"
        f"{sc:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} {case}: error {err} > {bound} * {sc}")


def phase_engine_kernels(dev, seed, res: Results):
    """The kernels the engine path added or changed, at its 7B shapes."""
    import torch
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
    from ggml_cuda_experiments_tpu_torch.ops import paged_attention as pa
    from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    log("== 4b. engine-path kernels vs plain versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    spec = _spec()

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def flat(y):
        if isinstance(y, tuple):
            return torch.cat([t.flatten() for t in y])
        return y

    def both(name, case, fn, tol, bound, headline=False, library=None):
        y = flat(fn(1))
        with plain_versions():
            ref = flat(fn(1))
        err, sc = rel_err(y, ref)
        ms = time_ms(fn)
        with plain_versions():
            pms = time_ms(fn)
        lib = None if library is None else time_ms(library)
        res.add(name, case, err, sc, tol, ms, pms, bound, headline=headline,
                library_ms=lib)
        return ms

    # paged_decode at tools/qgemm_bench.py's cases and timing: the headline
    # (B = 8, MHA 32/32, D = 128, page 64, ragged lengths up to 1024 keys
    # over a 2-layer pool of 129 pages, the last one spare) on bf16, int8
    # and fp8 pages, and the Engine's own shape (int8, lengths up to 128):
    # one split (pick_splits); with GQA 32/8, 2 splits at the headline's
    # lengths and 8 at B = 2, lengths 1 and 1024 (seven empty splits): the
    # in-launch merge against the plain version
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    H, D = qb.PAGED_GEOMETRY["H"], qb.PAGED_GEOMETRY["D"]
    PS, PPS = qb.PAGED_GEOMETRY["ps"], qb.PAGED_GEOMETRY["pps"]
    B = len(PAGED_LENGTHS)
    n_pages = B * PPS + 1
    for case, lengths, hkv, fmts in (
            ("", PAGED_LENGTHS, H, ("bf16", "int8", "fp8")),
            ("engine, ", qb.ENGINE_LENGTHS, H, ("int8",)),
            ("", PAGED_LENGTHS, 8, ("bf16", "int8")),
            ("", (1, 1024), 8, ("bf16", "int8", "fp8"))):
        n = fd.pick_splits(len(lengths), hkv, PPS * PS, fd._sm_count(0))
        for fmt in fmts:
            inputs = qb.paged_inputs(dev, fmt, lengths, hkv, seed=seed + 3)
            q, kp, vp, lens, pidx, kw = inputs
            nbytes, flops = qb.paged_bytes(lengths, fmt, hkv)
            y = pa.paged_decode(q, kp, vp, lens, pidx, layer=1, **kw)
            with plain_versions():
                ref = pa.paged_decode(q, kp, vp, lens, pidx, layer=1, **kw)
            err, sc = rel_err(y, ref)
            ms = qb.paged_case(pa, inputs)
            with plain_versions():
                pms = qb.paged_case(pa, inputs)
            res.add("paged_decode", f"{case}B={len(lengths)} {H}/{hkv} "
                    f"D={D} page {PS} {fmt}, len <= {max(lengths)}, "
                    f"splits {n}", err, sc,
                    2e-3 if fmt == "bf16" else 2e-2, ms, pms,
                    spec.bound_ms(nbytes, flops, "bf16"),
                    headline=not case and hkv == H and fmt == "int8")
            pages = nbytes - 4 * len(lengths) * (PPS + H * D)
            log(f"    {pages / ms / 1e6:.0f} GB/s of pages read")
            del inputs, q, kp, vp, kw
    lens = torch.tensor(PAGED_LENGTHS, dtype=torch.int32, device=dev)
    pidx = torch.randperm(n_pages - 1, generator=g, device=dev).reshape(
        B, PPS).to(torch.int32)
    q = randn(B, H, D, dtype=torch.bfloat16)
    # paged_decode on a bf16 pool filled from a contiguous cache against
    # flash_decode on that cache
    kc = randn(1, B, H, PPS * PS, D, dtype=torch.bfloat16)
    vc = randn(1, B, H, PPS * PS, D, dtype=torch.bfloat16)

    def pool_of(c):
        pool = torch.zeros((n_pages, H, PS, D), dtype=c.dtype, device=dev)
        pool[pidx.long().flatten()] = c[0].reshape(B, H, PPS, PS, D).transpose(
            1, 2).reshape(B * PPS, H, PS, D)
        return pool

    _check("paged_decode", "bf16 pool vs flash_decode, same cache",
           pa.paged_decode(q, pool_of(kc), pool_of(vc), lens, pidx),
           fd.flash_decode(q, kc, vc, lens, layer=0), 2e-3)
    del kc, vc

    # masked flash_attention: the whole-prompt prefill (length mask and
    # causal) and a 128-row chunk over 1024 gathered keys (chunk mask)
    T = 512
    q = randn(1, H, T, D, dtype=torch.bfloat16)
    k = randn(1, H, T, D, dtype=torch.bfloat16)
    v = randn(1, H, T, D, dtype=torch.bfloat16)
    mask = torch.where(torch.arange(T, device=dev) < 450, 0.0,
                       -torch.inf)[None, None, None]
    pairs = sum(min(i + 1, 450) for i in range(T))
    both("flash_attention", "T=512 32/32 D=128 length mask + causal",
         lambda i: fa.flash_attention(q, k, v, mask, causal=True), 1e-2,
         spec.bound_ms(2 * 4 * H * T * D + 4 * T, 4 * H * pairs * D,
                       "bf16"))
    C, S, pos0, length = 128, 1024, 384, 500
    q = randn(1, H, C, D, dtype=torch.bfloat16)
    k = randn(1, H, S, D, dtype=torch.bfloat16)
    v = randn(1, H, S, D, dtype=torch.bfloat16)
    kv = torch.arange(S, device=dev)
    qpos = pos0 + torch.arange(C, device=dev)[:, None]
    mask = torch.where((kv <= qpos) & (kv < length), 0.0,
                       -torch.inf)[None, None]
    pairs = int((mask == 0).sum())
    both("flash_attention", "C=128 over S=1024, chunk mask",
         lambda i: fa.flash_attention(q, k, v, mask), 1e-2,
         spec.bound_ms(2 * H * (2 * C + 2 * S) * D + 4 * C * S,
                       4 * H * pairs * D, "bf16"))
    # the speculative verify window (models/speculative.py): T = 5 queries
    # at positions S - 5 .. S - 1 over the whole 1024-slot cache, the
    # additive mask kv_pos <= q_pos; the PyTorch call: SDPA, bool mask
    W = 5
    q = randn(1, H, W, D, dtype=torch.bfloat16)
    k = randn(1, H, S, D, dtype=torch.bfloat16)
    v = randn(1, H, S, D, dtype=torch.bfloat16)
    vis = (kv <= (S - W) + torch.arange(W, device=dev)[:, None])[None, None]
    mask = torch.where(vis, 0.0, -torch.inf)
    pairs = int(vis.sum())
    both("flash_attention", "T=5 over S=1024, verify mask",
         lambda i: fa.flash_attention(q, k, v, mask), 1e-2,
         spec.bound_ms(2 * H * (2 * W + 2 * S) * D + 4 * W * S,
                       4 * H * pairs * D, "bf16"),
         library=lambda i: F.scaled_dot_product_attention(
             q, k, v, attn_mask=vis))

    # rope_pack at a 512-token 7B prompt, bit-exact against the plain one:
    # the kernel alone (its tables made once, as a prefill hands them to
    # each layer; the headline) and with the tables made by the call; then
    # bit-exact at one token, a ragged tail (130) and GQA 32/8
    inputs = qb.rope_inputs(dev, T, H, H, g)
    ys, pos, kw = inputs
    tables = pf.rope_tables(pos, D, 10000.0)
    for given in (True, False):
        nbytes, ops = qb.rope_bytes(inputs, given)
        both("rope_pack", f"T=512 32/32 D=128 ({len(ys)} copies), tables "
             + ("given" if given else "made by the call"),
             lambda i, t=tables if given else None: pf.rope_pack_prefill(
                 ys[i % len(ys)], pos, **kw, tables=t), 0.0,
             spec.bound_ms(nbytes, ops, "f32"), headline=given)
    del inputs, ys
    for t, hkv in ((1, H), (130, H), (130, 8), (T, 8)):
        ys, pos, kw = qb.rope_inputs(dev, t, H, hkv, g, rotate=False)
        y = ys[0]
        got = pf.rope_pack_prefill(y, pos, **kw)
        with plain_versions():
            ref = pf.rope_pack_prefill(y, pos, **kw)
        _check("rope_pack", f"T={t} {H}/{hkv} D=128", flat(got), flat(ref),
               0.0)


def _versus_plain(res: Results, name, case, fn, tol, bound, headline=False,
                  calls=20, library=None, scale=None):
    """fn(i) on the kernel against its plain versions: the first output of
    the same shape and dtype, within ``tol`` * ``scale`` (default max
    |plain|); any further ones, k_new / v_new, within 2e-2 * max(1, max).
    Then both timed (the plain one with a tenth of the calls) and, where
    given, ``library(i)``: one PyTorch call of the same function. Returns
    the kernel's ms."""
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    got = fn(0)
    with plain_versions():
        ref = fn(0)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    if got[0].shape != ref[0].shape or got[0].dtype != ref[0].dtype:
        raise AssertionError(f"{name} {case}: {got[0].dtype} "
                             f"{tuple(got[0].shape)} vs plain {ref[0].dtype} "
                             f"{tuple(ref[0].shape)}")
    err, sc = rel_err(got[0], ref[0])
    for gk, rk in zip(got[1:], ref[1:]):
        e2, s2 = rel_err(gk, rk)
        if e2 > 2e-2 * max(1.0, s2):
            raise AssertionError(f"{name} {case}: k/v error {e2}")
    ms = time_ms(fn, calls=calls)
    with plain_versions():
        pms = time_ms(fn, calls=max(1, calls // 10), replays=3)
    lib = None if library is None else time_ms(library, calls=calls)
    res.add(name, case, err, sc if scale is None else scale, tol, ms, pms,
            bound, headline=headline, library_ms=lib)
    return ms


def _pairs(name, case, kernel, library, n=3):
    """``n`` interleaved pairs of the kernel's and the library call's times
    (``time_ms`` each; the order alternates from pair to pair): each
    side's median and min-max, and whether the two ranges overlap (the gap
    within the spread)."""
    ks, ls = [], []
    for i in range(n):
        sides = ((ks, kernel), (ls, library))
        for out, fn in sides if i % 2 == 0 else sides[::-1]:
            out.append(time_ms(fn))
    km, lm = statistics.median(ks), statistics.median(ls)
    overlap = min(ks) <= max(ls) and min(ls) <= max(ks)
    log(f"    {name} {case}, {n} interleaved pairs: kernel median "
        f"{1e3 * km:.2f} us ({1e3 * min(ks):.2f}-{1e3 * max(ks):.2f}), "
        f"library median {1e3 * lm:.2f} us ({1e3 * min(ls):.2f}-"
        f"{1e3 * max(ls):.2f}), ratio {km / lm:.3f}: "
        + ("within the spread" if overlap else "outside the spread"))


def phase_fused_kernels(dev, seed, res: Results):
    """The fused batch-1 decode kernels against their plain versions at the
    llama2-7b shapes (weights rotated past the L2 where one copy fits)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
    from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    log("== 4c. fused batch-1 decode kernels vs plain versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    spec = _spec()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def weight(n, k):
        return qm.quantize(randn(n, k, scale=k ** -0.5))

    def both(*a, **kw):
        _versus_plain(res, *a, **kw)

    # q4k_q8_matvec at wqkv, w_gu, w_down and the lm_head
    for n, k in ((12288, 4096), (24576, 4096), (4096, 12288), (32000, 4096)):
        ws = _rotating(lambda i: weight(n, k), weight(8, k).nbytes * n // 8)
        x = randn(1, k)
        nbytes = ws[0].nbytes + 4 * (k + n)
        both("q4k_q8_matvec", f"N={n} K={k} ({len(ws)} weight copies)",
             lambda i: qm.q4k_q8_matvec(x, ws[i % len(ws)]), 1e-4,
             spec.bound_ms(nbytes, 2 * n * k, "int8"),
             headline=(n, k) == (32000, 4096))
        del ws

    # fused_mlp at 7B: w_gu [24576, 4096], w_down [4096, 12288]
    mlps = [(weight(24576, 4096), weight(4096, 12288)) for _ in range(2)]
    x = randn(1, 4096)
    nbytes = mlps[0][0].nbytes + mlps[0][1].nbytes + 8 * 4096
    both("fused_mlp", "w_gu 24576x4096, w_down 4096x12288 (2 copies)",
         lambda i: qm.mlp_fused(x, *mlps[i % 2]), 5e-3,
         spec.bound_ms(nbytes, 2 * (24576 * 4096 + 4096 * 12288), "int8"),
         headline=True)

    # fused_attention (tools/qgemm_bench.py's inputs and bytes): at cache
    # length 1024 (1023 before the token) MHA 32/32 (7B, the headline), GQA
    # 32/8 and 32/4 on bf16 and on f32 caches, and a short cache of 57 keys
    # (two tiles, two splits); the splits are split_plan's
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for hkv, length, dtype in ((32, 1023, torch.bfloat16),
                               (8, 1023, torch.bfloat16),
                               (4, 1023, torch.bfloat16),
                               (32, 1023, torch.float32),
                               (8, 1023, torch.float32),
                               (4, 1023, torch.float32),
                               (32, 56, torch.bfloat16),
                               (8, 56, torch.bfloat16)):
        inputs = qb.attn_inputs(qm, dev, hkv, length, g, dtype)
        xa, ws, kc, vc, lens, kw = inputs
        nbytes, ops = qb.attn_bytes(inputs)
        n = len(fat.split_plan(length, qb.ATTN_S, hkv, sms, dtype))
        both("fused_attention",
             f"Hq=32 Hkv={hkv} len {length + 1} "
             f"{str(dtype)[6:]}, {n} splits (3 copies)",
             lambda i: fat.attention_fused(xa, *ws[i % 3], kc, vc, lens,
                                           i % 2, **kw), 5e-3,
             spec.bound_ms(nbytes, ops, "int8"),
             headline=(hkv, length, dtype) == (32, 1023, torch.bfloat16))
        del inputs, xa, ws, kc, vc

    # one 7B layer of the layer kernel (layer_step) at cache length 1024:
    # MHA 32/32 (7B) and GQA 32/8
    for hkv in (32, 8):
        kc = randn(2, 1, hkv, 1024, 128, dtype=torch.bfloat16)
        vc = randn(2, 1, hkv, 1024, 128, dtype=torch.bfloat16)
        lens = torch.full((1,), 1023, dtype=torch.int32, device=dev)
        layer = {"wqkv": weight((32 + 2 * hkv) * 128, 4096),
                 "wo": weight(4096, 4096), "w_gu": weight(24576, 4096),
                 "w_down": weight(4096, 12288),
                 "attn_norm": (1 + 0.1 * randn(4096)).to(torch.bfloat16),
                 "mlp_norm": (1 + 0.1 * randn(4096)).to(torch.bfloat16)}
        pack = lk.pack_layers([layer])
        h = randn(1, 4096)
        nbytes = (sum(layer[k].nbytes for k in lk.STREAM)
                  + 2 * hkv * 1024 * 128 * 2 + 8 * 4096)
        ops = 2 * sum(layer[k].array_shape[0] * layer[k].array_shape[1]
                      for k in lk.STREAM)
        both("layer_kernel", f"layer_step, one 7B layer, Hkv={hkv}, "
             "len 1024",
             lambda i: lk.layer_step(h, pack, kc, vc, lens, i % 2,
                                     n_heads=32, n_kv_heads=hkv,
                                     head_dim=128), 5e-3,
             spec.bound_ms(nbytes, ops, "int8"))
        del kc, vc, layer, pack


def phase_q4km_kernels(dev, seed, res: Results):
    """The Q4_K_M head's q6_k matvecs and the quantized cache's flash decode
    against their plain versions, at the shapes of their paths."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    log("== 4d. Q4_K_M head (q6_k) and quantized-cache kernels vs plain "
        "versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 6)
    spec = _spec()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # the exact-f32 q6_k matvec at tinyllama's head, the hybrid at 7B's;
    # each weight quantized on the card from its own draw
    for name, (n, k), ops in (("q6k_matvec", (32000, 2048), "f32"),
                              ("q6k_q8_matvec", (32000, 4096), "int8")):
        ws = _rotating(lambda i, n=n, k=k: qm.quantize(
            randn(n, k, scale=k ** -0.5), "q6_k"), n * k * 7 // 8)
        x = randn(1, k)
        nbytes = ws[0].nbytes + 4 * (k + n)
        fn = getattr(qm, name)
        ms = _versus_plain(res, name, f"N={n} K={k} ({len(ws)} weight copies)",
                           lambda i: fn(x, ws[i % len(ws)]), 1e-4,
                           spec.bound_ms(nbytes, 2 * n * k, ops),
                           headline=True)
        log(f"    {ws[0].nbytes / 1e6:.1f} MB of weight, "
            f"{_rate(nbytes, 2 * n * k, ms)}")
        del ws

    # flash_decode on int8 / fp8 caches at length 1024: the 7B cache (MHA
    # 32/32, D = 128, all 32 layers, rotated) and tinyllama's (GQA 32/4,
    # D = 64, 22 layers)
    # (and the 7B int8 cache at length 300, where the split of the valid
    # keys leaves 11 of 16 tiles unread)
    for (L, Hq, Hkv, D) in ((32, 32, 32, 128), (22, 32, 4, 64)):
        S = 1024
        q = randn(1, Hq, D, dtype=torch.bfloat16)
        kf, vf = randn(L, 1, Hkv, S, D), randn(L, 1, Hkv, S, D)
        n = fd.pick_splits(1, Hkv, S, fd._sm_count(0))
        # GQA rounds p * v_scale to bf16 (the reference's numerics), where
        # one ulp of expf may flip a rounding: 2^-8 of one term
        tol = 2e-3 if Hq == Hkv else 1e-2
        for fmt in ("int8", "fp8"):
            kc, ks = llama._quantize_rowwise(kf, fmt)
            vc, vs = llama._quantize_rowwise(vf, fmt)
            for length in ((1024, 300) if Hkv == 32 and fmt == "int8"
                           else (1024,)):
                lens = torch.full((1,), length, dtype=torch.int32,
                                  device=dev)
                kv_bytes = 2 * Hkv * length * (D + 4)  # payload and scales
                part_bytes = n * Hq * (D + 2) * 4
                # the error of the whole attention (partials + merge), the
                # time of the partials kernel (the merge is lse_merge's,
                # phase 4)
                kw = dict(layer=L - 1, k_scale=ks, v_scale=vs)
                got = fd.flash_decode(q, kc, vc, lens, **kw)
                with plain_versions():
                    ref = fd.flash_decode(q, kc, vc, lens, **kw)
                err, sc = rel_err(got, ref)

                def partials(i):
                    return fd.flash_decode_partials(
                        q, kc, vc, lens, scale=D ** -0.5, n_splits=n,
                        layer=i % L, k_scale=ks, v_scale=vs)
                ms = time_ms(partials)
                with plain_versions():
                    pms = time_ms(partials, calls=2, replays=3)
                res.add("flash_decode_q",
                        f"[{L},1,{Hkv},{S},{D}] {fmt} Hq={Hq} len={length} "
                        f"splits={n}", err, sc, tol, ms, pms,
                        spec.bound_ms(kv_bytes + Hq * D * 2 + part_bytes,
                                      4 * Hq * length * D, "bf16"),
                        headline=(Hkv == 32 and fmt == "int8"
                                  and length == 1024))
            del kc, vc, ks, vs
        del kf, vf


def phase_format_kernels(dev, seed, res: Results):
    """The Q8_0 / Q4_0 kernels against their plain versions at the shapes
    of their paths, each weight quantized on the card from its own draw
    (rotated past the L2 where one copy fits in it), and the device
    quantizer of both formats against the oracle."""
    import torch
    from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    log("== 4e. Q8_0 / Q4_0 kernels vs plain versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    spec = _spec()

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    w = randn(256, 5632, scale=5632 ** -0.5)
    for fmt in ("q8_0", "q4_0"):
        got = qm.quantize(w, fmt)
        want = qm.from_oracle(getattr(quant_ref, f"quantize_{fmt}")(
            w.cpu().numpy()), device="cpu")
        if not all(torch.equal(getattr(got, f).cpu(), getattr(want, f))
                   for f in ("qs", "d")):
            raise AssertionError(f"device {fmt} quantizer differs from the "
                                 "oracle")
    log("  device quantizer: q8_0 and q4_0 [256, 5632] bit-equal to the "
        "oracle (qs, d)")

    # q80_matvec at every llama2-7b and tinyllama linear and the start
    # cases (qgemm_bench's), the 7B w_gu its headline: it reproduces its
    # plain version's rounding (bf16(x) * bf16(q d) summed in f32), so it
    # is held to 1e-4 as the exact-f32 ones are
    _matvec_cases(res, spec, "q8_0", g, randn)

    # the int8 matvec: (name, format, (N, K), tolerance, operation type,
    # headline); its operands equal its plain version's. (q40_matvec:
    # below, at phase 4's linears.)
    for name, fmt, (n, k), kind, head in (
            ("q40_q8_matvec", "q4_0", (32000, 4096), "int8", True),
            ("q40_q8_matvec", "q4_0", (24576, 4096), "int8", False)):
        ws = _rotating(lambda i, n=n, k=k, fmt=fmt: qm.quantize(
            randn(n, k, scale=k ** -0.5), fmt), int(n * k * 0.5625))
        x = randn(1, k)
        nbytes = ws[0].nbytes + 4 * (k + n)
        fn = getattr(qm, name)
        ms = _versus_plain(res, name, f"N={n} K={k} ({len(ws)} weight copies)",
                           lambda i: fn(x, ws[i % len(ws)]), 1e-4,
                           spec.bound_ms(nbytes, 2 * n * k, kind),
                           headline=head)
        log(f"    {ws[0].nbytes / 1e6:.1f} MB of weight, "
            f"{_rate(nbytes, 2 * n * k, ms)}")
        del ws

    # q40_matvec at every llama2-7b and tinyllama linear, as q4k_matvec in
    # phase 4
    _matvec_cases(res, spec, "q4_0", g, randn)

    # the GEMMs at both routes' edges, w_gu [24576, 4096]
    for fmt in ("q8_0", "q4_0"):
        _gemm_cases(res, spec, fmt, lambda n, k, fmt=fmt: qm.quantize(
            randn(n, k, scale=k ** -0.5), fmt))


def phase_lab_kernels(dev, seed, res: Results):
    """The kernel lab's kernels against their plain versions on the card:
    the dense GEMM in each dtype, its transposes, a ragged shape and the
    batch-1 matvec; the staging and reduction primitives at sizes that
    stream well past the L2. The library column: torch.matmul (TF32 off),
    torch._int_mm, F.pad, torch.sum (int32 kept for int32), and amax + sum
    (two calls)."""
    import torch
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.ops import matmul as mm
    from ggml_cuda_experiments_tpu_torch.ops import primitives as pr
    log("== 4f. kernel-lab kernels (matmul, stage_pad, grid_sum, "
        "lane_reduce) vs plain versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    spec = _spec()
    assert not torch.backends.cuda.matmul.allow_tf32

    def operand(shape, dtype):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    kinds = {torch.bfloat16: "bf16", torch.float16: "bf16",
             torch.int8: "int8", torch.float32: "f32"}
    tols = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.int8: 0.0,
            torch.float32: 1e-4}

    def gemm(dtype, m, k, n, ta=False, tb=False, headline=False, copies=1):
        x = operand((k, m) if ta else (m, k), dtype)
        ws = [operand((n, k) if tb else (k, n), dtype)
              for _ in range(copies)]
        es = x.element_size()
        oes = torch.empty((), dtype=mm.default_out_dtype(dtype)
                          ).element_size()
        nbytes = (m * k + k * n) * es + m * n * oes
        kw = dict(transpose_a=ta, transpose_b=tb)
        op = lambda t, flag: t.T if flag else t
        if dtype == torch.int8:
            library = lambda i: torch._int_mm(op(x, ta),
                                              op(ws[i % copies], tb))
        else:
            library = lambda i: torch.matmul(op(x, ta), op(ws[i % copies], tb))
        route = mm.route(x, ws[0], **kw)
        ms = _versus_plain(res, "matmul",
                           f"{str(dtype)[6:]} M={m} K={k} N={n} "
                           f"ta={int(ta)} tb={int(tb)} {route}"
                           + (f" ({copies} weight copies)" if copies > 1
                              else ""),
                           lambda i: mm.matmul(x, ws[i % copies], **kw),
                           tols[dtype],
                           spec.bound_ms(nbytes, 2 * m * n * k, kinds[dtype]),
                           library=library, headline=headline)
        log(f"    {_rate(nbytes, 2 * m * n * k, ms, kinds[dtype])}")

    gemm(torch.bfloat16, 4096, 4096, 4096, headline=True)
    gemm(torch.float16, 4096, 4096, 4096)
    gemm(torch.int8, 4096, 4096, 4096)
    gemm(torch.int8, 4096, 4096, 4096, tb=True)     # both K-major: wgmma
    gemm(torch.float32, 2048, 2048, 2048)
    for ta, tb in ((False, True), (True, False), (True, True)):
        gemm(torch.bfloat16, 4096, 4096, 4096, ta, tb)
    gemm(torch.bfloat16, 1000, 1000, 1000)
    gemm(torch.bfloat16, 1, 4096, 4096, copies=5)    # 33.6 MB: past the L2

    # stage_pad: 1,048,576 rows of 80 f32 -> 128 (872 MB moved)
    R, D, DP = 1 << 20, 80, 128
    x = operand((R, D), torch.float32)
    _versus_plain(res, "stage_pad", f"[{R}, {D}] f32 -> [{R}, {DP}]",
                  lambda i: pr.stage_pad(x, DP), 0.0,
                  spec.bound_ms(4 * R * (D + DP), 0, "f32"),
                  library=lambda i: F.pad(x, (0, DP - D)), headline=True)
    del x
    # grid_sum: 524,288 x 128 int32 (268 MB), exact; then f32, within
    # 1e-6 of the summed magnitudes (another order of the same sum)
    n, d = 1 << 19, 128
    xi = torch.randint(-1000, 1000, (n, d), generator=g, device=dev,
                       dtype=torch.int32)
    _versus_plain(res, "grid_sum", f"[{n}, {d}] int32",
                  lambda i: pr.grid_sum(xi), 0.0,
                  spec.bound_ms(4 * n * d + 4, n * d, "f32"),
                  library=lambda i: torch.sum(xi, dtype=torch.int32),
                  headline=True)
    _pairs("grid_sum", f"[{n}, {d}] int32", lambda i: pr.grid_sum(xi),
           lambda i: torch.sum(xi, dtype=torch.int32))
    del xi
    xf = operand((n, d), torch.float32)
    again = [pr.grid_sum(xf) for _ in range(3)]
    if not all(torch.equal(a, again[0]) for a in again):
        raise AssertionError("grid_sum f32: runs differ")
    _versus_plain(res, "grid_sum", f"[{n}, {d}] f32 (three runs equal)",
                  lambda i: pr.grid_sum(xf), 1e-6,
                  spec.bound_ms(4 * n * d + 4, n * d, "f32"),
                  library=lambda i: torch.sum(xf),
                  scale=float(xf.double().abs().sum()))
    _pairs("grid_sum", f"[{n}, {d}] f32", lambda i: pr.grid_sum(xf),
           lambda i: torch.sum(xf))
    del xf
    # lane_reduce: 32,768 rows of 4,096 f32 (537 MB): the max exact, the
    # sum within 1e-6 * max |sum|
    n, d = 1 << 15, 4096
    x = operand((n, d), torch.float32)
    _versus_plain(res, "lane_reduce", f"[{n}, {d}] f32, max", lambda i:
                  pr.lane_reduce(x)[0], 0.0,
                  spec.bound_ms(4 * n * d + 8 * n, 2 * n * d, "f32"))
    _versus_plain(res, "lane_reduce", f"[{n}, {d}] f32, sum", lambda i:
                  pr.lane_reduce(x)[1], 1e-6,
                  spec.bound_ms(4 * n * d + 8 * n, 2 * n * d, "f32"),
                  library=lambda i: (x.amax(1, keepdim=True),
                                     x.sum(1, keepdim=True)), headline=True)
    del x


def phase_vpu_kernels(dev, seed, res: Results):
    """The VPU attention op's two kernels against their plain versions at
    the verify-window and small-head shapes: the partials of
    ``pick_splits``' split (o to o's bound times the largest |o| of the
    partials, m and l 1e-5 relative, the identity exactly), the merge on
    those partials, and the op's o and lse against the unsplit plain
    version, with SDPA's time beside it; then its gradient through
    torch.autograd against autograd of the plain formula. Returns the launch
    counts of the gradient run (the op's path).
    """
    import torch
    import torch.nn.functional as F
    from ggml_cuda_experiments_tpu_torch.ops import vpu_attention as va
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    log("== 4g. VPU attention (partials, merge; o, lse) vs plain versions on "
        "the card")
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    spec = _spec()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def lse_check(what, lse, ref):
        lerr = float(((lse - ref).abs() / ref.abs()).max())
        if not lerr <= 1e-5:
            raise AssertionError(f"{what} lse: relative error {lerr}")
        return lerr

    # (B, H, T, S, D, dtype, causal, lengths): the 7B verify window (the
    # headline), a tinyllama-width draft window, the JAX test's small-head
    # shapes at card size, and a batch row with no visible key
    cases = [(1, 32, 5, 1024, 128, torch.bfloat16, True, (1024,)),
             (1, 32, 5, 1024, 64, torch.bfloat16, True, (1024,)),
             (2, 32, 16, 4096, 40, torch.float32, False, (4096, 4059)),
             (2, 32, 16, 4096, 80, torch.float32, True, (4096, 4059)),
             (2, 32, 5, 1024, 128, torch.bfloat16, True, (0, 1024))]
    for B, H, T, S, D, dt, causal, lens in cases:
        q, k, v = (randn(B, H, n, D, dtype=dt) for n in (T, S, S))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q0 = S - T if causal else 0
        scale = float(D ** -0.5)
        n, span = va.pick_splits(B, H, T, S, sms)
        case = (f"B={B} H={H} T={T} S={S} D={D} {str(dt)[6:]} "
                f"{'causal' if causal else 'full'} len={lens}")
        # f32: the JAX test's 2e-5 absolute on unit-normal inputs; bf16:
        # the attention bound, 1e-2 * max
        tol = 2e-5 if dt == torch.float32 else 1e-2

        def part(i):
            return va._vpu_partials(q, k, v, lengths, causal=causal,
                                    scale=scale, q0_pos=q0, span=span)

        def fn(i):
            return va._vpu_attention_fwd_impl(q, k, v, lengths, causal=causal,
                                              scale=None, q0_pos=q0)

        parts = part(0)
        with plain_versions():
            rparts = part(0)
        po, pm, pl = parts
        ident = torch.isneginf(pm)
        if not torch.equal(ident, torch.isneginf(rparts[1])) \
                or pl[ident].any() or po[ident].any():
            raise AssertionError(f"vpu_attention {case}: the identity "
                                 "splits differ from the plain version")
        live = ~ident
        for name, got, want in (("m", pm, rparts[1]), ("l", pl, rparts[2])):
            rerr = float(((got[live] - want[live]).abs()
                          / want[live].abs()).max())
            if not rerr <= 1e-5:
                raise AssertionError(f"vpu_attention {case} partial {name}: "
                                     f"relative error {rerr}")
        err, osc = rel_err(po, rparts[0])

        def merge(i):
            return va._vpu_merge(po, pm, pl, dt)

        mo, mlse = merge(0)
        with plain_versions():
            rmo, rmlse = merge(0)
        merr, msc = rel_err(mo, rmo)
        lse_check(f"vpu_attention_merge {case}", mlse, rmlse)
        o, lse = fn(0)
        with plain_versions():
            o_ref, lse_ref = fn(0)
        lerr = lse_check(f"vpu_attention {case}", lse, lse_ref)
        oerr, sc = rel_err(o, o_ref)
        obound = tol * (1.0 if dt == torch.float32 else sc)
        if not oerr <= obound:
            raise AssertionError(f"vpu_attention {case}: o error {oerr} > "
                                 f"{obound}")
        ms, mms, both_ms = time_ms(part), time_ms(merge), time_ms(fn)
        with plain_versions():
            pms = time_ms(part, calls=4, replays=3)
            pmms = time_ms(merge, calls=4, replays=3)
        vis = va._visible(T, S, lengths, causal, q0, dev)
        lib = None
        if min(lens) > 0:
            # one PyTorch call of the same o: SDPA with the boolean mask
            lib = time_ms(lambda i: F.scaled_dot_product_attention(
                q, k, v, attn_mask=vis))
        # what this run's data needs: the visible (query, key) pairs and the
        # keys up to each batch row's frontier; a row with no visible key
        # weighs all S keys
        pairs = int(vis.sum()) * H
        pairs += H * T * S * lens.count(0)
        keys = sum(min(x, q0 + T if causal else S) if x else S for x in lens)
        es = q.element_size()
        part_bytes = 4 * B * H * T * n * (D + 2)
        nbytes = es * (B * H * T * D + 2 * H * keys * D) + part_bytes + 4 * B
        headline = (D, B) == (128, 1)
        res.add("vpu_attention", f"{case} splits={n}x{span}", err, osc,
                tol, ms, pms, spec.bound_ms(nbytes, 4 * pairs * D, "f32"),
                headline=headline, library_ms=lib)
        res.add("vpu_attention_merge", f"{case} splits={n}", merr,
                1.0 if dt == torch.float32 else msc, tol, mms, pmms,
                spec.bound_ms(part_bytes + B * H * T * (es * D + 4),
                              3 * B * H * T * n * D, "f32"),
                headline=headline)
        ratio = "" if lib is None else \
            f", {(ms + mms) / lib:.2f}x SDPA's {lib:.4f} ms"
        log(f"    the two launches {ms + mms:.4f} ms (the op timed whole "
            f"{both_ms:.4f} ms){ratio}; o {oerr:.3e} (bound {obound:.3e}), "
            f"lse relative error {lerr:.2e} (bound 1e-5) against the unsplit "
            f"plain version; {_rate(nbytes, 4 * pairs * D, ms, 'f32')}")
        del q, k, v, parts, rparts, po, pm, pl

    # the gradient: autograd through the op (the kernel forward, the plain
    # backward) against autograd of the plain formula, within 5e-5
    B, H, T, S, D = 1, 32, 5, 1024, 64
    q, k, v, do = (randn(B, H, n, D, dtype=torch.float32)
                   for n in (T, S, S, T))
    lengths = torch.tensor([1000], dtype=torch.int32, device=dev)
    vis = va._visible(T, S, lengths, True, S - T, dev)

    def formula(q, k, v):
        s = torch.where(vis, (q @ k.transpose(-1, -2)) * D ** -0.5,
                        va.MASK_VALUE)
        return torch.softmax(s, -1) @ v

    def op(q, k, v):
        return va.vpu_attention(q, k, v, lengths, True, None, 256, S - T)

    def grads_of(f):
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o = f(*xs)
        return (o.detach(), *torch.autograd.grad(o, xs, do))

    torch.cuda.synchronize()
    _reset_counts()
    grads = [grads_of(op)]
    torch.cuda.synchronize()
    counts = _counts()
    grads.append(grads_of(formula))
    for name, a, b in zip(("o", "dq", "dk", "dv"), *grads):
        err = float((a - b).abs().max())
        log(f"  vpu_attention autograd {name}: max_abs_err {err:.3e} "
            f"(bound {2e-5 if name == 'o' else 5e-5:g})")
        if not err <= (2e-5 if name == "o" else 5e-5):
            raise AssertionError(f"vpu_attention gradient {name}: {err}")
    want = {key: 0 for key in counts}
    want.update(vpu_attention=1, vpu_attention_merge=1)
    _assert_counts("vpu_attention", counts, want)
    return {"vpu_attention": counts}


def _flat_q4k(ql):
    """A copy of a q4_k weight whose qs, es and em are views of one byte
    buffer (returned beside it), so that one PyTorch call can read exactly
    the bytes the floor rung streams."""
    import dataclasses
    import torch
    n, k = ql.array_shape
    flat = torch.empty(n * (k // 2 + k // 8), dtype=torch.uint8,
                       device=ql.qs.device)
    a, b = n * k // 2, n * k // 2 + n * k // 16
    qs = flat[:a].view(n, k // 2)
    es = flat[a:b].view(torch.bfloat16).view(n, k // 32)
    em = flat[b:].view(torch.bfloat16).view(n, k // 32)
    qs.copy_(ql.qs)
    es.copy_(ql.es)
    em.copy_(ql.em)
    return dataclasses.replace(ql, qs=qs, es=es, em=em), flat


def phase_probe_kernels(dev, seed, res: Results):
    """The probe kernels against their plain versions on the card: every
    stage-ladder rung and q8_prep on bench.py's 32768 x 4096 q4_k weight
    (two copies, past the L2), the q6_k head's rungs on q6_probe's random
    operands at 32768 rows, and the Mosaic probes at their JAX shapes.
    Returns the composite rungs' times (full_pre, nib_global, nib_seg)."""
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import mosaic_probes as mp
    from ggml_cuda_experiments_tpu_torch.ops import probes
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    from ggml_cuda_experiments_tpu_torch.tools import q6_probe
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    log("== 4h. the probe kernels (stage ladder, q8_prep, q6 rungs, Mosaic "
        "probes) vs plain versions on the card")
    spec = _spec()
    w, x0 = eb.draws(seed)
    x = torch.from_numpy(x0).to(dev)
    base = qm.quantize(torch.from_numpy(w).to(dev), "q4_k")
    del w
    flats = [_flat_q4k(base) for _ in range(2)]
    ws = [f[0] for f in flats]
    n, k = base.array_shape
    tol = {"floor": 1e-5, "bf16": 2e-2}
    for mode in probes.MODES:
        act = probes.act_operands(mode, x)
        nbytes = base.nbytes + act.numel() + 4 * (k + n)
        kind = "f32" if mode in probes.F32_MODES or mode == "floor" else "int8"
        ops = n * k // 8 if mode == "floor" else 2 * n * k
        lib = None
        if mode == "floor":
            # torch.sum over the same bytes (one int32 reduction of qs, es
            # and em: the floor's stream, not its row-wise function)
            lib = lambda i: torch.sum(flats[i % 2][1].view(torch.int32),
                                      dtype=torch.int32)
        _versus_plain(res, f"q4_ladder_{mode}",
                      f"N={n} K={k}, bench.py's weight (2 copies)",
                      lambda i, mode=mode, act=act: probes.ladder(
                          mode, act, x, ws[i % 2]),
                      tol.get(mode, 1e-4), spec.bound_ms(nbytes, ops, kind),
                      headline=True, library=lib)
    _versus_plain(res, "q8_prep", f"x [1, {k}] -> its int8 operands",
                  lambda i: probes.q8_prep(x), 0.0,
                  spec.bound_ms(4 * k + 48 * k // 32, 4 * k, "f32"),
                  headline=True, scale=1.0)
    got = probes.full_pre(x, ws[0])
    if not torch.equal(got, qm.q4k_q8_matvec(x, ws[0])):
        raise AssertionError("full_pre differs from q4k_q8_matvec")
    composite = {"full_pre_ms": time_ms(lambda i: probes.full_pre(
        x, ws[i % 2])), "q4k_q8_matvec_ms": time_ms(
        lambda i: qm.q4k_q8_matvec(x, ws[i % 2]))}
    log(f"  full_pre (q8_prep + full) bit-equal to q4k_q8_matvec: "
        f"{composite['full_pre_ms']:.4f} ms against "
        f"{composite['q4k_q8_matvec_ms']:.4f} ms")
    del flats, ws, base

    rng = np.random.default_rng(seed)
    q6 = [q6_probe.draw_operands(q6_probe.N_BIG, rng, dev)
          for _ in range(2)]
    n6 = q6[0]["qs"].shape[0]
    b6 = sum(q6[0][f].numel() * q6[0][f].element_size()
             for f in ("qs", "qh", "es"))
    _versus_plain(res, "q6_stream", f"N={n6}, q6_probe's operands (2 copies)",
                  lambda i: probes.q6_stream(q6[i % 2]["qs"], q6[i % 2]["qh"],
                                             q6[i % 2]["es"]), 1e-5,
                  spec.bound_ms(b6 + 4 * n6, 3 * 128 * n6, "f32"),
                  headline=True)
    _versus_plain(res, "q6_bits2", f"N={n6}, q6_probe's operands (2 copies)",
                  lambda i: probes.q6_bits2(q6[i % 2]["qh"], q6[i % 2]["xc"],
                                            q6[i % 2]["es"]), 1e-4,
                  spec.bound_ms(n6 * (1024 + 512 + 4), 8 * 1024 * n6, "f32"),
                  headline=True)
    for seg in (False, True):
        _versus_plain(res, "q6_nib_lhs", f"N={n6}, seg={seg}",
                      lambda i, seg=seg: probes.q6_nib_lhs(q6[i % 2]["qs"],
                                                           seg), 0.0,
                      spec.bound_ms(n6 * (2048 + 4096), n6 * 2048, "int8"),
                      headline=not seg, scale=1.0)
    z = [torch.randint(-2 ** 20, 2 ** 20, (n6, 256), dtype=torch.int32,
                       device=dev) for _ in range(2)]
    _versus_plain(res, "q6_nib_fold", f"N={n6}, z int32 [N, 256]",
                  lambda i: probes.q6_nib_fold(z[i % 2], z[i % 2][:, 128:],
                                               q6[i % 2]["es"]), 1e-4,
                  spec.bound_ms(n6 * (1024 + 512 + 4), 2 * 256 * n6, "f32"),
                  headline=True)
    del z
    for mode in ("nib_global", "nib_seg"):
        fns = [q6_probe.rung(mode, q6[j]) for j in range(2)]
        wts = [(q6[j]["qs"], q6[j]["qh"], q6[j]["es"]) for j in range(2)]
        got = fns[0](wts[0])
        with plain_versions():
            ref = fns[0](wts[0])
        err, sc = rel_err(got, ref)
        if err > 1e-4 * sc:
            raise AssertionError(f"{mode}: {err} vs {sc}")
        macs = n6 * 2 * 2048 * (256 if mode == "nib_global" else 128)
        composite[f"{mode}_ms"] = ms = time_ms(lambda i: fns[i % 2](
            wts[i % 2]), calls=10, replays=3)
        b_ms, b_by = spec.bound_ms(b6 + 4 * n6, 2 * macs, "int8")
        composite[f"{mode}_bound_ms"] = b_ms
        log(f"  {mode} (q6_nib_lhs + matmul int8 + q6_nib_fold): max_abs_err"
            f" {err:.3e} (bound 1e-4*{sc:.3e}); {ms:.4f} ms, least "
            f"{b_ms:.4f} ms ({b_by})")
    del q6

    def f32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    x32 = f32(np.arange(32 * 128).reshape(32, 128))
    eye = torch.eye(32, device=dev)
    pad = torch.zeros((128, 128), device=dev)
    pad[:, :32] = f32(np.arange(128 * 32).reshape(128, 32))
    row = f32(np.arange(4096).reshape(1, 4096))
    small = f32(np.arange(8 * 128).reshape(8, 128))
    for name, fn, arg, lib in (
            ("transpose_dot", lambda i: mp.transpose_dot(x32, eye), x32,
             lambda i: torch.matmul(x32.T, eye)),
            ("lane_concat", lambda i: mp.lane_concat(pad), pad,
             lambda i: torch.cat([pad[32 * c:32 * c + 32, :32]
                                  for c in range(4)], 1)),
            ("roll64", lambda i: mp.roll64(x32), x32,
             lambda i: torch.roll(x32, 64, 1)),
            ("dyn_sublane", lambda i: mp.dyn_sublane(x32), x32,
             lambda i: x32 * 2.0),
            ("lane_extract", lambda i: mp.lane_extract(row), row,
             lambda i: row.reshape(32, 128).clone()),
            ("read_output", lambda i: mp.read_output(small), small, None),
            ("tiny_call", lambda i: mp.tiny_call(small), small,
             lambda i: small * 1.0001)):
        nb = 2 * arg.numel() * 4 * (2 if name == "read_output" else 1)
        _versus_plain(res, f"mosaic_{name}", f"{tuple(arg.shape)} f32", fn,
                      0.0, spec.bound_ms(nb, arg.numel(), "f32"),
                      headline=True, library=lib, scale=1.0)
        if name in ("dyn_sublane", "lane_extract", "tiny_call"):
            _pairs(f"mosaic_{name}", f"{tuple(arg.shape)} f32", fn, lib)
    return composite


def phase_lse_kernel(dev, seed, res: Results):
    """#14's lse residual: flash_attention(return_residuals=True) against
    its plain version (o 1e-2 * max, lse 1e-4 * max|lse| where finite and
    -inf exactly where every key is masked) at ring attention's 7B shapes:
    one ring step at seq = 2 (H 32, D 128, Sq = Sk = 256) with the causal
    block mask and with a block wholly in the future, and Sq = Sk = 512
    causal; the bound, and one PyTorch call computing o and the
    log-sum-exp (the memory-efficient SDPA with compute_log_sumexp) where
    it runs."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    log("== 4i. flash_attention's lse output (#14's residual) vs plain "
        "versions on the card")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    spec = _spec()
    H, D = 32, 128
    for S, kind in ((256, "ring block mask"), (256, "future block"),
                    (512, "causal")):
        q, k, v = (torch.randn((1, H, S, D), generator=g, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        pos = torch.arange(S, device=dev)
        mask, causal = None, kind == "causal"
        if kind == "ring block mask":
            mask = torch.where(pos[None, :] <= pos[:, None], 0.0,
                               -torch.inf)[None, None]
        elif kind == "future block":
            mask = torch.full((1, 1, S, S), -torch.inf, device=dev)

        def fn(i):
            return fa.flash_attention(q, k, v, mask, causal=causal,
                                      return_residuals=True)

        o, lse = fn(0)
        with plain_versions():
            ro, rlse = fn(0)
        dead = torch.isneginf(rlse)
        if not torch.equal(torch.isneginf(lse), dead) or o[dead].any():
            raise AssertionError(f"flash_attention_lse {kind}: -inf rows or "
                                 "their o differ from the plain version")
        live = ~dead
        lerr = float((lse[live] - rlse[live]).abs().max()) if live.any() \
            else 0.0
        lsc = float(rlse[live].abs().max()) if live.any() else 1.0
        if not lerr <= 1e-4 * lsc:
            raise AssertionError(f"flash_attention_lse {kind}: lse error "
                                 f"{lerr} > 1e-4 * {lsc}")
        err, sc = rel_err(o, ro)
        ms = time_ms(fn)
        with plain_versions():
            pms = time_ms(fn, calls=4, replays=3)
        # what this run's data needs: the visible (query, key) pairs
        vis = (S * (S + 1) // 2 if kind != "future block" else 0)
        nbytes = 2 * 4 * H * S * D + 4 * H * S + (
            4 * S * S if mask is not None else 0)
        lib = None
        try:
            # the memory-efficient SDPA returns o and the log-sum-exp; it
            # takes an additive bias in q's dtype (-inf rows give NaN
            # there, not 0)
            bias = None if mask is None else mask.expand(1, H, S, S).to(
                q.dtype)
            lib = time_ms(lambda i: torch.ops.aten.
                          _scaled_dot_product_efficient_attention(
                              q, k, v, bias, True, 0.0, causal))
        except RuntimeError as e:
            log(f"    _scaled_dot_product_efficient_attention with "
                f"compute_log_sumexp does not run here: {e}")
        res.add("flash_attention_lse", f"H={H} S={S} D={D} {kind}",
                err, sc, 1e-2, ms, pms,
                spec.bound_ms(nbytes, 4 * H * vis * D, "bf16"),
                headline=kind == "causal", library_ms=lib)
        log(f"    lse max_abs_err {lerr:.3e} (bound 1e-4 * {lsc:.3e}); "
            f"rows with no visible key {int(dead.sum())}; "
            f"{_rate(nbytes, 4 * H * vis * D, ms)}")
        del q, k, v


def _tables():
    from ggml_cuda_experiments_tpu_torch.ops import (
        flash_attention as fa, flash_decode as fd, fused_attention as fat,
        layer_kernel as lk, matmul as mm, paged_attention as pa,
        prefill_fuse as pf, primitives as pr, quant_matmul as qm,
        vpu_attention as va, probes as pb, mosaic_probes as mp)
    return (qm.LAUNCHES, fd.LAUNCHES, fa.LAUNCHES, pf.LAUNCHES, pa.LAUNCHES,
            fat.LAUNCHES, lk.LAUNCHES, mm.LAUNCHES, pr.LAUNCHES, va.LAUNCHES,
            pb.LAUNCHES, mp.LAUNCHES)


def _reset_counts():
    for table in _tables():
        for key in table:
            table[key] = 0


def _counts():
    out = {}
    for table in _tables():
        out.update(table)
    return out


def _forced_forward(params, cfg, tokens, caches, decode):
    """One step of the model on the kernel path, with every layer and the
    head also run through the plain versions on the kernel path's input.
    A MoE layer's MLP is forced too: the plain MLP takes the kernel path's
    MLP input, so both take one routing (a top-k choice is discrete: an
    ulp of the attention's output may swap a near-tied expert, which is no
    kernel's error). caches: (kernel cache, plain cache). Returns
    (per-layer max error relative to max|plain|, (kernel logits, plain
    logits))."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    ck, cp = caches
    T = tokens.shape[1]
    if decode:
        positions = ck.lengths[:, None].clone()
    else:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None]
    h = params["embed"][tokens]
    worst = []
    for li, layer in enumerate(params["layers"]):
        def block(cache, h=h, li=li, layer=layer, mlp_in=None):
            a, _ = llama._attention_block(layer, cfg, h, cache, li,
                                          positions, decode=decode)
            x = h + a
            return x, x + llama._mlp_block(layer, cfg,
                                           x if mlp_in is None else mlp_in)
        xk, hk = block(ck)
        with plain_versions():
            _, hp = block(cp, mlp_in=xk if "router" in layer else None)
        worst.append(float((hk - hp).float().abs().max()
                           / hp.float().abs().max()))
        h = hk
    hn = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)[:, -1]
    lk = llama.apply_linear(hn, params["lm_head"], cfg.x_quant8).float()
    with plain_versions():
        lp = llama.apply_linear(hn, params["lm_head"], cfg.x_quant8).float()
    for c in caches:
        c.lengths += T
    return worst, (lk, lp)


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def _profiled(fn):
    """fn() under torch.profiler, ending in a device sync. Returns (the
    profile, wall us, device-busy us, kernel rows by device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only (the aten rows carry their kernels' time again)
    events = sorted((e for e in prof.key_averages()
                     if str(e.device_type).endswith("CUDA")),
                    key=_dev_us, reverse=True)
    return prof, wall_us, sum(_dev_us(e) for e in events), events


def _log_top(events, per, unit, n=10):
    for e in events[:n]:
        if _dev_us(e) > 0:
            log(f"    {_dev_us(e) / per:9.1f} us/{unit}  {e.count // per:5d}"
                f" calls/{unit}  {e.key[:70]}")


def _profile_prefill(params, cfg, prompt, request, dev):
    """torch.profiler over one prefill of ``prompt`` into a fresh cache of
    ``request`` (prompt, generated): its wall time, the device's busy share
    of it, and the dequantizing GEMMs' part of the busy time."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    cache = _cache(cfg, *request, dev, {})
    _, wall_us, busy, events = _profiled(
        lambda: llama.prefill(params, cfg, prompt, cache))
    gemm = sum(_dev_us(e) for e in events
               if "gemm_stream_kernel" in e.key or "gemm_tc_kernel" in e.key)
    log(f"  prefill of {prompt.shape[1]} tokens under torch.profiler: wall "
        f"{wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}%), the dequantizing GEMMs "
        f"{gemm / 1e3:.2f} ms of it")
    _log_top(events, 1, "prefill", n=5)


def _profile_decode(params, cfg, prompt, dev, trace_dir, tag="generate",
                    steps: int = 4):
    """torch.profiler over a few decode steps: device time by kernel and
    the device's busy share of the wall time; Chrome trace to trace_dir."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    cache = llama.KVCache.create(cfg, 1, 256, device=dev)
    logits, cache = llama.prefill(params, cfg, prompt, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    for _ in range(2):
        logits, cache = llama.decode_step(params, cfg, tok, cache)

    def run():
        t = tok
        for _ in range(steps):
            lg, _ = llama.decode_step(params, cfg, t, cache)
            t = torch.argmax(lg, -1).to(torch.int32)

    prof, wall_us, busy, events = _profiled(run)
    log(f"  profile ({tag}): {steps} decode steps, wall "
        f"{wall_us / steps:.1f} us/step,"
        f" device busy {busy / steps:.1f} us/step "
        f"({100 * busy / wall_us:.1f}% of wall)")
    _log_top(events, steps, "step")
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"decode_trace_{tag}.json")
    prof.export_chrome_trace(path)
    log(f"  trace: {path}")


def _cache(cfg, p, n, dev, cache_kw):
    """A cache for a request of prompt p and n generated tokens, as
    ``generate`` sizes it; ``cache_kw`` e.g. quantized="int8"."""
    from ggml_cuda_experiments_tpu_torch.models import llama
    return llama.KVCache.create(cfg, 1, llama._round_up(p + n, 256),
                                device=dev, **cache_kw)


def _drive_generate(params, cfg, prompts, requests, path, cache_kw=None):
    """One greedy ``generate`` per request, the launch counts set to 0 just
    before and read just after (the caches of ``cache_kw`` are made before
    that). Returns (tokens per request, counts)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    caches = [_cache(cfg, p, n, prompt.device, cache_kw) if cache_kw else None
              for (p, n), prompt in zip(requests, prompts)]
    torch.cuda.synchronize()
    _reset_counts()
    outs = []
    for (p, n), prompt, cache in zip(requests, prompts, caches):
        ts = time.perf_counter()
        toks = llama.generate(params, cfg, prompt, steps=n, cache=cache)
        te = time.perf_counter()
        if toks.shape != (1, n) or not ((toks >= 0)
                                        & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{path}: generate gave {toks.shape} / "
                                 "out-of-range tokens")
        outs.append(toks)
        log(f"  {path}: generate(prompt {p}, gen {n}): {te - ts:.3f} s "
            f"wall, tokens {toks[0, :8].tolist()}...")
    return outs, _counts()


def _prefill_counts(L, requests, rope=True, gemm="q4k_gemm"):
    """Launches of the prefills of ``requests`` (prompts of 2-512 tokens):
    4 ``gemm`` (the layers' format's) and one flash_attention per layer,
    rope_pack per layer at prompts of a multiple of 128 tokens where its
    gate is open (``rope``: head_dim 128 and a bf16 cache); every other
    kernel 0."""
    want = {k: 0 for k in _counts()}
    want.update(
        {gemm: sum(4 * L for p, _ in requests if 2 <= p <= 512)},
        flash_attention=L * len(requests),
        rope_pack=sum(L for p, _ in requests if rope and p % 128 == 0))
    return want


def _rope_tables_once(builds, L, requests, dev, cfg):
    """The prefills of ``requests`` made the RoPE tables once each where
    rope_pack runs (prompts of a multiple of 128 tokens), not once a layer:
    asserted; the PyTorch launches one making takes (torch.profiler) and so
    the launches a prefill saves, L - 1 of them, logged."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
    want = sum(1 for p, _ in requests if p % 128 == 0)
    if builds != want:
        raise AssertionError(f"rope tables made {builds} times for {want} "
                             "prefills through rope_pack")
    pos = torch.arange(512, dtype=torch.int32, device=dev)
    pf.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    _, _, _, events = _profiled(
        lambda: pf.rope_tables(pos, cfg.head_dim, cfg.rope_theta))
    n = sum(e.count for e in events)
    if n < 1:
        raise AssertionError("rope_tables launched no kernel on the card")
    log(f"  rope tables made {builds} times for the {want} prefills through "
        f"rope_pack (once a prefill, asserted; {want * L} before); one making "
        f"is {n} device kernels (torch.profiler), so a prefill launches "
        f"{(L - 1) * n} fewer")


def _assert_counts(path, counts, want):
    log(f"  launches in {path}: {counts}")
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != expected "
                             f"{want}")


def _time_requests(params, cfg, prompts, requests, outs, dev, cache_kw=None):
    """TTFT and decode rate per request through ``prefill`` and
    ``decode_step`` (host clock around work that ends in a device sync);
    the tokens must be ``generate``'s."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    timing = []
    for (p, n), prompt, toks in zip(requests, prompts, outs):
        cache = _cache(cfg, p, n, dev, cache_kw or {})
        torch.cuda.synchronize()
        ts = time.perf_counter()
        logits, cache = llama.prefill(params, cfg, prompt, cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        first = int(tok.item())
        ttft = time.perf_counter() - ts
        got = [first]
        td = time.perf_counter()
        for _ in range(n - 1):
            logits, cache = llama.decode_step(params, cfg, tok, cache)
            tok = torch.argmax(logits, -1).to(torch.int32)
            got.append(tok)
        torch.cuda.synchronize()
        dt = time.perf_counter() - td
        got = [got[0]] + [int(t.item()) for t in got[1:]]
        if got != toks[0].tolist():
            raise AssertionError(f"prefill/decode_step tokens differ from "
                                 f"generate's for prompt {p}")
        rate = (n - 1) / dt
        timing.append({"prompt": p, "gen": n, "ttft_ms": ttft * 1e3,
                       "decode_tok_s": rate})
        log(f"  request prompt {p} gen {n}: TTFT {ttft * 1e3:.2f} ms "
            f"(prefill + first token), decode {rate:.2f} tok/s over "
            f"{n - 1} steps")
    return timing


def _check_forced(params, cfg, prompt, forced, dev, cache_kw=None,
                  tol=2e-2):
    """The prompt, then each token of ``forced`` as a decode step, through
    ``_forced_forward``: every layer and the head against the plain
    versions on the kernel path's own input (``tol`` * max), on two caches
    made with ``cache_kw``."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    caches = [llama.KVCache.create(cfg, 1, 256, device=dev, **(cache_kw or {}))
              for _ in "kp"]
    failed = []
    for step in range(len(forced) + 1):
        decode = step > 0
        toks = forced[step - 1:step, None] if decode else prompt
        worst, (lk, lp) = _forced_forward(params, cfg, toks, caches, decode)
        if lk.shape != (1, cfg.vocab_size) or not torch.isfinite(lk).all():
            raise AssertionError(f"logits shape {tuple(lk.shape)} or "
                                 "non-finite")
        err, sc = float((lk - lp).abs().max()), float(lp.abs().max())
        tag = "prefill" if step == 0 else f"decode {step}"
        li, lerr = max(enumerate(worst), key=lambda t: t[1])
        ok = err <= tol * sc and lerr <= tol
        log(f"  teacher-forced {tag:9s} logits max_abs_err {err:.4e} vs "
            f"{tol:g}*{sc:.4e}; worst layer {li}: {lerr:.3e} of max "
            f"(bound {tol:g}); argmax {int(lk.argmax())} / "
            f"{int(lp.argmax())} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{tag}: logits {err} vs {sc}, layer {li} {lerr}")
    if failed:
        raise AssertionError(f"teacher-forced check: {failed}")


def phase_model(dev, seed, profile=None):
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    cfg = PRESETS["llama2-7b"]
    L = cfg.n_layers
    log(f"== 5. main path: {cfg.name} dim {cfg.dim}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, q4_k, bf16 KV cache, greedy, the "
        f"preset's decode (fused MLP)")
    t0 = time.perf_counter()
    dense = llama.init_weights(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params = llama.quantize_params(dense, "q4_k")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    head_dense = dense["lm_head"]            # requantized to q6_k in 5c
    del dense
    torch.cuda.empty_cache()
    qbytes = sum(w.nbytes for layer in params["layers"]
                 for w in layer.values() if hasattr(w, "nbytes"))
    qbytes += params["lm_head"].nbytes
    log(f"  init_weights {t1 - t0:.3f} s, quantize_params {t2 - t1:.3f} s; "
        f"quantized linears {qbytes / 1e9:.3f} GB; w_down K = "
        f"{params['layers'][0]['w_down'].shape[1]}")

    g = torch.Generator(device=dev).manual_seed(seed + 2)
    prompts = [torch.randint(1, cfg.vocab_size, (1, p), generator=g,
                             device=dev, dtype=torch.int64)
               for p, _ in REQUESTS]
    from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
    builds = pf.BUILDS["rope_tables"]
    outs, counts = _drive_generate(params, cfg, prompts, REQUESTS, "generate")
    _rope_tables_once(pf.BUILDS["rope_tables"] - builds, L, REQUESTS, dev,
                      cfg)
    decode_steps = sum(n for _, n in REQUESTS)
    want = _prefill_counts(L, REQUESTS)
    want.update(
        # per prefill the head; per decode step wqkv, wo and the head
        q4k_matvec=len(REQUESTS) + decode_steps * (2 * L + 1),
        fused_mlp=decode_steps * L, flash_decode=decode_steps * L,
        lse_merge=decode_steps * L)
    _assert_counts("generate", counts, want)
    log("  launch counts equal what the path implies (per decode step "
        f"{2 * L + 1} q4k_matvec, {L} fused_mlp, {L} flash_decode; per "
        f"prefill {4 * L} q4k_gemm, {L} rope_pack at prompts 128 and 512, "
        "0 at 16)")
    timing = _time_requests(params, cfg, prompts, REQUESTS, outs, dev)
    _profile_prefill(params, cfg, prompts[-1], REQUESTS[-1], dev)

    # teacher-forced against the plain versions on the card, same weights:
    # request 1's prompt, then its first 4 generated tokens. Forced at the
    # hidden state too: every layer (and the head) runs through the plain
    # versions on the kernel path's own input, so each comparison sees the
    # kernels' error at that stage, not 32 layers of compounded bf16
    # rounding flips (those are printed below, free-running).
    forced = torch.from_numpy(outs[0][0, :4]).to(dev, torch.int32)
    _check_forced(params, cfg, prompts[0], forced, dev)

    def free_run():
        cache = llama.KVCache.create(cfg, 1, 256, device=dev)
        seq = [llama.prefill(params, cfg, prompts[0], cache)[0]]
        for i in range(4):
            seq.append(llama.decode_step(params, cfg, forced[i:i + 1],
                                         cache)[0])
        return seq

    kern = free_run()
    with plain_versions():
        plain = free_run()
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(kern, plain)]
    log("  free-running (token-forced only) logits, max_abs_err / max|ref|: "
        + " ".join(f"{r:.3e}" for r in rel))
    if profile:
        _profile_decode(params, cfg, prompts[0], dev, profile)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return counts, timing, params, prompts, head_dense


def _forced_fused(params, m_pack, cfg, tok, cache):
    """One decode step of the layer kernel forced layer by layer: every
    layer_step launch against its plain version on the kernel path's own
    input; model_step against those launches chained with h in f32; the
    head (int8 activations) on the kernel path's h, kernel against plain;
    and, printed only, the plain chain run free from the same embedding.
    Returns (per-layer max error relative to max|plain|, model_step's max
    difference from the chain, (kernel logits, plain logits), free-running
    logits error relative to max|plain|)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              rms_eps=cfg.rms_eps)
    args = (cache.k, cache.v, cache.lengths)
    h0 = params["embed"][tok].float()               # [1, dim]
    h, hp_free, worst = h0, h0, []
    for li, layer in enumerate(params["layers"]):
        pack = lk.pack_layers([layer])
        hk = lk.layer_step(h, pack, *args, li, **kw)[0]
        with plain_versions():
            hp = lk.layer_step(h, pack, *args, li, **kw)[0]
            hp_free = lk.layer_step(hp_free, pack, *args, li, **kw)[0]
        worst.append(float((hk - hp).abs().max() / hp.abs().max()))
        h = hk
    hm = lk.model_step(h0, m_pack, *args, **kw)[0]
    chain_diff = float((hm - h).abs().max())

    def head(x):
        x = llama.rms_norm(x.to(params["embed"].dtype), params["final_norm"],
                           cfg.rms_eps)
        return llama.apply_linear(x, params["lm_head"], cfg.x_quant8).float()
    lk_logits = head(hm)
    with plain_versions():
        lp_logits, free = head(hm), head(hp_free)
    free_err = float((lk_logits - free).abs().max() / free.abs().max())
    return worst, chain_diff, (lk_logits, lp_logits), free_err


def phase_fused_decode(dev, seed, params, prompts, res: Results, card,
                       profile=None):
    """bench.py's batch-1 decode configuration and its two siblings."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
    base = PRESETS["llama2-7b"]
    L = base.n_layers
    cfg = dataclasses.replace(base, x_quant8=True, hperm=True)
    log(f"== 5b. bench.py's decode: {cfg.name}, x_quant8, hperm "
        "(permute_hidden_params: the model pack, no weight copy), "
        "model_step per decode step")
    t0 = time.perf_counter()
    pb = llama.permute_hidden_params(params, cfg)
    if "m_pack" not in pb:
        raise AssertionError("permute_hidden_params built no model pack")
    log(f"  model pack in {time.perf_counter() - t0:.3f} s: "
        f"{pb['m_pack'].ptrs.numel()} pointers, "
        f"{pb['m_pack'].norms.numel() * 4} bytes of f32 norms")
    outs, counts = _drive_generate(pb, cfg, prompts, REQUESTS,
                                   "generate bench config")
    steps = sum(n for _, n in REQUESTS)
    want = _prefill_counts(L, REQUESTS)
    want.update(q4k_q8_matvec=len(REQUESTS) + steps, model_step=steps)
    _assert_counts("generate bench config", counts, want)
    log("  launch counts equal what the path implies (per decode step 1 "
        "model_step and 1 q4k_q8_matvec; per prefill 1 q4k_q8_matvec for "
        "the head)")
    timing = _time_requests(pb, cfg, prompts, REQUESTS, outs, dev)
    paths = {"generate_xq8_hperm": counts}

    # the siblings on one request: x_quant8 alone (fused attention + fused
    # MLP per layer) and the per-layer kernel (layer_step per layer)
    (p1, n1), prompt = REQUESTS[1], prompts[1:2]
    sib = ((p1, n1),)
    per_layer = dict({k: v for k, v in pb.items() if k != "m_pack"},
                     layers=[dict(lay, w_pack=lk.pack_layers([lay]))
                             for lay in pb["layers"]])
    for path, tree, c, per_step in (
            ("generate x_quant8", params,
             dataclasses.replace(base, x_quant8=True),
             {"fused_attention": L, "fused_mlp": L}),
            ("generate per-layer", per_layer, cfg, {"layer_step": L})):
        (toks,), counts = _drive_generate(tree, c, prompt, sib, path)
        want = _prefill_counts(L, sib)
        want.update(q4k_q8_matvec=1 + n1,
                    **{k: v * n1 for k, v in per_step.items()})
        _assert_counts(path, counts, want)
        same = int((toks[0] == outs[1][0]).sum())
        first = toks[0, 0] == outs[1][0, 0]
        log(f"  {path}: first token {'equals' if first else 'DIFFERS from'}"
            f" model_step's (same prefill); {same}/{n1} tokens equal, free "
            "running")
        if not first:
            raise AssertionError(f"{path}: the first token differs")
        paths[path.replace(" ", "_").replace("-", "_")] = counts

    # x_quant8 alone (fused_attention + fused_mlp a layer) through
    # generate_scan: ms a token, the marginal of 8 and 40 replays of one
    # captured step after request 1's prefill (the spec_bench method);
    # LAUNCHES counts the prefill, the eager step and its capture
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    xq8 = dataclasses.replace(base, x_quant8=True)
    torch.cuda.synchronize()
    _reset_counts()
    t_tok = sb.plain_per_token(params, xq8, prompts[0])
    torch.cuda.synchronize()
    counts = _counts()
    log(f"  [{card}] generate_scan x_quant8 (fused_attention + fused_mlp): "
        f"{t_tok * 1e3:.3f} ms/token ({1 / t_tok:.1f} tok/s; marginal of 8 "
        "and 40 replays of one captured step)")
    want = _prefill_counts(L, ((REQUESTS[0][0], 1),))
    want.update(q4k_q8_matvec=1 + 2, fused_attention=2 * L,
                fused_mlp=2 * L)
    _assert_counts("generate_scan x_quant8 (the prefill, one eager step "
                   "and its capture; 96 replays uncounted)", counts, want)
    paths["generate_scan_x_quant8"] = counts

    _model_step_check(pb, cfg, prompts[2], dev, res, card, headline=True)
    _layer_probe(card)
    if profile:
        _profile_decode(pb, cfg, prompts[0], dev, profile, "model_step")
    return paths, timing


def _model_step_check(pb, cfg, prompt, dev, res: Results, card,
                      headline=False):
    """bench.py's decode step (``model_step``, every layer in one launch)
    after ``prompt``'s prefill, forced layer by layer (``_forced_fused``:
    each layer_step within 5e-3 * max of its plain version on the kernel
    path's input, model_step equal to the chained launches, the head's
    logits within 2e-2 * max); then model_step's time at that cache beside
    its bound."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import layer_kernel as lk
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    L = cfg.n_layers
    cache = llama.KVCache.create(
        cfg, 1, llama._round_up(prompt.shape[1] + 1, 256), device=dev)
    logits, cache = llama.prefill(pb, cfg, prompt, cache)
    tok = torch.argmax(logits, -1)
    worst, chain_diff, (lk_, lp_), free_err = _forced_fused(
        pb, pb["m_pack"], cfg, tok, cache)
    err, sc = float((lk_ - lp_).abs().max()), float(lp_.abs().max())
    li, lerr = max(enumerate(worst), key=lambda t: t[1])
    length = int(cache.lengths[0]) + 1
    ok = (lk_.shape == (1, cfg.vocab_size) and bool(torch.isfinite(lk_).all())
          and err <= 2e-2 * sc and lerr <= 5e-3 and chain_diff == 0.0)
    log(f"  {cfg.name}: forced decode step at length {length - 1}: worst "
        f"layer_step {li}: {lerr:.3e} of max (bound 5e-3); model_step vs "
        f"the chained layer_step launches max diff {chain_diff:.3e} (must be "
        f"0); head logits max_abs_err {err:.4e} vs 2e-2*{sc:.4e}; argmax "
        f"{int(lk_.argmax())} / {int(lp_.argmax())}; the plain chain run "
        f"free: logits {free_err:.3e} of max (printed) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"forced fused decode: layer {li} {lerr}, "
                             f"chain {chain_diff}, logits {err} vs {sc}")

    # model_step's time at this cache (every layer, one launch)
    spec = _spec()
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              rms_eps=cfg.rms_eps)
    h0 = pb["embed"][tok].float()
    args = (h0, pb["m_pack"], cache.k, cache.v, cache.lengths)
    ms = time_ms(lambda i: lk.model_step(*args, **kw), calls=5, replays=3)
    with plain_versions():
        pms = time_ms(lambda i: lk.model_step(*args, **kw), calls=1,
                      replays=1)
    wbytes = sum(lay[k].nbytes for lay in pb["layers"] for k in lk.STREAM)
    ops = 2 * L * sum(pb["layers"][0][k].array_shape[0]
                      * pb["layers"][0][k].array_shape[1] for k in lk.STREAM)
    kv = 2 * L * cfg.n_kv_heads * length * cfg.head_dim * 2
    hm = lk.model_step(*args, **kw)[0]
    with plain_versions():
        hp = lk.model_step(*args, **kw)[0]
    e, s_ = rel_err(hm, hp)
    kd = pb["layers"][0]["w_down"].array_shape[1]
    log(f"  [{card}] model_step, {cfg.name}, {L} layers (Kd {kd}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}) at length {length}: "
        f"{wbytes / 1e9:.3f} GB of weights, {kv / 1e6:.1f} MB of K/V; "
        f"against its plain version run free over the {L} layers "
        f"{e:.3e} (max {s_:.3e}, printed)")
    # its error: the forced per-layer check above (the chain is exact)
    res.add("layer_kernel",
            f"{cfg.name} model_step, {L} layers, len {length}",
            lerr, 1.0, 5e-3, ms, pms,
            spec.bound_ms(wbytes + kv + 8 * cfg.dim, ops, "int8"),
            headline=headline)


def _layer_probe(card):
    """tools/layer_probe.py's variant table: one 7B layer (random q4_k
    weights, bf16 cache of 1024) at lengths 57 and 513, us a layer beside
    its byte bound (measurement-only variants, outside any counted path)."""
    from ggml_cuda_experiments_tpu_torch.tools import layer_probe
    log(f"  [{card}] layer_probe: the layer kernel's phase variants and "
        "mega2 (fused_attention + fused_mlp), 10 calls a graph, median of 5")
    rows = layer_probe.run(layer_probe.parse(["--lengths", "57,513",
                                              "--calls", "10"]))
    alls = {r["length"]: r["us"] for r in rows if r["variant"] == "all"}
    for r in rows:
        log(f"    {r['variant']:9s} len {r['length']:4d}: {r['us']:7.1f} us "
            f"a layer ({r['us'] - alls[r['length']]:+6.1f} vs all), bound "
            f"{r['bound_us']:.1f} us")


def _log_stream(params):
    """The quantized weights a batch-1 decode step reads (every layer's
    linears and the head), and the rate they cap decode at."""
    wbytes = params["lm_head"].nbytes + sum(
        w.nbytes for layer in params["layers"] for w in layer.values()
        if hasattr(w, "nbytes"))
    log(f"  weights per decode token {wbytes / 1e9:.4f} GB: at most "
        f"{_spec().hbm_bytes_per_s / wbytes:.0f} tok/s at the HBM rate")


def phase_q4km(dev, seed, params, head_dense, prompts):
    """The Q4_K_M mix on llama2-7b: phase 5's q4_k layers with the head
    requantized to q6_k (what ``quantize_params(.., "q4_k",
    head_fmt="q6_k")`` makes of it), through ``generate`` in the preset's
    configuration, in bench.py's, and on an int8 cache, then through the
    ``Engine``."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    base = PRESETS["llama2-7b"]
    L, R = base.n_layers, len(REQUESTS)
    steps = sum(n for _, n in REQUESTS)
    log(f"== 5c. the Q4_K_M mix: {base.name}, q4_k layers, q6_k head")
    t0 = time.perf_counter()
    pq = dict(params, lm_head=qm.quantize(head_dense.float(), "q6_k"))
    torch.cuda.synchronize()
    log(f"  lm_head to q6_k in {time.perf_counter() - t0:.3f} s: "
        f"{pq['lm_head'].nbytes} bytes (q4_k: {params['lm_head'].nbytes})")
    _log_stream(pq)
    head = dict(q6k_q8_matvec=R + steps)      # per prefill, per step
    preset_step = dict(q4k_matvec=steps * 2 * L, fused_mlp=steps * L,
                       lse_merge=steps * L)
    bench = dataclasses.replace(base, x_quant8=True, hperm=True)
    int8 = dict(quantized="int8")
    paths, timing = {}, {}
    for path, tree, cfg, cache_kw, per_path in (
            ("generate_q4km", pq, base, {},
             dict(flash_decode=steps * L, **preset_step)),
            ("generate_q4km_xq8_hperm",
             llama.permute_hidden_params(pq, bench), bench, {},
             dict(model_step=steps)),
            ("generate_q4km_int8_cache", pq, base, int8,
             dict(flash_decode_q=steps * L, **preset_step))):
        outs, counts = _drive_generate(tree, cfg, prompts, REQUESTS,
                                       path.replace("_", " "), cache_kw)
        # a quantized cache closes the RoPE + repack kernel
        want = _prefill_counts(L, REQUESTS, rope=not cache_kw)
        want.update(**head, **per_path)
        _assert_counts(path, counts, want)
        paths[path] = counts
        timing[path] = _time_requests(tree, cfg, prompts, REQUESTS, outs,
                                      dev, cache_kw)
    log("  launch counts equal what the paths imply (the head: one "
        "q6k_q8_matvec per prefill and per decode step; the int8 cache: "
        "flash_decode_q, no rope_pack)")
    # the int8-cache path forced layer by layer against the plain versions:
    # request 1's prompt and its first 2 generated tokens
    forced = torch.from_numpy(outs[0][0, :2]).to(dev, torch.int32)
    _check_forced(pq, base, prompts[0], forced, dev, int8)
    # the engine: 4 requests of phase 6's shape
    g = torch.Generator().manual_seed(seed + 7)
    reqs = [torch.randint(1, base.vocab_size, (n,), generator=g).tolist()
            for n in (16, 100, 300, 512)]
    _, paths["engine_q4km"], _ = _drive_engine(
        pq, base, reqs, 8, "engine q4_k_m", **ENGINE_KW)
    return paths, timing


def _format_path(params, cfg, prompts, path, fmt, matvec, dev, L):
    """The three requests through ``generate`` on ``fmt`` layers and head
    with unfused decode: ``matvec`` per decode linear and per head row, the
    format's GEMM per prefill linear; counts asserted, then TTFT / decode
    rate. Returns (tokens per request, counts, timing)."""
    steps = sum(n for _, n in REQUESTS)
    outs, counts = _drive_generate(params, cfg, prompts, REQUESTS, path)
    want = _prefill_counts(L, REQUESTS, gemm=FORMAT_KERNELS[fmt][1])
    want.update({matvec: len(REQUESTS) + steps * (4 * L + 1)},
                flash_decode=steps * L, lse_merge=steps * L)
    _assert_counts(path, counts, want)
    log(f"  launch counts equal what the path implies (per decode step "
        f"{4 * L + 1} {matvec}, {L} flash_decode; per prefill "
        f"{4 * L} {FORMAT_KERNELS[fmt][1]} and 1 {matvec} for the head)")
    return outs, counts, _time_requests(params, cfg, prompts, REQUESTS, outs,
                                        dev)


def phase_formats(dev, seed, prompts, card):
    """llama2-7b in Q8_0 (5e) and Q4_0 (5f), quantized on the card from
    phase 5's dense weights (made again from the seed, then freed), through
    ``generate`` in the preset's configuration and, for Q4_0, bench.py's;
    then the Engine on the Q4_0 weights over an int8 pool (6b)."""
    import collections
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    base = PRESETS["llama2-7b"]
    L = base.n_layers
    t0 = time.perf_counter()
    dense = llama.init_weights(base, seed=seed, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pq = {}
    for fmt in ("q8_0", "q4_0"):
        pq[fmt] = llama.quantize_params(dense, fmt)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    del dense
    torch.cuda.empty_cache()
    log(f"== 5e. {base.name} in Q8_0, the preset's configuration (unfused "
        "decode: no fused kernel takes q8_0)")
    log(f"  init_weights {t1 - t0:.3f} s, quantize_params q8_0 + q4_0 "
        f"{t2 - t1:.3f} s; [{card}]")
    paths, timing = {}, {}
    p8 = pq.pop("q8_0")
    _log_stream(p8)
    outs, paths["generate_q8_0"], timing["generate_q8_0"] = _format_path(
        p8, base, prompts, "generate q8_0", "q8_0", "q80_matvec", dev, L)
    forced = torch.from_numpy(outs[0][0, :2]).to(dev, torch.int32)
    _check_forced(p8, base, prompts[0], forced, dev)
    # generate_scan on the Q8_0 weights: ms a token, the marginal of 8 and
    # 40 replays of one captured step after request 1's prefill (the
    # spec_bench method, as 5b); LAUNCHES counts the prefill, the eager
    # step and its capture
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    torch.cuda.synchronize()
    _reset_counts()
    t_tok = sb.plain_per_token(p8, base, prompts[0])
    torch.cuda.synchronize()
    counts = _counts()
    log(f"  [{card}] generate_scan q8_0: {t_tok * 1e3:.3f} ms/token "
        f"({1 / t_tok:.1f} tok/s; marginal of 8 and 40 replays of one "
        "captured step)")
    want = _prefill_counts(L, ((REQUESTS[0][0], 1),), gemm="q80_gemm")
    want.update(q80_matvec=1 + 2 * (4 * L + 1), flash_decode=2 * L,
                lse_merge=2 * L)
    _assert_counts("generate_scan q8_0 (the prefill, one eager step and its "
                   "capture; 96 replays uncounted)", counts, want)
    paths["generate_scan_q8_0"] = counts
    timing["generate_scan_q8_0"] = {"ms_per_token": t_tok * 1e3}
    del p8, outs
    torch.cuda.empty_cache()

    log(f"== 5f. {base.name} in Q4_0: the preset's configuration and "
        "bench.py's (x_quant8 + permute_hidden_params: no model pack, int8 "
        "activations on every linear)")
    p4 = pq.pop("q4_0")
    _log_stream(p4)
    outs, paths["generate_q4_0"], timing["generate_q4_0"] = _format_path(
        p4, base, prompts, "generate q4_0", "q4_0", "q40_matvec", dev, L)
    # forced in the preset's configuration: under x_quant8 a one-ulp
    # difference before an int8 rounding moves a whole step, so there the
    # per-layer bound measures the activation quantization, not the
    # kernels (q40_q8_matvec is held to its plain version in phase 4e)
    forced = torch.from_numpy(outs[0][0, :2]).to(dev, torch.int32)
    _check_forced(p4, base, prompts[0], forced, dev)
    bench = dataclasses.replace(base, x_quant8=True, hperm=True)
    pb = llama.permute_hidden_params(p4, bench)
    if "m_pack" in pb:
        raise AssertionError("q4_0: permute_hidden_params built a model pack")
    _, paths["generate_q4_0_xq8_hperm"], \
        timing["generate_q4_0_xq8_hperm"] = _format_path(
            pb, bench, prompts, "generate q4_0 bench config", "q4_0",
            "q40_q8_matvec", dev, L)

    log(f"== 6b. engine on the Q4_0 weights: int8 pool, 8 slots, prefill in "
        "128-token chunks")
    g = torch.Generator().manual_seed(seed + 11)
    reqs = [torch.randint(1, base.vocab_size, (n,), generator=g).tolist()
            for n in (16, 100, 300, 512)]
    rows = collections.Counter()
    gemm = qm.q40_gemm

    def tallied(x, w):                   # q40_gemm launches by rows
        rows[x.shape[0]] += 1
        return gemm(x, w)

    with contextlib.ExitStack() as stack:
        stack.callback(setattr, qm, "q40_gemm", gemm)
        qm.q40_gemm = tallied
        _, paths["engine_q4_0"], wall = _drive_engine(
            p4, base, reqs, 16, "engine q4_0", prefill_chunk=128,
            **ENGINE_KW)
    steps = paths["engine_q4_0"]["paged_decode"] // L
    log(f"  q40_gemm launches by rows: {dict(sorted(rows.items()))} "
        f"(M = 8 in each of the {steps} decode steps: {steps * (4 * L + 1)}"
        f" expected); {wall:.2f} s wall")
    if rows[8] != steps * (4 * L + 1):
        raise AssertionError(f"q40_gemm at M = 8: {rows[8]}")
    _check_forced_engine(p4, base, [torch.randint(
        1, base.vocab_size, (n,), generator=g).tolist()
        for n in ENGINE_PROMPTS[-8:]], dev)
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    del p4, pb
    torch.cuda.empty_cache()
    return paths, timing


def phase_tinyllama(dev, seed, card=None):
    """tinyllama-1.1b at full width and depth (22 layers, dim 2048, GQA
    32/4, head_dim 64, intermediate 5632), q4_k layers and a q6_k head:
    every fused gate and rope_pack stay closed, w_down (K = 5632) takes
    q4k_matvec at one row and the head q6k_matvec; then (5g) the same
    dense weights in Q8_0 and in Q4_0."""
    import collections
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    cfg = PRESETS["tinyllama-1.1b"]
    L, R = cfg.n_layers, len(REQUESTS)
    steps = sum(n for _, n in REQUESTS)
    log(f"== 5d. {cfg.name}: dim {cfg.dim}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, head_dim {cfg.head_dim}, "
        f"intermediate {cfg.intermediate}, q4_k layers, q6_k head, bf16 cache")
    t0 = time.perf_counter()
    dense = llama.init_weights(cfg, seed=seed + 8, device=dev)
    params = llama.quantize_params(dense, "q4_k", head_fmt="q6_k")
    torch.cuda.synchronize()
    log(f"  init_weights + quantize_params {time.perf_counter() - t0:.3f} s;"
        f" w_down {params['layers'][0]['w_down'].array_shape}, lm_head "
        f"{params['lm_head'].fmt} {params['lm_head'].array_shape}")
    _log_stream(params)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    prompts = [torch.randint(1, cfg.vocab_size, (1, p), generator=g,
                             device=dev, dtype=torch.int64)
               for p, _ in REQUESTS]
    def by_k_run(params, name, path):
        """generate on the three requests, with the launches of the
        wrapper ``name`` tallied by K."""
        by_k = collections.Counter()
        matvec = getattr(qm, name)

        def tallied(x, w):
            y = matvec(x, w)
            by_k[w.array_shape[1]] += 1
            return y

        with contextlib.ExitStack() as stack:
            stack.callback(setattr, qm, name, matvec)
            setattr(qm, name, tallied)
            outs, counts = _drive_generate(params, cfg, prompts, REQUESTS,
                                           path)
        log(f"  {name} launches by K: {dict(by_k)} (w_down at K = 5632: "
            f"{steps * L} expected)")
        return outs, counts, by_k

    outs, counts, by_k = by_k_run(params, "q4k_matvec", "generate tinyllama")
    want = _prefill_counts(L, REQUESTS, rope=False)
    want.update(q6k_matvec=R + steps, q4k_matvec=steps * 4 * L,
                flash_decode=steps * L, lse_merge=steps * L)
    _assert_counts("generate tinyllama", counts, want)
    if by_k != {2048: steps * 3 * L, 5632: steps * L}:
        raise AssertionError(f"q4k_matvec by K {by_k}")
    timing = {"generate_tinyllama": _time_requests(params, cfg, prompts,
                                                   REQUESTS, outs, dev)}
    forced = torch.from_numpy(outs[0][0, :4]).to(dev, torch.int32)
    _check_forced(params, cfg, prompts[0], forced, dev)
    paths = {"generate_tinyllama": counts}
    del params
    torch.cuda.empty_cache()

    # 5g: the same weights in Q8_0 and in Q4_0, the head too: every decode
    # linear and the head on the format's exact matvec (K = 2048 closes
    # x_quant8's gate, and the preset has it off), w_down at K = 5632
    for fmt in ("q8_0", "q4_0"):
        matvec, gemm = FORMAT_KERNELS[fmt]
        log(f"== 5g. {cfg.name} in {fmt.upper()}: w_down at K = 5632 on "
            f"{matvec}")
        pf = llama.quantize_params(dense, fmt)
        _log_stream(pf)
        path = f"generate_tinyllama_{fmt}"
        outs, counts, by_k = by_k_run(pf, matvec, f"generate tinyllama {fmt}")
        want = _prefill_counts(L, REQUESTS, rope=False, gemm=gemm)
        want.update({matvec: steps * (4 * L + 1) + R},
                    flash_decode=steps * L, lse_merge=steps * L)
        _assert_counts(path, counts, want)
        if by_k != {2048: steps * (3 * L + 1) + R, 5632: steps * L}:
            raise AssertionError(f"{matvec} by K {by_k}")
        paths[path] = counts
        timing[path] = _time_requests(pf, cfg, prompts, REQUESTS, outs, dev)
        forced = torch.from_numpy(outs[0][0, :2]).to(dev, torch.int32)
        _check_forced(pf, cfg, prompts[0], forced, dev)
        del pf
    if card is not None:
        # 9 (decode): the benchmark entry on these weights in bench.py's
        # format, q4_k with a q4_k head
        b_paths, timing["bench_decode_tinyllama"] = phase_bench_decode(
            dev, llama.quantize_params(dense, "q4_k"), cfg.name, card)
        paths.update(b_paths)
    del dense
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return paths, timing


def phase_lab(dev, seed):
    """The kernel lab's path, through its entry points as a user calls
    them: kernel_test (flash decode against the oracle: GQA 32/8, kv 4096,
    split-KV x8, single-pass, int8 cache), gemm_bench (the hand GEMM and
    the library at 2048, 4096, 8192), the JAX primitive tests' cases through
    the port's ops, and perplexity on tinyllama-1.1b at full width and
    depth, q4_k, 256 tokens, with the oracle. Each path's launch counts are
    read just after it runs."""
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import primitives as pr
    from ggml_cuda_experiments_tpu_torch.tools import (
        gemm_bench, kernel_test, perplexity)
    log("== 7. the kernel lab: kernel_test, gemm_bench, the primitives, "
        "perplexity")
    paths = {}

    t0 = time.perf_counter()
    _reset_counts()
    for extra in ([], ["--no-kv-parallel"], ["--quantized-kv"]):
        # --tol 2e-3: about 4 bf16 ulps at the largest outputs (|out| <
        # 0.1 at kv 4096); the tool's default 2e-2 is a typical output
        argv = ["--kv-size", "4096", "--heads", "32", "--kv-heads", "8",
                "--kv-splits", "8", "--seed", str(seed), "--tol", "2e-3",
                *extra]
        log(f"  kernel_test {' '.join(argv)}")
        sys.stdout.flush()
        if kernel_test.main(argv) != 0:
            raise AssertionError(f"kernel_test {argv} failed")
    c = paths["kernel_test"] = _counts()
    # per run: one checked call and the timed ones, each a partials launch
    # (bf16 twice, int8 once) and a merge
    per = c["flash_decode_q"]
    want = {k: 0 for k in c}
    want.update(flash_decode=2 * per, flash_decode_q=per, lse_merge=3 * per)
    _assert_counts("kernel_test", c, want)
    log(f"  kernel_test: 3 runs PASS in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _reset_counts()
    log("  gemm_bench --sizes 2048,4096,8192")
    sys.stdout.flush()
    if gemm_bench.main(["--sizes", "2048,4096,8192",
                        "--seed", str(seed)]) != 0:
        raise AssertionError("gemm_bench failed")
    paths["gemm_bench"] = _counts()
    log(f"  gemm_bench in {time.perf_counter() - t0:.1f} s")

    # the JAX package's primitive tests (tests/test_dma.py:18,
    # tests/test_reductions.py:54, :79) on their inputs (each test's own
    # rng, seed 1234): the copy, the int32 total and the max exact; the row
    # sums within 1e-6 of each row's sum of magnitudes (f32 rounding in
    # another order than NumPy's; the JAX test's rtol 1e-6 against NumPy's
    # sum holds only for its order)
    _reset_counts()

    def draw(f):
        return f(np.random.default_rng(1234))

    x = draw(lambda r: r.normal(size=(16, 80)).astype(np.float32))
    out = pr.stage_pad(torch.from_numpy(x).to(dev), 128).cpu().numpy()
    if not (np.array_equal(out[:, :80], x) and not out[:, 80:].any()):
        raise AssertionError("stage_pad: not an exact padded copy")
    xi = draw(lambda r: r.integers(-1000, 1000, size=(64, 128)).astype(
        np.int32))
    if int(pr.grid_sum(torch.from_numpy(xi).to(dev))) != int(xi.sum()):
        raise AssertionError("grid_sum: the int32 total differs")
    xl = draw(lambda r: r.normal(size=(8, 128)).astype(np.float32))
    mx, sm = (t.cpu().numpy()[:, 0]
              for t in pr.lane_reduce(torch.from_numpy(xl).to(dev)))
    np.testing.assert_array_equal(mx, xl.max(axis=1))
    err = np.abs(sm - xl.astype(np.float64).sum(axis=1))
    if not (err <= 1e-6 * np.abs(xl).sum(axis=1)).all():
        raise AssertionError(f"lane_reduce: row sums off by {err.max()}")
    paths["primitives"] = _counts()
    log(f"  primitives: stage_pad [16, 80] -> [16, 128] exact, grid_sum "
        f"[64, 128] int32 exact, lane_reduce [8, 128] max exact, sums "
        f"within {err.max():.3g} of f64")

    t0 = time.perf_counter()
    cfg = PRESETS["tinyllama-1.1b"]
    _reset_counts()
    argv = ["--model", cfg.name, "--fmt", "q4_k", "--tokens", "256",
            "--seed", str(seed)]
    log(f"  perplexity {' '.join(argv)} (all {cfg.n_layers} layers)")
    sys.stdout.flush()
    if perplexity.main(argv) != 0:
        raise AssertionError("perplexity: PPL not within 2% of the oracle's "
                             "or a logit more than 0.35 from it")
    paths["perplexity"] = _counts()
    L = cfg.n_layers
    want = {k: 0 for k in paths["perplexity"]}
    want.update(q4k_gemm=4 * L + 1, flash_attention=L)  # rope_pack: D = 64
    _assert_counts("perplexity", paths["perplexity"], want)
    log(f"  perplexity in {time.perf_counter() - t0:.1f} s")
    for path, want in (("kernel_test", ("flash_decode", "flash_decode_q",
                                        "lse_merge")),
                       ("gemm_bench", ("matmul",)),
                       ("primitives", ("stage_pad", "grid_sum",
                                       "lane_reduce"))):
        if not all(paths[path][k] for k in want):
            raise AssertionError(f"{path}: {want} not all launched "
                                 f"({paths[path]})")
    return paths


def _decode_bench_counts(L, model_pack: bool):
    """Launches of the entry's ``--decode`` run (tools/bench.py
    ``decode_bench``): 8 prefills (the path probe's and the per-token
    marginal's 16 tokens, 5 TTFT runs of 512, batch 8 of 16: 4 GEMMs and a
    flash_attention per layer, rope_pack at 512 where head_dim is 128, the
    head on one row at batch 1 and on 8 at batch 8), 8 batch-1 decode steps
    (the path probe's, the captured step's eager call and capture, one per
    TTFT run) and 2 batch-8 ones (eager and capture: 4 GEMMs, flash_decode
    and lse_merge per layer, the head's GEMM); the replays launch the
    captured kernels again, uncounted."""
    want = {k: 0 for k in _counts()}
    want.update(q4k_gemm=8 * 4 * L + 1 + 2 * (4 * L + 1),
                flash_attention=8 * L, flash_decode=2 * L, lse_merge=2 * L)
    if model_pack:       # llama2-7b: model_step and the int8 head
        want.update(rope_pack=5 * L, model_step=8, q4k_q8_matvec=7 + 8)
    else:                # tinyllama: K = 2048 shuts every int8 gate
        want.update(q4k_matvec=7 + 8 * (4 * L + 1),
                    flash_decode=10 * L, lse_merge=10 * L)
    return want


def phase_bench_decode(dev, params, model, card):
    """9 (decode): the entry's ``--decode`` (tools/bench.py
    ``decode_bench``) on these q4_k weights: tok/s at batch 1 (8 and 40
    replays of one captured step), TTFT p50 of 5 runs at 512 tokens, batch
    8, the stream bound; its launches asserted."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools import bench as eb
    log(f"== 9. the benchmark entry's --decode --model={model} on these "
        "weights")
    L = PRESETS[model].n_layers
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    r = eb.decode_bench(model, params=params, dev=dev)
    torch.cuda.synchronize()
    counts = _counts()
    path = "bench_decode_" + model.replace("-", "_").replace(".", "_")
    _assert_counts(path, counts, _decode_bench_counts(
        L, "model_step" in r["path"]))
    line = r["line"]
    if not (set(line) == {"metric", "value", "unit", "vs_baseline"}
            and line["value"] > 0 and 0 < r["ttft_p50_ms"] < 1e4
            and r["batch8_tok_s"] > 0):
        raise AssertionError(f"bench --decode {model}: {r}")
    log(f"  [{card}] bench --decode --model={model} in "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(line)}; TTFT p50 "
        f"{r['ttft_p50_ms']:.2f} ms, batch 8 {r['batch8_tok_s']:.1f} tok/s, "
        f"stream {r['stream_bytes'] / 1e9:.4f} GB/token (bound "
        f"{r['bound_tok_s']:.1f} tok/s)")
    return {path: counts}, {k: v for k, v in r.items() if k != "path"}


def phase_bench(dev, seed, card):
    """9: the benchmark entry's kernel metric and the probe tools, each
    through its ``main`` as a user runs it, with each path's launches
    asserted: bench (q8_0, q4_k and the stream floor by the pair protocol),
    exp_q4 (the exact-matvec rungs by the inner-count marginal), exp_q4_r2
    --check (every int8 rung), shape_probe --preprep at the four 7B shapes,
    roofline_sweep over the ladder's grid, q6_probe, probe_mosaic_r3 and
    membench."""
    import io
    from ggml_cuda_experiments_tpu_torch.tools import (
        bench, exp_q4, exp_q4_r2, membench, probe_mosaic_r3, q6_probe,
        roofline_sweep, shape_probe)
    log("== 9. the benchmark entry and the probe tools")
    paths, metrics = {}, {}

    def run(path, tool, argv, want):
        t0 = time.perf_counter()
        _reset_counts()
        log(f"  {tool.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = tool.main(argv)
        text = out.getvalue()
        for ln in text.splitlines():
            log(f"    | {ln}")
        if rc != 0:
            raise AssertionError(f"{path}: exit {rc}")
        counts = paths[path] = _counts()
        full = {k: 0 for k in counts}
        full.update(want)
        _assert_counts(path, counts, full)
        log(f"  {path} in {time.perf_counter() - t0:.1f} s")
        return text

    chain = 2 * (64 + 2)            # two sizes, 2 warm-up + 64 captured
    text = run("bench", bench, [], {"q80_matvec": chain,
                                    "q4k_q8_matvec": chain,
                                    "q4_ladder_floor": chain})
    lines = [ln for ln in text.splitlines() if ln.startswith("{")]
    line = json.loads(lines[-1]) if len(lines) == 1 else None
    if not (line and set(line) == {"metric", "value", "unit", "vs_baseline",
                                   "ceiling_pct", "pct_of_achievable"}
            and 0 < line["value"] <= 100 and 0 < line["ceiling_pct"] <= 100):
        raise AssertionError(f"bench: not one JSON line in range: {text}")
    metrics["kernel_metric"] = line
    log(f"  [{card}] bench: {json.dumps(line)}")
    modes = ("floor", "chunk", "chunk32", "ponly", "loonly", "nochunk",
             "bf16", "floorhi")
    run("exp_q4", exp_q4, ["--variants", ",".join(modes)],
        {f"q4_ladder_{m}": (2 + 32) + (2 + 160) for m in modes})
    run("exp_q4_r2_check", exp_q4_r2,
        ["--check", "--probes", "dma,zponly,zlonly,full,noand,cols256,split,"
         "onedot,onedot_sub,subtile,full_pre,full:1"],
        {"q4k_q8_matvec": 1, "q4_ladder_dma": 1, "q4_ladder_zponly": 1,
         "q4_ladder_zlonly": 1, "q4_ladder_full": 6, "q4_ladder_noand": 1,
         "q4_ladder_cols256": 1, "q4_ladder_split_f32": 1, "q8_prep": 1})
    per = (2 + 16) + (2 + 80)       # one inner-count marginal, 16 and 80
    run("shape_probe", shape_probe, ["--preprep", "--i1", "16", "--i2", "80",
                                     "--reps", "3"],
        {"q4k_q8_matvec": 4 * per, "q8_prep": 4 * per + 4,   # + the hoisted
         "q4_ladder_full": 8 * per})
    run("roofline_sweep", roofline_sweep,
        ["--pairs", "3", "--min-valid", "2", "--variants",
         "base,full,cta1,cta2,stream"],
        {"q4k_q8_matvec": chain, "q4_ladder_full": 3 * chain,
         "q4_ladder_floor": chain})
    q6 = 2 * (2 + 16)
    run("q6_probe", q6_probe, ["--inner", "16"],
        {"q6_stream": q6, "q6k_q8_matvec": q6, "q6_nib_lhs": 2 * q6,
         "matmul": 3 * q6, "q6_nib_fold": 2 * q6, "q6_bits2": q6})
    tiny = 1 + 6 * 64 + 6 * 256 + (2 + 64) + (2 + 256)
    run("probe_mosaic_r3", probe_mosaic_r3, [],
        {**{f"mosaic_{p}": 1 for p in ("transpose_dot", "lane_concat",
                                       "roll64", "dyn_sublane",
                                       "lane_extract", "read_output")},
         "mosaic_tiny_call": tiny})
    run("membench", membench, ["--mb", "64"], {})
    return paths, metrics


GGUF_PROMPT = "the quick brown fox jumps over the lazy dog while the cat sleeps"
GGUF_GEN = 16
_GGUF_NAMES = {"wq": "attn_q", "wk": "attn_k", "wv": "attn_v",
               "wo": "attn_output", "w_gate": "ffn_gate", "w_up": "ffn_up",
               "w_down": "ffn_down"}


def _spm_vocab(n: int, seed: int):
    """A seeded SPM vocabulary of ``n`` entries: <unk>, <s>, </s>, the 256
    byte tokens, then '▁', the letters, and one- to three-letter pieces
    with and without '▁', scored by length with a seeded jitter."""
    import itertools
    import numpy as np
    from ggml_cuda_experiments_tpu_torch.utils.tokenizer import SpmTokenizer
    letters = "abcdefghijklmnopqrstuvwxyz"
    pieces = ["▁"]
    for width in (1, 2, 3):
        words = ["".join(t) for t in itertools.product(letters, repeat=width)]
        pieces += words + ["▁" + w for w in words]
    tokens = ["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
    pieces = pieces[:n - len(tokens)]
    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0.0, 0.5, len(pieces))
    return SpmTokenizer(
        tokens=tokens + pieces,
        scores=[0.0] * len(tokens) + [float(len(p) - 10 + j)
                                      for p, j in zip(pieces, jitter)],
        token_type=[2, 3, 3] + [6] * 256 + [1] * len(pieces))


def _q4km_direct(dense, cfg):
    """The Q4_K_M mix of ``dense`` quantized directly on the card, with no
    file between: what ``load_gguf`` must give back from the exported
    file (its embedding the bf16 dequantization of its Q4_K blocks)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils import gguf
    fmt = lambda name: gguf.q4_k_m_format(name, cfg.n_layers)
    return {
        "embed": qm.dequantize(qm.quantize(dense["embed"], "q4_k"),
                               torch.bfloat16),
        "layers": [{k: w if k not in _GGUF_NAMES else qm.quantize(
            w, fmt(f"blk.{i}.{_GGUF_NAMES[k]}.weight"))
            for k, w in layer.items()}
            for i, layer in enumerate(dense["layers"])],
        "final_norm": dense["final_norm"],
        "lm_head": qm.quantize(dense["lm_head"], fmt("output.weight"))}


def _q4km_linears(cfg):
    """(q4_k linears, q6_k linears at K = dim) of the Q4_K_M mix over the
    layers: the first run q4k_gemm / q4k_matvec, the second (attn_v)
    q6k_q8_matvec at one row; the q6_k w_down (K = intermediate) runs the
    plain bf16 product, no kernel, as in the JAX package."""
    from ggml_cuda_experiments_tpu_torch.utils import gguf
    fmts = [gguf.q4_k_m_format(f"blk.{i}.{n}.weight", cfg.n_layers)
            for i in range(cfg.n_layers) for n in _GGUF_NAMES.values()]
    wv = [gguf.q4_k_m_format(f"blk.{i}.attn_v.weight", cfg.n_layers)
          for i in range(cfg.n_layers)]
    return fmts.count("q4_k"), wv.count("q6_k")


def _assert_same_tree(what, got, want) -> int:
    """Every leaf of ``got`` equal to ``want``'s, bit for bit (QuantLinear:
    format, shape and every field); returns the bytes compared."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops.quant_matmul import QuantLinear
    if isinstance(want, dict):
        if sorted(got) != sorted(want):
            raise AssertionError(f"{what}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        return sum(_assert_same_tree(f"{what}.{k}", got[k], want[k])
                   for k in want)
    if isinstance(want, list):
        return sum(_assert_same_tree(f"{what}.{i}", g, w)
                   for i, (g, w) in enumerate(zip(got, want, strict=True)))
    if isinstance(want, QuantLinear):
        if (got.fmt, got.shape) != (want.fmt, want.shape):
            raise AssertionError(f"{what}: {got.fmt} {got.shape} != "
                                 f"{want.fmt} {want.shape}")
        return sum(_assert_same_tree(f"{what}.{f}", getattr(got, f),
                                     getattr(want, f))
                   for f in ("qs", "es", "em", "qh", "d")
                   if getattr(want, f) is not None)
    if got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: not bit-equal")
    return want.numel() * want.element_size()


# load_gguf alone in a fresh process, for the load's own peak RSS: its
# resident pages (/proc/self/statm, read only) sampled every 2 ms by a
# thread, since a child's getrusage ru_maxrss starts at its parent's peak
# (the forked copy's high-water mark survives the exec)
_LOAD_CHILD = """
import json, os, sys, threading, time
sys.path.insert(0, sys.argv[1])
import torch
from ggml_cuda_experiments_tpu_torch.utils.gguf import load_gguf

PAGE = os.sysconf("SC_PAGE_SIZE")

def rss_kb():
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * PAGE // 1024

torch.zeros(1, device="cuda")
torch.cuda.synchronize()
before = rss_kb()
peak = [before]
done = threading.Event()

def sample():
    while not done.wait(0.002):
        peak[0] = max(peak[0], rss_kb())

sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
params, cfg = load_gguf(sys.argv[2])
torch.cuda.synchronize()
load_s = time.perf_counter() - t0
done.set()
sampler.join()
print(json.dumps({"load_s": load_s, "rss_before_kb": before,
                  "rss_peak_kb": max(peak[0], rss_kb()),
                  "card_bytes": torch.cuda.memory_allocated()}))
"""


def phase_checkpoint(dev, seed, card):
    """11: the checkpoint path (utils/gguf.py, tokenizer.py, loader.py):
    llama2-7b's seeded weights written as a Q4_K_M-style GGUF file with an
    SPM vocabulary of 32,000, loaded by ``load_gguf`` and
    ``load_tokenizer``, every loaded weight held bit-equal to the same
    weights quantized directly on the card, a text prompt through
    ``generate`` (tokens equal to the direct params', each layer forced
    against the plain versions, launch counts asserted), the GCTC round
    trip, and ``perplexity --gguf`` on a tinyllama-shaped file."""
    import dataclasses
    import resource
    import shutil
    import tempfile
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools import perplexity
    from ggml_cuda_experiments_tpu_torch.utils import gguf, loader, tokenizer
    t_phase = time.perf_counter()
    cfg = PRESETS["llama2-7b"]
    L = cfg.n_layers
    log(f"== 11. the checkpoint path: {cfg.name} as a Q4_K_M-style GGUF file "
        "(q4_k layers, q6_k attn_v / ffn_down where llama.cpp's "
        "use_more_bits picks, q6_k output, q4_k token_embd, an SPM "
        "vocabulary of 32,000) through load_gguf -> generate; the GCTC "
        "round trip; perplexity --gguf on tinyllama-1.1b")
    tmp = tempfile.mkdtemp(prefix="gct_ckpt_")
    paths, metrics = {}, {"card": card}
    try:
        vocab = _spm_vocab(cfg.vocab_size, seed)
        dense = llama.init_weights(cfg, seed=seed + 11, device=dev)
        path = os.path.join(tmp, "llama2-7b-q4_k_m.gguf")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gguf.export_llama(path, dense, cfg, vocab)
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        direct = _q4km_direct(dense, cfg)
        del dense
        torch.cuda.empty_cache()
        log(f"  [{card}] export_llama (quantize_blocks on the card, encode, "
            f"write): {size} bytes in {write_s:.2f} s "
            f"({size / write_s / 1e9:.3f} GB/s)")

        rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, lcfg = gguf.load_gguf(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        loaded = torch.cuda.memory_allocated() - mem0
        # the load's parts: the host's reads alone, then reads and copies
        # to the card (the decode on the card is the rest)
        gf = gguf.read_gguf(path)
        t0 = time.perf_counter()
        for name in gf.tensors:
            gf.tensor_bytes(name, "cpu")
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for name in gf.tensors:
            gf.tensor_bytes(name, dev)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = tokenizer.load_tokenizer(path)
        tok_s = time.perf_counter() - t0
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        child = subprocess.run(
            [sys.executable, "-c", _LOAD_CHILD, ROOT, path],
            capture_output=True, text=True, timeout=600)
        if child.returncode != 0:
            raise AssertionError(f"load_gguf in a fresh process failed:\n"
                                 f"{child.stderr[-3000:]}")
        fresh = json.loads(child.stdout.strip().splitlines()[-1])
        metrics.update(
            file_bytes=size, write_s=write_s, load_s=load_s,
            load_gb_s=size / load_s / 1e9, read_s=read_s,
            read_and_copy_s=copy_s, tokenizer_s=tok_s,
            loaded_card_bytes=loaded, card_bytes_after_load=
            torch.cuda.memory_allocated(), rss_peak_kb=rss,
            rss_peak_before_kb=rss0, fresh_process=fresh,
            fresh_load_gb_s=size / fresh["load_s"] / 1e9)
        log(f"  [{card}] load_gguf: {size} bytes in {load_s:.3f} s wall "
            f"({size / load_s / 1e9:.3f} GB/s; the file just written, so "
            f"read warm from the page cache), load_tokenizer {tok_s:.3f} s; "
            f"the card holds {loaded} bytes of loaded params "
            f"({torch.cuda.memory_allocated()} allocated after the load); "
            f"host peak RSS (getrusage) {rss} kB (before the load {rss0} "
            "kB, this process's earlier phases included); its parts: the "
            f"host's reads alone {read_s:.3f} s, reads + copies to the card "
            f"{copy_s:.3f} s, so the decode on the card ~"
            f"{load_s - copy_s:.3f} s")
        added = fresh["rss_peak_kb"] - fresh["rss_before_kb"]
        log(f"  [{card}] load_gguf in a fresh process: {fresh['load_s']:.3f} "
            f"s ({size / fresh['load_s'] / 1e9:.3f} GB/s), peak RSS (sampled) "
            f"{fresh['rss_peak_kb']} kB, {fresh['rss_before_kb']} kB before "
            f"the load (CUDA up): the load added {added} kB for a "
            f"{size / 1e9:.2f} GB file; card {fresh['card_bytes']} bytes")
        if added * 1024 >= size:
            raise AssertionError("load_gguf held the whole file in host "
                                 "memory")

        if dataclasses.asdict(lcfg) != dataclasses.asdict(
                dataclasses.replace(cfg, rms_eps=lcfg.rms_eps)):
            raise AssertionError(f"config_from_metadata: {lcfg} != {cfg}")
        compared = _assert_same_tree("params", params, direct)
        log(f"  every loaded weight bit-equal to the same weights quantized "
            f"on the card ({compared} bytes: q4_k / q6_k fields, attn_q / "
            f"attn_k back in the original row order, the embed the bf16 "
            f"dequantization of its Q4_K blocks, the norms)")

        if (tok.tokens, tok.token_type) != (vocab.tokens, vocab.token_type):
            raise AssertionError("load_tokenizer: vocabulary differs")
        ids = tok.encode(GGUF_PROMPT)
        if tok.decode(ids) != GGUF_PROMPT:
            raise AssertionError(f"decode(encode(prompt)) = "
                                 f"{tok.decode(ids)!r}")
        prompt = torch.tensor([ids], dtype=torch.int64, device=dev)
        log(f"  prompt {GGUF_PROMPT!r}: {len(ids)} tokens (bos first), "
            "decoded back equal")
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        toks = llama.generate(params, lcfg, prompt, steps=GGUF_GEN)
        gen_s = time.perf_counter() - t0
        counts = paths["gguf_generate"] = _counts()
        n_q4, n_q6 = _q4km_linears(lcfg)
        want = {k: 0 for k in counts}
        want.update(q4k_gemm=n_q4, flash_attention=L,
                    q4k_matvec=GGUF_GEN * n_q4,
                    q6k_q8_matvec=1 + GGUF_GEN * (n_q6 + 1),
                    flash_decode=GGUF_GEN * L, lse_merge=GGUF_GEN * L)
        _assert_counts("gguf generate", counts, want)
        log(f"  launch counts equal the path's: the prefill's {n_q4} q4_k "
            f"linears on q4k_gemm, the head on q6k_q8_matvec; per decode "
            f"step {n_q4} q4k_matvec, {n_q6} q6_k attn_v + the head on "
            f"q6k_q8_matvec, {L} flash_decode + lse_merge; the q6_k w_down "
            "(K = 11008) the plain bf16 product; no fused kernel (the "
            "projections are separate)")
        want_toks = llama.generate(direct, lcfg, prompt, steps=GGUF_GEN)
        if not np.array_equal(toks, want_toks):
            raise AssertionError(f"generate: loaded {toks} != direct "
                                 f"{want_toks}")
        log(f"  generate {GGUF_GEN} tokens in {gen_s:.3f} s wall: "
            f"{toks[0].tolist()} (equal to the direct params'; text "
            f"{tok.decode(toks[0].tolist())[:60]!r})")
        metrics["generate_s"] = gen_s
        forced = torch.from_numpy(toks[0, :2]).to(dev, torch.int32)
        _check_forced(params, lcfg, prompt, forced, dev)
        del direct
        torch.cuda.empty_cache()

        gpath = os.path.join(tmp, "llama2-7b.gctc")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loader.save_params(gpath, params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = loader.load_params(gpath)
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        gsize = os.path.getsize(gpath)
        compared = _assert_same_tree("gctc", back, params)
        metrics.update(gctc_bytes=gsize, gctc_save_s=save_s,
                       gctc_load_s=reload_s)
        log(f"  [{card}] GCTC: save_params {gsize} bytes in {save_s:.3f} s, "
            f"load_params in {reload_s:.3f} s (warm), bit-equal "
            f"({compared} bytes)")
        del back, params
        os.remove(gpath)
        os.remove(path)
        torch.cuda.empty_cache()

        tcfg = PRESETS["tinyllama-1.1b"]
        tpath = os.path.join(tmp, "tinyllama-q4_k_m.gguf")
        tdense = llama.init_weights(tcfg, seed=seed + 12, device=dev)
        gguf.export_llama(tpath, tdense, tcfg)
        del tdense
        torch.cuda.empty_cache()
        argv = ["--gguf", tpath, "--tokens", "256", "--seed", str(seed)]
        log(f"  perplexity {' '.join(argv)} ({tcfg.n_layers} layers)")
        sys.stdout.flush()
        _reset_counts()
        if perplexity.main(argv) != 0:
            raise AssertionError("perplexity --gguf: PPL not within 2% of "
                                 "the oracle's or a logit more than 0.35 "
                                 "from it")
        counts = paths["gguf_perplexity"] = _counts()
        want = {k: 0 for k in counts}
        want.update(q4k_gemm=_q4km_linears(tcfg)[0],
                    flash_attention=tcfg.n_layers)
        _assert_counts("gguf perplexity", counts, want)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{card}] phase 11 in {metrics['phase_s']:.1f} s")
    return paths, metrics


ENGINE_PROMPTS = (16, 37, 64, 100, 128, 200, 256, 300, 384, 450, 500, 512)
ENGINE_GEN = 32
ENGINE_KW = dict(max_batch=8, page_size=64, n_pages=96, max_seq_len=1024,
                 quantized_kv="int8", decode_window=16)


@contextlib.contextmanager
def _count_steps(engine_mod, calls):
    """Count the engine's device-step calls (whole prefills, chunks, the
    chunks that return logits, decode steps) while the block runs."""
    names = ("_paged_prefill", "_paged_prefill_chunk", "_paged_decode_step")
    saved = {n: getattr(engine_mod, n) for n in names}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            calls[name + "+logits"] += bool(kw.get("with_logits"))
            return fn(*a, **kw)
        return call

    for n in names:
        setattr(engine_mod, n, counted(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(engine_mod, n, fn)


def _serve(eng, prompts, gen):
    rids = [eng.add_request(p, max_new_tokens=gen) for p in prompts]
    out = eng.run_to_completion()
    return [out[r] for r in rids]


def _drive_engine(params, cfg, prompts, gen, path, **kw):
    """One run of the engine with the launch counts set to 0 just before
    it and read just after, every count asserted against the steps the
    scheduler took. Returns (tokens per request, counts, wall seconds)."""
    import collections
    import torch
    from ggml_cuda_experiments_tpu_torch.models import engine
    L = cfg.n_layers
    eng = engine.Engine(params, cfg, **kw)
    calls = collections.Counter()
    torch.cuda.synchronize()
    _reset_counts()
    with _count_steps(engine, calls):
        t0 = time.perf_counter()
        outs = _serve(eng, prompts, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = _counts()
    for p, toks in zip(prompts, outs):
        if len(toks) != gen or not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{path}: prompt {len(p)} gave {toks}")
    nsched = getattr(eng, "_nsched", None)
    free = len(eng.allocator.free) if nsched is None else \
        nsched.num_free_pages
    if free != kw["n_pages"] - 1:
        raise AssertionError(f"{path}: {kw['n_pages'] - 1 - free}"
                             " pages not returned to the allocator")
    steps = calls["_paged_decode_step"]
    fills = calls["_paged_prefill"] + calls["_paged_prefill_chunk"]
    heads = calls["_paged_prefill"] + calls["_paged_prefill_chunk+logits"]
    want = {k: 0 for k in counts}
    want.update(flash_attention=fills * L, paged_decode=steps * L)
    gemm = FORMAT_KERNELS[params["layers"][0]["wqkv"].fmt][1]
    head = params["lm_head"].fmt
    if head == "q6_k":
        # a one-row head takes the hybrid q6_k matvec, the batch's head the
        # reference's dense bf16 route (no kernel)
        want.update({"q6k_q8_matvec": heads, gemm: (steps + fills) * 4 * L})
    else:
        want[FORMAT_KERNELS[head][0]] = heads
        want[FORMAT_KERNELS[head][1]] += steps
        want[gemm] += (steps + fills) * 4 * L
    log(f"  {path}: {len(prompts)} requests, {calls['_paged_prefill']} "
        f"prefills, {calls['_paged_prefill_chunk']} chunks, {steps} decode "
        f"steps in {wall:.2f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"{path}: launch counts {counts} != {want}")
    return outs, counts, wall


def _forced_paged_step(params, cfg, state, pools):
    """One batched decode step on the kernel path, with every layer and the
    head also run through the plain versions on the kernel path's input.
    pools: (kernel pool, plain pool), both written. Returns (per-layer max
    error relative to max|plain|, (kernel logits, plain logits))."""
    from ggml_cuda_experiments_tpu_torch.models import engine, llama
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    tokens, lengths, pt, active = state
    pk, pp = pools
    pages_b, offs_b = engine._decode_slots(lengths, pt, active, pk)
    h = params["embed"][tokens[:, None]]
    worst = []
    for li, layer in enumerate(params["layers"]):
        hk = engine._decode_layer(layer, cfg, li, h, lengths, pt, pages_b,
                                  offs_b, pk)
        with plain_versions():
            hp = engine._decode_layer(layer, cfg, li, h, lengths, pt, pages_b,
                                      offs_b, pp)
        worst.append(float((hk - hp).float().abs().max()
                           / hp.float().abs().max()))
        h = hk
    hn = llama.rms_norm(h, params["final_norm"], cfg.rms_eps)[:, 0]
    lk = llama.apply_linear(hn, params["lm_head"]).float()
    with plain_versions():
        lp = llama.apply_linear(hn, params["lm_head"]).float()
    return worst, (lk, lp)


def _check_forced_engine(params, cfg, prompts, dev):
    """Admit 8 ``prompts`` into an int8-pool engine and force its first
    batched decode step layer by layer against the plain versions (logits
    and every layer within 2e-2 * max)."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import engine
    eng = engine.Engine(params, cfg, **ENGINE_KW)
    for p in prompts:
        eng.add_request(p, max_new_tokens=ENGINE_GEN)
    eng._admit()
    state = (eng._tokens_dev.clone(),
             torch.from_numpy(eng.lengths).to(dev),
             torch.from_numpy(eng.page_table).to(dev),
             torch.ones(8, dtype=torch.bool, device=dev))
    plain_pool = dataclasses.replace(
        eng.pool, **{f: getattr(eng.pool, f).clone()
                     for f in ("k", "v", "k_scale", "v_scale")})
    worst, (lk, lp) = _forced_paged_step(params, cfg, state,
                                         (eng.pool, plain_pool))
    err, sc = float((lk - lp).abs().max()), float(lp.abs().max())
    li, lerr = max(enumerate(worst), key=lambda t: t[1])
    ok = (lk.shape == (8, cfg.vocab_size) and bool(torch.isfinite(lk).all())
          and err <= 2e-2 * sc and lerr <= 2e-2)
    log(f"  forced batched decode step (int8 pool, B=8, lengths "
        f"{[len(p) for p in prompts]}): logits max_abs_err {err:.4e} vs "
        f"2e-2*{sc:.4e}; worst layer {li}: {lerr:.3e} of max (bound 2e-2); "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"forced paged decode step: logits {err} vs "
                             f"{sc}, layer {li} {lerr}")


def phase_engine(dev, seed, params, cfg, card):
    """The serving engine at llama2-7b width on the main path's params."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import engine
    log(f"== 6. engine: {cfg.name}, continuous batching, "
        f"{', '.join(f'{k}={v}' for k, v in ENGINE_KW.items())}")
    g = torch.Generator().manual_seed(seed + 4)

    def prompt(n):
        return torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pool_bytes = engine.PagedKVPool.create(
        cfg, ENGINE_KW["n_pages"], ENGINE_KW["page_size"],
        ENGINE_KW["quantized_kv"], device="meta").nbytes
    log(f"  [{card}] pool bytes {pool_bytes} ({pool_bytes / 2**30:.3f} GiB, "
        f"int8 pages + f32 scales)")

    # 12 requests through 8 slots: four join as others leave
    prompts = [prompt(n) for n in ENGINE_PROMPTS]
    outs, c_engine, _ = _drive_engine(params, cfg, prompts, ENGINE_GEN,
                                      "engine", **ENGINE_KW)
    log(f"  tokens of request 0: {outs[0][:8]}...")
    # chunked prefill: three 512-token prompts in chunks of 128
    _, c_chunked, _ = _drive_engine(
        params, cfg, [prompt(512) for _ in range(3)], ENGINE_GEN,
        "engine chunked", prefill_chunk=128, **ENGINE_KW)

    # TTFT per request on an idle engine: admission, prefill and the first
    # token on the host
    eng = engine.Engine(params, cfg, **ENGINE_KW)
    ttft = {}
    for n, p in zip(ENGINE_PROMPTS, prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.add_request(p, max_new_tokens=ENGINE_GEN)
        eng._admit()
        req = eng.running[0]
        int(eng._tokens_dev[req.slot])
        ttft[n] = (time.perf_counter() - t0) * 1e3
        eng._release(req)
    log(f"  [{card}] TTFT ms by prompt length (idle engine): "
        + ", ".join(f"{n}: {t:.1f}" for n, t in ttft.items()))

    # steady-state generated tok/s, the marginal over request count
    # (tools/engine_bench.py): 24 requests minus 8, prompt 64, gen 64
    def timed(n):
        eng = engine.Engine(params, cfg, **ENGINE_KW)
        ps = [prompt(64) for _ in range(n)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = sum(len(t) for t in _serve(eng, ps, 64))
        torch.cuda.synchronize()
        return toks, time.perf_counter() - t0

    # host time varies from run to run on a shared host: three pairs, the
    # order alternating, and the median of their marginal rates
    timed(8)                                         # warm-up
    rates = []
    for rep in range(3):
        small, big = (timed(8), timed(24)) if rep % 2 == 0 else \
            reversed((timed(24), timed(8)))
        rates.append((big[0] - small[0]) / (big[1] - small[1]))
        log(f"    pair {rep}: {big[0]} tokens in {big[1]:.2f} s less "
            f"{small[0]} in {small[1]:.2f} s -> {rates[-1]:.1f} tok/s")
    rate = statistics.median(rates)
    log(f"  [{card}] generated tok/s at steady state {rate:.1f} (median "
        f"of 3 marginal rates, 24 requests less 8)")

    # the device's busy share of one engine step: a full window of 16
    # decode steps for 8 running requests. The profiler's host overhead
    # stretches the wall time it sees, so the share is the profiled device
    # time over the unprofiled wall time of the window before it.
    eng = engine.Engine(params, cfg, **ENGINE_KW)
    for _ in range(8):
        eng.add_request(prompt(64), max_new_tokens=64)
    eng.step()                                   # prefills + first window
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    _, prof_wall_us, busy, events = _profiled(eng.step)
    W = ENGINE_KW["decode_window"]
    log(f"  [{card}] one engine step (window of {W} decode steps, batch 8): "
        f"wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
        f"({100 * busy / wall_us:.1f}% busy; {prof_wall_us / 1e3:.2f} ms "
        f"wall while profiled)")
    _log_top(events, W, "decode step", n=8)
    eng.run_to_completion()

    # one batched decode step of the int8 pool, forced layer by layer
    _check_forced_engine(params, cfg, [prompt(n) for n in
                                       ENGINE_PROMPTS[-8:]], dev)
    peak = torch.cuda.max_memory_allocated()
    log(f"  [{card}] peak device memory in the engine phase {peak / 2**30:.2f}"
        f" GiB (weights, pool and activations)")
    return {"engine": c_engine, "engine_chunked": c_chunked}, {
        "pool_bytes": pool_bytes, "peak_bytes": peak,
        "steady_tok_s": rate, "steady_tok_s_pairs": rates, "ttft_ms": ttft,
        "step_wall_ms": wall_us / 1e3, "step_busy_ms": busy / 1e3,
        "step_busy_share": busy / wall_us, "card": card}


def _bench_summary(r):
    """engine_bench's numbers without its kernel table and pair details."""
    hp = r["host_parts"]
    return {"steady_tok_s": r["steady"]["tok_s"],
            "pair_rates": r["steady"]["pair_rates"],
            "ttft_ms": r["ttft_ms"], "pool_bytes": r["pool_bytes"],
            "peak_bytes": r["peak_bytes"],
            "busy_share": r["busy"]["busy_share"],
            "host_ms_per_decode_step": hp["per_decode_step_ms"],
            "host_wall_ms": hp["wall_ms"],
            "host_decode_steps": hp["decode_steps"]}


def phase_serving(dev, seed, params, cfg, card):
    """6c. The native scheduler against the python one, the Engine's host
    time by part, and the decode step's and the prefill's time by
    component, on phase 5's weights (tools/engine_bench.py,
    tools/profile_decode.py)."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.tools import engine_bench as eb
    from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pdc
    w1 = dict(ENGINE_KW, decode_window=1)
    log(f"== 6c. serving: {cfg.name}, Engine(scheduler=\"native\") against "
        f"the python scheduler at W = 1, engine_bench, profile_decode")
    g = torch.Generator().manual_seed(seed + 6)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g).tolist()
               for n in ENGINE_PROMPTS]
    py, c_py, t_py = _drive_engine(params, cfg, prompts, ENGINE_GEN,
                                   "engine W=1", **w1)
    nat, c_nat, t_nat = _drive_engine(params, cfg, prompts, ENGINE_GEN,
                                      "engine native", scheduler="native",
                                      **w1)
    bad = [i for i, (a, b) in enumerate(zip(py, nat)) if a != b]
    if bad:
        raise AssertionError(f"native scheduler: requests {bad} differ from "
                             f"the python scheduler's tokens")
    log(f"  the native scheduler's tokens equal the python scheduler's for "
        f"all {len(prompts)} requests (W = 1; {t_nat:.2f} s against "
        f"{t_py:.2f} s)")
    # engine_bench on the smoke's pool: one pair each and no warm-up run
    # (the engine ran above), 32 tokens a request (the tool's default: 3
    # pairs of 64)
    bench = {}
    for name, kw in (("python W=1", dict(w1, scheduler="python")),
                     ("python W=16", dict(ENGINE_KW, scheduler="python")),
                     ("native W=1", dict(w1, scheduler="native"))):
        r = eb.measure(params, cfg, dict(kw, prefill_chunk=None), batch=8,
                       prompt=64, gen=ENGINE_GEN, pairs=1, seed=seed,
                       tag=card, warmup=False)
        if not (r["steady"]["tok_s"] > 0
                and r["host_parts"]["tokens"] == 8 * ENGINE_GEN
                and 0 < r["busy"]["busy_share"] <= 1.0):
            raise AssertionError(f"engine_bench {name}: {_bench_summary(r)}")
        bench[name] = _bench_summary(r)
    # profile_decode in the JAX tool's configuration (x_quant8)
    xcfg = dataclasses.replace(cfg, x_quant8=True)
    prof = {}
    for B, cache in ((1, 1024), (8, 512)):
        r = pdc.decode_components(params, xcfg, dev, B, cache)
        if not all(row["us"] > 0 for row in r["rows"][:-1]) \
                or r["profile"]["busy_us"] <= 0:
            raise AssertionError(f"profile_decode batch {B}: {r['rows']}")
        prof[f"batch{B}"] = {"rows": r["rows"], "step": r["step"],
                             "step_bound_ms": r["step_bound_ms"],
                             "busy_us": r["profile"]["busy_us"],
                             "host_gap_us": r["profile"]["host_gap_us"]}
    r = pdc.prefill_marginal(params, xcfg, dev, 512)
    if not (r["prefill_ms"] > 0 and r["busy_ms"] > 0
            and r["modes"]["full"]["per_layer_ms"] > 0):
        raise AssertionError(f"prefill marginal: {r['rows']}")
    prof["prefill512"] = {k: r[k] for k in (
        "rows", "prefill_ms", "busy_ms", "host_gap_ms", "non_layer_ms",
        "fixed_ms")}
    log(f"  [{card}] serving: " + "; ".join(
        f"{k} {v['steady_tok_s']:.1f} tok/s, busy "
        f"{100 * v['busy_share']:.1f}%" for k, v in bench.items()))
    return ({"engine W=1": c_py, "engine native": c_nat},
            {"engine_bench": bench, "profile_decode": prof})


SPEC_GAMMA, SPEC_MAX_LEN = 4, 1024


def _departures(params, cfg, prompt, stream, dev):
    """The target's decode path teacher-forced over ``stream``: (departures
    [(position, logit of the decode path's argmax minus that of the
    stream's token, max |logit|)], the positions whose own top-2 logit gap
    is within 2e-2 * max|logit|). With draft = target the draft proposes
    the decode path's argmax, so every rejected draft token is a
    departure."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    cache = llama.KVCache.create(cfg, 1, SPEC_MAX_LEN, device=dev)
    logits, _ = llama.prefill(params, cfg, prompt, cache)
    out, near = [], []
    for p, t in enumerate(stream):
        lg = logits[0]
        top, mx = torch.topk(lg, 2).values, float(lg.abs().max())
        if float(top[0] - top[1]) <= 2e-2 * mx:
            near.append(p)
        best = int(torch.argmax(lg))
        if best != t:
            out.append((p, float(lg[best] - lg[t]), mx))
        logits, _ = llama.decode_step(
            params, cfg, torch.tensor([t], dtype=torch.int32, device=dev),
            cache)
    return out, near


def _near_ties(what, departures, near, n):
    """Raise unless every departure is a near-tie (2e-2 * max|logit|); log
    how many of the ``n`` positions are near-ties at all."""
    log(f"  {what}: the stream leaves the decode path's argmax at "
        f"{[(p, round(g, 5)) for p, g, _ in departures]} (position, logit "
        f"gap); {len(near)} of {n} positions ({len(near) / n:.3f}) have a "
        f"top-2 gap within 2e-2 * max|logit|: {near}")
    far = [(p, g, mx) for p, g, mx in departures if g > 2e-2 * mx]
    if far:
        raise AssertionError(f"{what}: departures that are no near-tie {far}")
    return {p for p, _, _ in departures}


def _acceptance_floor(what, acc, floor=0.8):
    if acc < floor:
        raise AssertionError(f"{what}: acceptance {acc:.3f} < {floor}")


def phase_speculative(dev, seed, params, card):
    """Speculative decoding on phase 5's llama2-7b q4_k weights in the
    preset's configuration, bf16 cache of 1024: prefill_chunked against
    prefill; speculative_generate (draft = target) against generate and the
    decode path's own choices, with its launch counts; speculative_scan as CUDA graphs for three drafts
    against the eager stream, with the window's cost against
    generate_scan's per-token cost (the spec_bench method)."""
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models import speculative as spec
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    cfg = PRESETS["llama2-7b"]
    L, gamma, max_len = cfg.n_layers, SPEC_GAMMA, SPEC_MAX_LEN
    log(f"== 8. speculative decoding: {cfg.name} q4_k target, the preset's "
        f"configuration, gamma {gamma}, bf16 cache of {max_len}")
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    paths = {}

    # prefill_chunked: a 512-token prompt in 128-token chunk_steps
    p512 = torch.randint(1, cfg.vocab_size, (1, 512), generator=g,
                         device=dev)
    want, _ = llama.prefill(params, cfg, p512, llama.KVCache.create(
        cfg, 1, max_len, device=dev))
    cache = llama.KVCache.create(cfg, 1, max_len, device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    got, cache = spec.prefill_chunked(params, cfg, p512, cache, chunk=128)
    torch.cuda.synchronize()
    paths["prefill_chunked"] = counts = _counts()
    want_c = {k: 0 for k in counts}
    want_c.update(q4k_gemm=4 * (4 * L + 1), flash_attention=4 * L)
    _assert_counts("prefill_chunked", counts, want_c)
    err, sc = rel_err(got, want)
    log(f"  prefill_chunked(512, chunk 128) last logits vs prefill: "
        f"max_abs_err {err:.4e} vs 2e-2*{sc:.4e}; lengths "
        f"{cache.lengths.tolist()}")
    if not (err <= 2e-2 * sc and cache.lengths.tolist() == [512]):
        raise AssertionError(f"prefill_chunked: {err} vs {sc}")
    del cache

    # speculative_generate with draft = target, 48 tokens, against generate
    prompt = torch.randint(1, cfg.vocab_size, (1, 16), generator=g,
                           device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    toks, stats = spec.speculative_generate(params, cfg, params, cfg, prompt,
                                            48, gamma=gamma, max_len=max_len)
    wall = time.perf_counter() - t0
    paths["speculative"] = counts = _counts()
    V = stats["verify_calls"]
    n_dec = counts["flash_decode"] // L      # draft decode steps
    log(f"  speculative_generate(48, draft = target): {wall:.2f} s wall, "
        f"stats {stats}, {n_dec} draft decode steps")
    want_c = {k: 0 for k in counts}
    # two 16-token prefills (4 q4k_gemm and a flash_attention per layer, the
    # head's matvec); per verify 4 q4k_gemm per layer and the head, a
    # flash_attention per layer; per draft step the preset's decode
    want_c.update(q4k_gemm=2 * 4 * L + V * (4 * L + 1),
                  flash_attention=2 * L + V * L,
                  q4k_matvec=2 + n_dec * (2 * L + 1), fused_mlp=n_dec * L,
                  flash_decode=n_dec * L, lse_merge=n_dec * L)
    _assert_counts("speculative", counts, want_c)
    if not gamma * V <= n_dec <= (gamma + 1) * V:
        raise AssertionError(f"{n_dec} draft steps for {V} windows")
    plain = llama.generate(params, cfg, prompt, 48, cache=llama.KVCache.create(
        cfg, 1, max_len, device=dev))[0].tolist()
    toks = toks[0].tolist()
    div = next((i for i, (a, b) in enumerate(zip(toks, plain)) if a != b),
               None)
    log(f"  speculative_generate equals generate on "
        f"{48 if div is None else div} of 48 tokens"
        + ("" if div is None else f" (then {toks[div]} vs {plain[div]})"))
    # draft = target is accepted but at bf16 near-ties, where the verify
    # pass (q4k_gemm, flash_attention) and the decode step (q4k_matvec,
    # flash_decode) round differently: every token where the stream leaves
    # the decode path's argmax (the divergence from generate among them)
    # must be a near-tie, within 2e-2 * max|logit| (the model-logits bound)
    _near_ties("speculative_generate", *_departures(params, cfg, prompt, toks,
                                                    dev), len(toks))
    # the rejections are near-ties, but a random 7B has many (logged above);
    # the floor is set under the acceptance measured on the card (0.886)
    acc = stats["accepted"] / stats["drafted"]
    log(f"  acceptance {acc:.3f}")
    _acceptance_floor("speculative_generate, draft = target", acc)

    # generate_scan's per-token marginal. LAUNCHES counts host calls: the
    # prefill, the eager step and its capture; the replays launch the
    # captured kernels again uncounted, and are reported apart
    replays = {}
    torch.cuda.synchronize()
    _reset_counts()
    t_plain = sb.plain_per_token(params, cfg, prompt)
    torch.cuda.synchronize()
    paths["generate_scan"] = counts = _counts()
    replays["generate_scan"] = 2 * (8 + 40)
    log(f"  [{card}] generate_scan: {t_plain * 1e3:.3f} ms/token "
        f"({1 / t_plain:.1f} tok/s; marginal of 8 and 40 replays of one "
        "captured step)")
    want_c = {k: 0 for k in counts}
    want_c.update(q4k_gemm=4 * L, flash_attention=L,
                  q4k_matvec=1 + 2 * (2 * L + 1), fused_mlp=2 * L,
                  flash_decode=2 * L, lse_merge=2 * L)
    _assert_counts("generate_scan (the prefill, one eager step and its "
                   f"capture; {replays['generate_scan']} replays uncounted)",
                   counts, want_c)

    # speculative_scan as CUDA graphs, three drafts
    tiny_cfg = PRESETS["tinyllama-1.1b"]
    tiny = llama.quantize_params(llama.init_weights(tiny_cfg, seed=seed + 12,
                                                    device=dev), "q4_k")
    d8, c8 = sb.truncated(params, cfg, 8)
    acc_tf = sb.teacher_forced_acceptance(params, cfg, d8, c8, prompt)
    log(f"  teacher-forced acceptance of target[:8 layers]: {acc_tf:.3f} "
        f"over 192 generated positions")
    metrics = {"card": card, "gamma": gamma, "plain_ms_per_token":
               t_plain * 1e3, "plain_tok_s": 1 / t_plain,
               "generate_stats": stats, "first_divergence": div,
               "teacher_forced_acceptance_8_layers": acc_tf, "drafts": {}}
    drafts = (("target", params, cfg), ("target[:8 layers]", d8, c8),
              ("tinyllama-1.1b", tiny, tiny_cfg))
    streams = {}
    for (name, dp, dc), slug in zip(drafts, ("target", "8_layers",
                                              "tinyllama")):
        path = f"speculative_scan_{slug}"
        torch.cuda.synchronize()
        _reset_counts()
        t_win, counts_w, stream = sb.window_cost(params, cfg, dp, dc, prompt,
                                                 gamma, 4, 16)
        torch.cuda.synchronize()
        paths[path] = counts = _counts()
        replays[path] = 2 * (4 + 16)
        # both prefills, one eager window and its capture
        Ld = dc.n_layers
        log(f"  launches in {path} (both prefills, one eager window and "
            f"its capture; {replays[path]} replays uncounted): {counts}")
        if (counts["flash_attention"] != L + Ld + 2 * L
                or counts["flash_decode"] != 2 * (gamma + 1) * Ld):
            raise AssertionError(f"{path}: {counts}")
        streams[name] = stream
        eager, _ = spec.speculative_generate(params, cfg, dp, dc, prompt,
                                             len(stream), gamma=gamma,
                                             max_len=max_len)
        if stream != eager[0].tolist():
            raise AssertionError(f"draft {name}: the graphs' stream differs "
                                 "from speculative_generate's")
        toks_win = float(counts_w.mean())
        acc = (toks_win - 1) / gamma
        if dp is params:
            # each window that rejects a draft token does so where its bonus
            # token leaves the decode path's argmax: at a near-tie
            deps = _near_ties("speculative_scan, draft = target",
                              *_departures(params, cfg, prompt, stream, dev),
                              len(stream))
            ends = np.cumsum(counts_w)            # stream[0] is cur
            bad = [w for w, (c, e) in enumerate(zip(counts_w, ends))
                   if c < gamma + 1 and int(e) not in deps]
            if bad:
                raise AssertionError(f"windows {bad} rejected a draft token "
                                     "away from a near-tie")
            _acceptance_floor("speculative_scan, draft = target", acc)
        a_star = sb.break_even(t_win, t_plain, gamma)
        log(f"  [{card}] draft {name}: {t_win * 1e3:.3f} ms/window, "
            f"{toks_win:.2f} tok/window (acceptance {acc:.3f}), "
            f"{toks_win / t_win:.1f} tok/s = "
            f"{sb.speedup(toks_win, t_plain, t_win):.3f}x generate_scan; "
            f"break-even acceptance "
            f"{'none' if a_star is None else f'{a_star:.2f}'}; stream of "
            f"{len(stream)} tokens equals speculative_generate's")
        metrics["drafts"][name] = {
            "ms_per_window": t_win * 1e3, "tok_per_window": toks_win,
            "acceptance": acc, "tok_s": toks_win / t_win,
            "speedup_vs_generate_scan": sb.speedup(toks_win, t_plain, t_win),
            "break_even_acceptance": a_star}
    # where a window's time goes: one verify pass (T = gamma + 1) and one
    # decode step of each draft, each alone in a CUDA graph (time_ms), the
    # cache rewound after each call
    tcache = llama.KVCache.create(cfg, 1, max_len, device=dev)
    tlog, _ = llama.prefill(params, cfg, prompt, tcache)
    cur = torch.argmax(tlog, -1).to(torch.int32)
    win = prompt[:, :gamma + 1]
    t_verify = time_ms(lambda i: spec.rewind(spec.chunk_step(
        params, cfg, win, tcache)[1], gamma + 1), calls=5, replays=3)
    log(f"  [{card}] one verify pass (chunk_step, T = {gamma + 1}): "
        f"{t_verify:.3f} ms")
    metrics["verify_ms"] = t_verify
    for name, dp, dc in drafts:
        dcache = llama.KVCache.create(dc, 1, max_len, device=dev)
        llama.prefill(dp, dc, prompt, dcache)
        t_step = time_ms(lambda i: spec.rewind(llama.decode_step(
            dp, dc, cur, dcache)[1], 1), calls=10, replays=3)
        m = metrics["drafts"][name]
        m["draft_step_ms"] = t_step
        log(f"  [{card}] draft {name}: one decode step {t_step:.3f} ms; "
            f"{gamma + 1} steps + a verify {(gamma + 1) * t_step + t_verify:.3f}"
            f" ms against the window's {m['ms_per_window']:.3f}")
        del dcache
    # the entry point: draft = target, 16 windows from the same start, its
    # stream that of the timed graph's 16-window run
    dcache = llama.KVCache.create(cfg, 1, max_len, device=dev)
    llama.prefill(params, cfg, prompt, dcache)
    tcache.lengths.fill_(prompt.shape[1])
    torch.cuda.synchronize()
    _reset_counts()
    toks_s, counts_s, *_ = spec.speculative_scan(
        params, cfg, params, cfg, cur, tcache, dcache, gamma=gamma,
        windows=16)
    toks_s, counts_s = toks_s.cpu().numpy(), counts_s.cpu().numpy()
    paths["speculative_scan"] = counts = _counts()
    replays["speculative_scan"] = 16
    want_c = {k: 0 for k in counts}
    want_c.update(q4k_gemm=2 * (4 * L + 1), flash_attention=2 * L,
                  q4k_matvec=2 * (gamma + 1) * (2 * L + 1),
                  fused_mlp=2 * (gamma + 1) * L,
                  flash_decode=2 * (gamma + 1) * L,
                  lse_merge=2 * (gamma + 1) * L)
    _assert_counts("speculative_scan (one eager window and its capture; "
                   "16 replays uncounted)", counts, want_c)
    stream = [int(cur[0])] + [t for row, n in zip(toks_s, counts_s)
                              for t in row[:n].tolist()]
    if stream != streams["target"]:
        raise AssertionError("speculative_scan's stream differs from the "
                             "timed window graph's")
    metrics["graph_replays"] = replays
    log(f"  graph replays by path (launching the captured kernels, not "
        f"counted in LAUNCHES): {replays}")
    del tiny, tcache, dcache
    torch.cuda.empty_cache()
    return paths, metrics


# ------------------------------------------------------- 10. distributed

PAR_TIMEOUT = {"attention": 300, "model": 720}   # s a run may take, spawns in
PAR_DECODE = 8                                   # decode steps a model run
PP_BATCH, PP_PROMPT = 4, 128                     # pipe = 2: 2 microbatches
PAR_ENGINE_PROMPTS, PAR_ENGINE_GEN = (16, 37, 64, 100), 8
PAR_ENGINE_KW = dict(max_batch=4, page_size=64, n_pages=32, max_seq_len=256)
PAR_ATTN_SHAPE = (32, 128, 2048, 4096)       # heads, D, S, decode length


def _dev_of(device):
    """A rank's device: its current card (``run_spmd`` sets card 0 for
    gloo ranks, card r for nccl rank r), or the CPU."""
    import torch
    if device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def _sync_peak(dev, reset=False):
    """Synchronize the card; its peak memory in GiB since the last reset
    (and reset it with ``reset``); 0 on the CPU."""
    import torch
    if dev.type != "cuda":
        return 0.0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return peak


def _empty_cache(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _par_attention_inputs(dev, seed, shape=PAR_ATTN_SHAPE):
    """10a's inputs, drawn alike on every rank and in the parent: q, k, v
    [1, H, S, D] bf16, and a decode query [1, H, D] with its cache k / v
    [1, H, S_dec, D] (llama2-7b's heads by default)."""
    import torch
    H, D, S, SD = shape
    g = torch.Generator(device=dev).manual_seed(seed + 20)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    return (rn(1, H, S, D), rn(1, H, S, D), rn(1, H, S, D), rn(1, H, D),
            rn(1, H, SD, D), rn(1, H, SD, D))


def _par_attention_rank(seed, device="cuda", shape=PAR_ATTN_SHAPE):
    """10a on one of 4 ranks: its sequence quarter of ring attention
    (causal and not) and of Ulysses attention (causal and not), and the
    context-parallel decode over its quarter of a 4096-long cache. Returns
    the outputs, the launch counts of these calls, wall times and peak
    memory."""
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
    from ggml_cuda_experiments_tpu_torch.parallel import ring_attention as ra
    dev = _dev_of(device)
    mesh = pm.Mesh(np.arange(4), ("seq",))
    n, me = pm.axis_size(mesh, "seq"), pm.axis_index(mesh, "seq")
    q, k, v, dq, dk, dv = _par_attention_inputs(dev, seed, shape)
    s, sd = q.shape[2] // n, dk.shape[2] // n
    q, k, v = (t[:, :, me * s:(me + 1) * s].contiguous() for t in (q, k, v))
    dk, dv = (t[:, :, me * sd:(me + 1) * sd].contiguous() for t in (dk, dv))
    lengths = torch.full((1,), sd, dtype=torch.int32, device=dev)
    calls = {
        "ring_causal": lambda: ra.ring_attention(q, k, v, mesh, "seq",
                                                 causal=True),
        "ring": lambda: ra.ring_attention(q, k, v, mesh, "seq"),
        "ulysses_causal": lambda: ra.ulysses_attention(q, k, v, mesh, "seq",
                                                       causal=True),
        "ulysses": lambda: ra.ulysses_attention(q, k, v, mesh, "seq"),
        "decode": lambda: ra.decode_context_parallel(dq, dk, dv, lengths,
                                                     mesh, "seq")}
    _sync_peak(dev, reset=True)
    _reset_counts()
    out, wall = {}, {}
    for name, fn in calls.items():
        t0 = time.perf_counter()
        out[name] = fn()
        _sync_peak(dev)
        wall[name] = time.perf_counter() - t0
    return {"out": out, "counts": _counts(), "wall_s": wall,
            "peak_gib": _sync_peak(dev),
            "transport": pm.transport(mesh, dev), "backend": mesh.backend}


def _par_model_rank(seed, prompt, forced, pp_prompt, pp_forced, eng_prompts,
                    device="cuda", cfg=None):
    """10b / 10c on one of 2 ranks: llama2-7b q4_k at full width and 32
    layers, its weights drawn again from the seed on this rank (phase 5's
    quantization: the single-rank port's weights). Three runs: seq = 2
    (ring prefill, context-parallel decode: the 5-axis step at pipe = model
    = 1), model = 2 (the TP step), pipe = 2 (``pp_forward``, 2 microbatches
    of 2). Each drives its real step twice, a prefill then the decode steps
    forced at the single-rank tokens: once as it is (launch counts,
    logits), and once with every layer's input forced to the single-rank
    port's through the step's ``layer_hook``, each layer's output held
    against the single-rank layer's on the same input. The single-rank port
    runs here on the same weights and kernel gates: phase 5's weights for
    seq and pipe, the TP weights whole for model = 2 (unfused, as TP takes
    them). Then Engine(mesh=) at model = 2, the single-rank Engine on the
    same weights, and that Engine's logits at each request's first
    departure. ``cfg``: another configuration (llama2-7b by default)."""
    import collections
    import dataclasses
    import numpy as np
    import torch
    from ggml_cuda_experiments_tpu_torch.models import engine as engine_mod
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.parallel import full, pipeline, tp
    from ggml_cuda_experiments_tpu_torch.parallel import mesh as pm
    dev = _dev_of(device)
    cfg = cfg or PRESETS["llama2-7b"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    dense = llama.init_weights(cfg, seed=seed, device=dev)
    params = llama.quantize_params(dense, "q4_k")         # phase 5's weights
    res = {}

    def drive(step, cache, prompt_t, steps, hook_of=lambda i: None):
        """A prefill, then the decode steps forced at ``steps``' tokens,
        through step(x, cache, decode, layer_hook) -> (logits, cache);
        returns the logits [steps + 1, B, V] f32."""
        out = []
        with torch.no_grad():
            for i in range(steps.shape[1] + 1):
                x = prompt_t if i == 0 else t(steps[:, i - 1])
                lg, cache = step(x, cache, i > 0, hook_of(i))
                out.append(lg.float())
        return torch.stack(out)

    def single(ref, prompt_t, steps):
        """The single-rank port on ``ref``: its logits, and every step's
        layer inputs ([step][layer] -> h)."""
        B = prompt_t.shape[0]
        ins = []

        def step(x, c, decode, hook):
            x = x[:, None] if decode else x
            T = x.shape[1]
            pos = (c.lengths[:, None].clone() if decode else
                   torch.arange(T, dtype=torch.int32, device=dev).expand(B, T))
            ins.append({})
            return llama._forward(
                ref, cfg, x, c, pos, decode=decode,
                layer_hook=lambda li, h, b0: ins[-1].setdefault(li, h))
        cache = llama.KVCache.create(cfg, B, 1024 if B == 1 else 256,
                                     device=dev)
        return drive(step, cache, prompt_t, steps), ins

    def run(name, step, new_cache, ref, prompt_t, steps, seq_rows=None):
        """The run ``name``: the real step timed and counted, the
        single-rank port on ``ref``, and the real step again with each
        layer's input forced. ``seq_rows``: this rank's prefill positions
        (a sequence shard)."""
        _sync_peak(dev, reset=True)
        _reset_counts()
        t0 = time.perf_counter()
        out = drive(step, new_cache(), prompt_t, steps)
        peak = _sync_peak(dev)
        r = res[name] = {"out": out.cpu(), "counts": _counts(),
                         "wall_s": time.perf_counter() - t0,
                         "peak_gib": peak}
        want, ins = single(ref, prompt_t, steps)
        errs = [[] for _ in ins]

        def hook_of(i):
            rows = slice(None) if i or seq_rows is None else seq_rows

            def hook(li, h, b0):
                w = ins[i][li][b0:b0 + h.shape[0], rows]
                if li:                  # h: the last layer's output
                    errs[i].append(float((h.float() - w.float()).abs().max()
                                         / w.float().abs().max()))
                return w.contiguous()
            return hook
        got = drive(step, new_cache(), prompt_t, steps, hook_of)
        r["ref"] = want.cpu()
        r["forced"] = {
            "layer_max": [max(e) for e in errs],
            "logits": [float((g - w).abs().max() / w.abs().max())
                       for g, w in zip(got, want)]}
        del ins

    # seq = 2: ring prefill, context-parallel decode
    mesh = full.make_full_mesh(2, dict(data=1, pipe=1, seq=2, model=1,
                                       expert=1))
    sp, _ = full.shard_full_params(params, mesh, cfg)
    T = prompt.shape[1]
    steps = {d: full.make_full_step(cfg, mesh, n_micro=1, prefill_len=T,
                                    decode=d) for d in (False, True)}
    me, t_loc = pm.axis_index(mesh, "seq"), T // 2
    run("seq", lambda x, c, d, hook: steps[d](sp, x, c, layer_hook=hook),
        lambda: full.create_full_cache(cfg, mesh, 1, 1024, device=dev),
        params, t(prompt), forced, slice(me * t_loc, (me + 1) * t_loc))
    res["transport"] = pm.transport(mesh, dev)
    del sp
    _empty_cache(dev)

    # model = 2: the TP step, then Engine(mesh=) on the same shards
    mesh = pm.make_mesh(model=2, data=1)
    q = tp.quantize_params_sharded(dense, "q4_k", 2)      # the TP weights
    del dense
    sp = tp.shard_params(q, mesh)
    _empty_cache(dev)
    steps = {d: tp.make_tp_step(cfg, mesh, sp, decode=d)
             for d in (False, True)}
    run("model", lambda x, c, d, hook: steps[d](sp, x, c, layer_hook=hook),
        lambda: tp.create_sharded_cache(cfg, mesh, 1, 1024, device=dev),
        q, t(prompt), forced)
    eng = engine_mod.Engine(sp, cfg, mesh=mesh, **PAR_ENGINE_KW)
    calls = collections.Counter()
    with _count_steps(engine_mod, calls):
        _sync_peak(dev, reset=True)
        _reset_counts()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = _serve(eng, eng_prompts, PAR_ENGINE_GEN)
        res["engine"] = {"out": out, "counts": _counts(),
                         "peak_gib": _sync_peak(dev),
                         "wall_s": time.perf_counter() - t0,
                         "calls": dict(calls),
                         "pool_heads": eng.pool.k.shape[2]}
    del eng, sp
    with torch.no_grad():
        single_eng = engine_mod.Engine(q, cfg, **PAR_ENGINE_KW)
        res["engine_single"] = _serve(single_eng, eng_prompts,
                                      PAR_ENGINE_GEN)
        res["engine"]["departures"] = _engine_departures(
            single_eng, eng_prompts, res["engine"]["out"],
            res["engine_single"])
    del single_eng, q
    _empty_cache(dev)

    # pipe = 2: this stage's 16 layers of the same weights, 2 microbatches
    mesh = pm.Mesh(np.arange(2), ("pipe",))
    r = pipeline.stage_range(cfg.n_layers, mesh)
    sp = dict(params, layers=params["layers"][r.start:r.stop])
    scfg = dataclasses.replace(cfg, n_layers=len(r))
    run("pipe", lambda x, c, d, hook: pipeline.pp_forward(
            sp, cfg, x[:, None] if d else x, c, decode=d, n_micro=2,
            mesh=mesh, layer_hook=hook),
        lambda: llama.KVCache.create(scfg, PP_BATCH, 256, device=dev),
        params, t(pp_prompt), pp_forced)
    res["stage_layers"] = [r.start, r.stop]
    return res


def _engine_departures(eng, prompts, got, want):
    """Per request, None where ``got`` equals the single-rank engine's
    ``want``, else (i, want[i], got[i], gap, max|logit|) at the first
    departure i: ``eng`` (that engine) serves the prompt and want[:i] as
    a new request, and its prefill logits there, caught at its sampler,
    give gap = logit[want[i]] - logit[got[i]]."""
    out = []
    for p, a, b in zip(prompts, got, want):
        i = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if i is None:
            out.append(None)
            continue
        seen, sample = [], eng._sample
        eng._sample = lambda lg: (seen.append(lg.float()), sample(lg))[1]
        try:
            _serve(eng, [list(p) + list(b[:i])], 1)
        finally:
            del eng._sample
        w = seen[0][0]
        out.append((i, b[i], a[i], float(w[b[i]] - w[a[i]]),
                    float(w.abs().max())))
    return out


def _par_check(what, o):
    """A run's checks on one rank's results ``o``. The real step, forced
    only at the tokens: finite logits of the single-rank shape, their
    distance from the single-rank port on the same weights (logged:
    free-running logits drift, ROADMAP C.2.1), the greedy tokens that
    agree, and every one that does not a near-tie of the single-rank
    logits (2e-2 * max|logit|). The real step with every layer's input
    forced (``forced``): each layer's output within 2e-2 of max of the
    single-rank layer's, and the logits within 2e-2 * max."""
    import torch
    rels, agree, total, far = [], 0, 0, []
    for i, (g, w) in enumerate(zip(o["out"], o["ref"])):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: step {i} logits {tuple(g.shape)} "
                                 "or non-finite")
        rels.append(float((g - w).abs().max() / w.abs().max()))
        for row, (d, s) in enumerate(zip(g.argmax(-1).tolist(),
                                         w.argmax(-1).tolist())):
            total += 1
            agree += d == s
            gap = float(w[row, s] - w[row, d])
            if gap > 2e-2 * float(w[row].abs().max()):
                far.append((i, row, d, s, gap))
    lay = max(o["forced"]["layer_max"])
    lgt = max(o["forced"]["logits"])
    log(f"  {what}: free-running (token-forced) logits "
        f"{' '.join(f'{r:.2e}' for r in rels)} of max; greedy tokens agree "
        f"{agree} / {total}; every layer's input forced: worst layer "
        f"{lay:.3e}, logits {lgt:.3e} of max over "
        f"{len(o['forced']['logits'])} steps (bounds 2e-2)")
    if far:
        raise AssertionError(f"{what}: greedy departures that are no "
                             f"near-tie (step, row, got, want, gap): {far}")
    if not (lay <= 2e-2 and lgt <= 2e-2):
        raise AssertionError(f"{what}: layer inputs forced: layer {lay}, "
                             f"logits {lgt} > 2e-2 of max")
    return {"free_running_rel": rels, "greedy_agree": agree,
            "greedy_total": total, "forced_layer_max": lay,
            "forced_logits_rel": lgt}


def _par_counts(what, per_rank, want_of):
    """Assert every rank's counts (``want_of(rank)``); return their sum."""
    total = {}
    for r, c in enumerate(per_rank):
        _assert_counts(f"{what} rank {r}", c, want_of(r))
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_parallel(dev, seed, params, prompts, card, cfg=None,
                   attn_shape=PAR_ATTN_SHAPE):
    """10. The distributed paths at llama2-7b, q4_k, full width: ranks are
    processes sharing the one card over a gloo group (collectives staged
    through host memory), spawned by ``launch.run_spmd`` after the parent
    has built the kernels. Returns (launch counts by path, metrics).
    ``cfg`` / ``attn_shape``: other shapes (``params`` then in that
    configuration; prompts[2] its long prompt)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import engine as engine_mod
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import flash_attention as fa
    from ggml_cuda_experiments_tpu_torch.ops import flash_decode as fd
    from ggml_cuda_experiments_tpu_torch.parallel.launch import run_spmd
    cfg = cfg or PRESETS["llama2-7b"]
    L = cfg.n_layers
    log("== 10. distributed paths: ranks are processes sharing this one "
        f"card ({card}) over a gloo group; every wall time below is a "
        "shared-card, host-staged-transport time, not a scaling figure")
    _empty_cache(dev)
    metrics, paths = {}, {}

    # 10a: attention alone at 4 ranks
    t0 = time.perf_counter()
    outs = run_spmd(_par_attention_rank, 4, "gloo", dev.type,
                    PAR_TIMEOUT["attention"], args=(seed, dev.type,
                                                    attn_shape))
    wall = time.perf_counter() - t0
    log(f"  10a. 4 ranks, backend {outs[0]['backend']}, transport "
        f"{outs[0]['transport']}; spawn to results {wall:.1f} s")
    q, k, v, dq, dk, dv = _par_attention_inputs(dev, seed, attn_shape)
    refs = {"ring_causal": fa.flash_attention(q, k, v, causal=True),
            "ring": fa.flash_attention(q, k, v),
            "ulysses_causal": fa.flash_attention(q, k, v, causal=True),
            "ulysses": fa.flash_attention(q, k, v),
            "decode": fd.flash_decode(dq, dk, dv)}
    att = {}
    for name, ref in refs.items():
        ref = ref.float().cpu()
        got = (outs[0]["out"][name].float() if name == "decode" else
               torch.cat([o["out"][name].float() for o in outs], 2))
        if name == "decode" and not all(
                torch.equal(o["out"][name], outs[0]["out"][name])
                for o in outs):
            raise AssertionError("decode_context_parallel differs by rank")
        err, sc = rel_err(got, ref)
        if not err <= 2e-2 * sc:
            raise AssertionError(f"10a {name}: {err} > 2e-2 * {sc}")
        walls = [o["wall_s"][name] for o in outs]
        att[name] = {"max_abs_err": err, "scale": sc, "wall_s": walls}
        one = "flash_decode" if name == "decode" else "flash_attention"
        log(f"    {name:15s} vs single-rank {one}: "
            f"max_abs_err {err:.3e} (bound 2e-2*{sc:.3e}); rank wall "
            f"{max(walls) * 1e3:.1f} ms")
    del q, k, v, dq, dk, dv, refs
    zero = {key: 0 for key in outs[0]["counts"]}
    # the causal ring launches for the blocks at or before the rank's own
    paths["parallel_attention"] = _par_counts(
        "10a attention", [o["counts"] for o in outs],
        lambda r: dict(zero, flash_attention_lse=4 + r + 1,
                       flash_attention=2, flash_decode=1))
    metrics["attention"] = dict(
        att, peak_gib=[o["peak_gib"] for o in outs], wall_s=wall)
    log(f"    peak memory per rank {[round(o['peak_gib'], 2) for o in outs]}"
        " GiB")

    # 10b / 10c: the model at 2 ranks, against the single-rank port
    g = torch.Generator(device=dev).manual_seed(seed + 21)
    prompt = prompts[2]                                   # 512 tokens
    toks = llama.generate(params, cfg, prompt, steps=PAR_DECODE)
    pp_prompt = torch.randint(1, cfg.vocab_size, (PP_BATCH, PP_PROMPT),
                              generator=g, device=dev)
    pp_toks = llama.generate(params, cfg, pp_prompt, steps=PAR_DECODE)
    eng_prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=g,
                                 device=dev).tolist()
                   for n in PAR_ENGINE_PROMPTS]
    ref_eng = _serve(engine_mod.Engine(params, cfg, **PAR_ENGINE_KW),
                     eng_prompts, PAR_ENGINE_GEN)
    _empty_cache(dev)
    t0 = time.perf_counter()
    outs = run_spmd(_par_model_rank, 2, "gloo", dev.type,
                    PAR_TIMEOUT["model"],
                    args=(seed, prompt.cpu().numpy(), toks,
                          pp_prompt.cpu().numpy(), pp_toks, eng_prompts,
                          dev.type, cfg))
    wall = time.perf_counter() - t0
    log(f"  10b. 2 ranks, transport {outs[0]['transport']}; spawn to "
        f"results {wall:.1f} s (weights drawn and quantized on each rank)")
    for run in ("seq", "model", "pipe"):
        for r, o in enumerate(outs):
            m = _par_check(f"{run} = 2 rank {r}", o[run])
        metrics[run] = dict(m, wall_s=[o[run]["wall_s"] for o in outs],
                            peak_gib=[o[run]["peak_gib"] for o in outs])
        log(f"    {run} = 2: rank wall "
            f"{[round(o[run]['wall_s'], 2) for o in outs]} s, peak "
            f"{[round(o[run]['peak_gib'], 2) for o in outs]} GiB")
    steps = PAR_DECODE
    zero = {key: 0 for key in outs[0]["seq"]["counts"]}

    def seq_want(r):
        # the causal ring prefill: rank 0 attends its own block, rank 1
        # rank 0's and its own
        return dict(zero, q4k_gemm=4 * L, flash_attention_lse=(r + 1) * L,
                    q4k_matvec=1 + steps * (2 * L + 1),
                    fused_mlp=steps * L, flash_decode=steps * L)

    def model_want(r):
        return dict(zero, q4k_gemm=7 * L, flash_attention=L,
                    q4k_matvec=1 + steps * (7 * L + 1),
                    flash_decode=steps * L, lse_merge=steps * L)

    def pipe_want(r):
        passes = (2 + 2 - 1) * (L // 2)       # every step runs the stage
        heads = 2 * (1 + steps) if r == 1 else 0
        return dict(zero, q4k_gemm=4 * passes * (1 + steps) + heads,
                    flash_attention=passes, flash_decode=passes * steps,
                    lse_merge=passes * steps)

    for run, fn in (("seq", seq_want), ("model", model_want),
                    ("pipe", pipe_want)):
        paths[f"parallel_{run}"] = _par_counts(
            f"10b {run} = 2", [o[run]["counts"] for o in outs], fn)
    # 10c: the TP Engine against the single-rank Engine
    calls = outs[0]["engine"]["calls"]
    fills, dsteps = calls["_paged_prefill"], calls["_paged_decode_step"]

    def engine_want(r):
        return dict(zero, q4k_gemm=fills * 7 * L + dsteps * (7 * L + 1),
                    q4k_matvec=fills, flash_attention=fills * L,
                    paged_decode=dsteps * L)

    paths["parallel_engine"] = _par_counts(
        "10c engine", [o["engine"]["counts"] for o in outs], engine_want)
    agree = total = 0
    for o in outs:
        if o["engine"]["out"] != outs[0]["engine"]["out"]:
            raise AssertionError("10c: the ranks' engines disagree")
        if o["engine"]["pool_heads"] != cfg.n_kv_heads // 2:
            raise AssertionError("10c: pool not sharded over model")
    log(f"  10c. Engine(mesh=) at model = 2: {len(eng_prompts)} requests, "
        f"{fills} prefills, {dsteps} decode steps; rank wall "
        f"{[round(o['engine']['wall_s'], 2) for o in outs]} s")
    single = outs[0]["engine_single"]
    far = []
    for pr, a, b, c, dep in zip(eng_prompts, outs[0]["engine"]["out"],
                                single, ref_eng,
                                outs[0]["engine"]["departures"]):
        if len(a) != PAR_ENGINE_GEN or not all(0 <= x < cfg.vocab_size
                                               for x in a):
            raise AssertionError(f"10c: {a}")
        agree += sum(x == y for x, y in zip(a, b))
        total += len(b)
        fused_agree = sum(x == y for x, y in zip(a, c))
        log(f"    prompt {len(pr)}: TP {a}; single-rank on the same weights "
            f"{b}; phase 5's fused single-rank Engine agrees "
            f"{fused_agree} / {len(c)}")
        if dep is not None:
            i, want_t, got_t, gap, top = dep
            log(f"      first departure at token {i}: single-rank {want_t}, "
                f"TP {got_t}; the single-rank Engine's logit gap there "
                f"{gap:.4f} of max |logit| {top:.3f} (near-tie bound "
                f"2e-2 * max = {2e-2 * top:.4f})")
            if gap > 2e-2 * top:
                far.append((len(pr), dep))
    log(f"  10c. tokens agree with the single-rank Engine on the same "
        f"weights {agree} / {total}; every request equal up to its first "
        "departure, if any")
    if far:
        raise AssertionError(f"10c: departures from the single-rank Engine "
                             f"that are no near-tie (prompt length, "
                             f"(token, want, got, gap, max)): {far}")
    metrics["engine"] = {"agree": agree, "total": total,
                         "wall_s": [o["engine"]["wall_s"] for o in outs]}
    metrics["transport"] = outs[0]["transport"]
    return paths, metrics


# ---------------------------------------------------------------------------
# 12. mixtral-8x7b, 13. llama3-8b, 14. llama2-70b
# ---------------------------------------------------------------------------

FORCED_STEPS = 2            # decode steps teacher-forced after the prompt
# phase 5's prompts with 8 tokens generated each: an eager Mixtral step
# takes 150-260 ms of host time, and the smoke must stay under its limit;
# llama2-70b takes the same requests
MIXTRAL_REQUESTS = tuple((p, 8) for p, _ in REQUESTS)


def _layerwise_params(cfg, seed, dev, head_fmt="q4_k"):
    """``cfg``'s weights built on the card one layer at a time (the dense
    bf16 model may not fit): each linear drawn from one seeded generator,
    quantized at once and its dense copy freed. A dense layer goes through
    ``quantize_params`` as a one-layer tree (q4_k; wq | wk | wv fused into
    ``wqkv``, w_gate | w_up into ``w_gu``, the intermediate padded by its
    rule). A MoE layer's attention as ``quantize_params`` makes it, each
    expert's w_gate, w_up and w_down through ``quantize`` (q4_k), the E
    experts of each stacked by ``moe.stack_expert_quant``, the router dense
    bf16. Norms and the embed dense bf16; the head in ``head_fmt``
    (llama.cpp's Q4_K_M keeps output.weight in Q6_K)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama, moe
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hd, E = cfg.dim, cfg.head_dim, cfg.n_experts
    inter = cfg.moe_intermediate or cfg.intermediate

    def lin(n, k):
        return (torch.randn((n, k), generator=gen, device=dev)
                / float(k ** 0.5)).to(torch.bfloat16)

    def quant(w, fmt="q4_k"):
        return qm.quantize(w.float(), fmt)

    def ones():
        return torch.ones((d,), dtype=torch.bfloat16, device=dev)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {"wq": lin(cfg.n_heads * hd, d),
                 "wk": lin(cfg.n_kv_heads * hd, d),
                 "wv": lin(cfg.n_kv_heads * hd, d),
                 "wo": lin(d, cfg.n_heads * hd),
                 "attn_norm": ones(), "mlp_norm": ones()}
        if not cfg.is_moe:
            layer.update(w_gate=lin(inter, d), w_up=lin(inter, d),
                         w_down=lin(d, inter))
            layers.append(llama.quantize_params(
                {"layers": [layer]}, "q4_k", quantize_head=False)
                ["layers"][0])
            continue
        layer["wqkv"] = quant(torch.cat([layer.pop(k)
                                         for k in ("wq", "wk", "wv")]))
        layer["wo"] = quant(layer["wo"])
        layer["router"] = lin(E, d)
        for key, (n, k) in (("w_gate", (inter, d)), ("w_up", (inter, d)),
                            ("w_down", (d, inter))):
            layer[key] = moe.stack_expert_quant([quant(lin(n, k))
                                                 for _ in range(E)])
        layers.append(layer)
    embed = (torch.randn((cfg.vocab_size, d), generator=gen, device=dev)
             * 0.02).to(torch.bfloat16)
    return {"embed": embed, "layers": layers, "final_norm": ones(),
            "lm_head": quant(lin(cfg.vocab_size, d), head_fmt)}


def _linear_kernels(res, tag, sets, dev, ms=(8, 512), matvec="q4k_matvec"):
    """A model's own q4_k weights through the batch-1 matvec (``matvec``:
    q4k_matvec, or q4k_q8_matvec as x_quant8 runs it) and q4k_gemm at M in
    ``ms``: ``sets`` [(name, [QuantLinear of one shape, ...])], a linear's
    copies in consecutive layers or experts, of which as many as stream
    past the L2 are cycled (one where one does). Each against its plain
    version, timed as phase 4's cases (``tools/qgemm_bench.py``'s timing),
    beside its bound."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    from ggml_cuda_experiments_tpu_torch.utils.bench import copies_for
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    spec = _spec()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(41)
    fn = getattr(qm, matvec)
    kind = "int8" if matvec == "q4k_q8_matvec" else "f32"
    for key, copies in sets:
        ws = copies[:copies_for(copies[0].nbytes)]
        n, k = ws[0].array_shape
        x = torch.randn((1, k), generator=g, device=dev)
        y = fn(x, ws[0])
        with plain_versions():
            ref = fn(x, ws[0])
        err, sc = rel_err(y, ref)
        ms_ = time_ms(lambda i: fn(x, ws[i % len(ws)]), calls=qb.CHAIN)
        with plain_versions():
            pms = time_ms(lambda i: fn(x, ws[i % len(ws)]), calls=2,
                          replays=3)
        nbytes, flops = ws[0].nbytes + 4 * (k + n), 2 * n * k
        split = (f"splits {qm.matvec_splits(n, k, sms)}, "
                 if matvec == "q4k_matvec" else "")
        res.add(matvec, f"{tag} {key} N={n} K={k} ({split}{len(ws)} "
                "copies)", err, sc, 1e-4, ms_, pms,
                spec.bound_ms(nbytes, flops, kind))
        log(f"    {_rate(nbytes, flops, ms_, kind)}")
        for m in ms:
            x = qb.gemm_x(m, n, k, dev)
            y = qm.q4k_gemm(x, ws[0])
            with plain_versions():
                ref = qm.q4k_gemm(x, ws[0])
            err, sc = rel_err(y, ref)
            t = qb.gemm_times(qm, qm.q4k_gemm, x, ws)
            with plain_versions():
                pms = time_ms(lambda i: qm.q4k_gemm(x, ws[i % len(ws)]),
                              calls=2, replays=3)
            nbytes = ws[0].nbytes + 2 * m * k + 4 * m * n
            res.add("q4k_gemm", f"{tag} {key} M={m} N={n} K={k} "
                    f"({qm.gemm_route(m)}, {len(ws)} copies)", err, sc,
                    2e-2, t["ms"], pms,
                    spec.bound_ms(nbytes, 2 * m * n * k, "bf16"))
            lib = (f"; torch.matmul on the dequantized bf16 W "
                   f"{t['matmul_ms']:.4f} ms" if "matmul_ms" in t else "")
            log(f"    {_rate(nbytes, 2 * m * n * k, t['ms'])}{lib}")
        del ws
        torch.cuda.empty_cache()


def _step_profile(params, cfg, prompt, dev, parts, steps: int = 2):
    """Where a decode step's device time goes: torch.profiler over
    ``steps`` eager decode steps after ``prompt``'s prefill, the kernels
    whose names hold each of ``parts`` ({label: name part}) apart from the
    rest; the device's busy share of the (host-bound) eager wall time."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    cache = llama.KVCache.create(cfg, 1, 256, device=dev)
    logits, cache = llama.prefill(params, cfg, prompt, cache)
    tok = torch.argmax(logits, -1).to(torch.int32)
    llama.decode_step(params, cfg, tok, cache)

    def run():
        t = tok
        for _ in range(steps):
            lg, _ = llama.decode_step(params, cfg, t, cache)
            t = torch.argmax(lg, -1).to(torch.int32)

    _, wall_us, busy, events = _profiled(run)
    out = {"wall_ms": wall_us / steps / 1e3, "busy_ms": busy / steps / 1e3,
           "kernels": sum(e.count for e in events) // steps}
    rest = out["busy_ms"]
    text = []
    for label, part in parts.items():
        ev = [e for e in events if part in e.key]
        out[f"{label}_ms"] = sum(_dev_us(e) for e in ev) / steps / 1e3
        out[f"{label}_calls"] = sum(e.count for e in ev) // steps
        rest -= out[f"{label}_ms"]
        text.append(f"{part} {out[f'{label}_ms']:.3f} ms in "
                    f"{out[f'{label}_calls']} calls")
    log(f"  a decode step under torch.profiler ({steps} eager steps): wall "
        f"{out['wall_ms']:.2f} ms, device busy {out['busy_ms']:.2f} ms "
        f"({100 * busy / wall_us:.1f}%) in {out['kernels']} kernels, of "
        f"which {', '.join(text)}; the rest {rest:.3f} ms")
    _log_top(events, steps, "step")
    return out


def _generate_and_scan(params, cfg, prompts, requests, tag, step, head,
                       gemms, by_k=None, gemm="q4k_gemm",
                       matvec="q4k_matvec"):
    """``generate`` on ``requests`` with its launches asserted: ``step``
    ({kernel: launches}) a decode step; a prefill ``gemms`` ``gemm`` (on
    ``gemm_route``'s route, asserted too), one ``head`` launch (the last
    row), flash_attention and rope_pack as ``_prefill_counts`` has them;
    ``matvec``'s launches by K against ``by_k`` ({K: launches} over the
    run) where given. Then ``generate_scan`` (each request's decode step captured once
    into a CUDA graph and replayed) token-equal to generate, its launches
    asserted: the prefills, one eager step and its capture a request (the
    replays are not counted). Returns ({path: counts}, generate's
    tokens)."""
    import collections
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    L, R = cfg.n_layers, len(requests)
    name = tag.replace(" ", "_").replace("-", "_").replace(".", "_")
    dev = prompts[0].device

    def want(decode_steps):
        w = _prefill_counts(L, requests, gemm=gemm)
        w[gemm] = gemms * sum(1 for p, _ in requests if 2 <= p <= 512)
        w[head] += R
        for k, v in step.items():
            w[k] += v * decode_steps
        return w

    tally = collections.Counter()
    matvec_fn = getattr(qm, matvec)

    def tallied(x, w):                   # the matvec's launches by K
        tally[w.array_shape[1]] += 1
        return matvec_fn(x, w)

    routes0 = dict(qm.GEMM_ROUTE_LAUNCHES)
    with contextlib.ExitStack() as stack:
        stack.callback(setattr, qm, matvec, matvec_fn)
        setattr(qm, matvec, tallied)
        outs, counts = _drive_generate(params, cfg, prompts, requests,
                                       f"generate {tag}")
    routes = {r: n - routes0.get(r, 0)
              for r, n in qm.GEMM_ROUTE_LAUNCHES.items()}
    _assert_counts(f"generate {tag}", counts,
                   want(sum(n for _, n in requests)))
    r_want = {r: 0 for r in routes}
    for p, _ in requests:
        r_want[qm.gemm_route(p)] += gemms
    log(f"  {matvec} by K {dict(tally)}" + (f" (want {by_k})" if by_k
                                             else "")
        + f"; {gemm} by route {routes} (want {r_want})")
    if routes != r_want or (by_k is not None and tally != by_k):
        raise AssertionError(f"{tag}: {matvec} by K {dict(tally)}, "
                             f"{gemm} by route {routes}")
    per_step = ", ".join(f"{v} {k}" for k, v in step.items())
    log(f"  launch counts equal what the path implies (per decode step "
        f"{per_step}; per prefill {gemms} {gemm}, 1 {head}, {L} "
        f"flash_attention, {L} rope_pack at prompts 128 and 512)")
    paths = {f"generate_{name}": counts}

    torch.cuda.synchronize()
    _reset_counts()
    for (p, n), prompt, toks in zip(requests, prompts, outs):
        scan = llama.generate_scan(params, cfg, prompt,
                                   _cache(cfg, p, n, dev, {}), n)
        if scan.tolist() != toks.tolist():
            raise AssertionError(f"{tag}: generate_scan (prompt {p}) gave "
                                 f"{scan[0, :8]}..., generate {toks[0, :8]}")
    counts = _counts()
    _assert_counts(f"generate_scan {tag} (the prefills, one eager step and "
                   "one capture a request)", counts, want(2 * R))
    paths[f"generate_scan_{name}"] = counts
    log(f"  {tag}: generate_scan's tokens equal generate's for every "
        "request")
    return paths, outs


def _graph_rate(params, cfg, prompt, timing, bound_ms, card, tag):
    """generate_scan's ms a token (the marginal of 8 and 40 replays of one
    captured step after ``prompt``'s prefill; uncounted) beside the eager
    rate of each request and the stream bound; TTFT at 512."""
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    t_tok = sb.plain_per_token(params, cfg, prompt)
    eager = [1e3 / t["decode_tok_s"] for t in timing]
    log(f"  [{card}] {tag}: decode eager "
        + ", ".join(f"{e:.2f}" for e in eager)
        + f" ms a token (prompts {', '.join(str(t['prompt']) for t in timing)}"
        f"), graph {t_tok * 1e3:.3f} ms a token ({1 / t_tok:.2f} tok/s; the "
        f"stream bound {bound_ms:.3f} ms, {100 * bound_ms / (t_tok * 1e3):.1f}"
        f"% of it); TTFT at 512 {timing[-1]['ttft_ms']:.2f} ms")
    return {"graph_ms_per_token": t_tok * 1e3, "eager_ms_per_token": eager,
            "ttft_512_ms": timing[-1]["ttft_ms"], "requests": timing}


def _built(params, t0, card, tag):
    """Build seconds, peak memory and the stream bound of a model just
    built, logged; its metrics."""
    import torch
    from ggml_cuda_experiments_tpu_torch.tools.bench import stream_bytes
    torch.cuda.synchronize()
    spec = _spec()
    stream = stream_bytes(params)        # every expert: dense dispatch
    metrics = {"build_s": time.perf_counter() - t0,
               "peak_build_gib": torch.cuda.max_memory_allocated() / 2**30,
               "stream_bytes": stream, "embed_bytes": params["embed"].nbytes,
               "bound_ms": 1e3 * stream / spec.hbm_bytes_per_s}
    log(f"  [{card}] {tag}: built in {metrics['build_s']:.2f} s, peak "
        f"{metrics['peak_build_gib']:.2f} GiB; a decode token streams "
        f"{stream} bytes + the bf16 embed {params['embed'].nbytes}; the "
        f"stream bound {metrics['bound_ms']:.3f} ms a token at {spec.name}'s "
        "HBM rate")
    return metrics


def _prompts(cfg, requests, seed, dev):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(1, cfg.vocab_size, (1, p), generator=g,
                          device=dev, dtype=torch.int64)
            for p, _ in requests]


def _forced_tokens(outs, dev):
    import torch
    return torch.from_numpy(outs[0][0, :FORCED_STEPS]).to(dev, torch.int32)


def _phase_end(params, metrics, t_phase, card, tag):
    """Peak memory of the phase, the model freed, its seconds."""
    import torch
    metrics["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    params.clear()
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{card}] {tag} in {metrics['phase_s']:.1f} s, peak device "
        f"memory {metrics['peak_gib']:.2f} GiB")


def phase_mixtral(dev, seed, res: Results, card):
    """mixtral-8x7b at full width and depth (32 layers, dim 4096, GQA
    32/8, 8 experts of intermediate 14336, top-2, rope_theta 1e6), q4_k
    attention and experts, a q6_k head, a bf16 cache, the preset's flags:
    MoE layers have no ``w_gu`` and x_quant8 is off, so every fused decode
    kernel stays closed and each expert linear is its own q4k_matvec (one
    row) or q4k_gemm (a prompt). The reference's dense dispatch: every
    expert runs on every token."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import moe
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    cfg = PRESETS["mixtral-8x7b"]
    L, E = cfg.n_layers, cfg.n_experts
    steps = sum(n for _, n in MIXTRAL_REQUESTS)
    per_step = (2 + 3 * E) * L          # wqkv, wo and the experts' linears
    t_phase = time.perf_counter()
    log(f"== 12. {cfg.name}: dim {cfg.dim}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, {E} experts (top "
        f"{cfg.n_active_experts}) of intermediate {cfg.intermediate}, q4_k "
        "attention and experts, q6_k head, bf16 cache, dense dispatch")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _layerwise_params(cfg, seed + 40, dev, head_fmt="q6_k")
    metrics = _built(params, t0, card, f"{cfg.name} one layer at a time "
                     "(every expert streamed: dense dispatch)")
    _linear_kernels(res, "mixtral", [
        (key, [moe._expert_slice(layer[key], e)
               for layer in params["layers"][:2] for e in range(E)])
        for key in ("w_gate", "w_down")], dev)
    prompts = _prompts(cfg, MIXTRAL_REQUESTS, seed + 41, dev)
    paths, outs = _generate_and_scan(
        params, cfg, prompts, MIXTRAL_REQUESTS, "mixtral",
        {"q4k_matvec": per_step, "q6k_q8_matvec": 1, "flash_decode": L,
         "lse_merge": L}, "q6k_q8_matvec", per_step,
        by_k={cfg.dim: (2 + 2 * E) * L * steps,
              cfg.intermediate: E * L * steps})
    timing = _time_requests(params, cfg, prompts, MIXTRAL_REQUESTS, outs, dev)
    metrics.update(_graph_rate(params, cfg, prompts[0], timing,
                               metrics["bound_ms"], card, cfg.name))
    metrics["profile"] = _step_profile(params, cfg, prompts[0], dev,
                                       {"matvec": "q4_matvec"})
    # teacher-forced against the plain versions on the card: every layer's
    # input forced to the kernel path's, each layer and the logits within
    # 2e-2 * max
    _check_forced(params, cfg, prompts[0], _forced_tokens(outs, dev), dev)
    _phase_end(params, metrics, t_phase, card, "phase 12")
    return paths, metrics


def _rope_case(res, spec, dev, g, T, hq, hkv, theta, tag):
    """rope_pack at a T-token prompt of ``hq`` / ``hkv`` heads of 128 and
    RoPE base ``theta``, its tables made once and given (as a prefill hands
    them to each layer), bit-exact against its plain version."""
    from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    inputs = qb.rope_inputs(dev, T, hq, hkv, g)
    ys, pos, kw = inputs
    tables = pf.rope_tables(pos, kw["head_dim"], theta)
    nbytes, ops = qb.rope_bytes(inputs, True)
    _versus_plain(res, "rope_pack", f"{tag} T={T} {hq}/{hkv} D=128 theta "
                  f"{theta:g} ({len(ys)} copies), tables given",
                  lambda i: pf.rope_pack_prefill(
                      ys[i % len(ys)], pos, **kw, rope_theta=theta,
                      tables=tables), 0.0, spec.bound_ms(nbytes, ops, "f32"))


def _llama3_kernels(res, params, cfg, dev, seed):
    """llama3-8b's new shapes on the model's own weights: q4k_matvec and
    q4k_gemm (M 16, 512) at w_gu [32768, 4096] and w_down [4096, 16384] (K
    padded from 14336), q4k_matvec and q4k_q8_matvec at the 128256-row
    head, fused_mlp at Kd 16384, fused_attention at GQA 32/8 and theta 5e5
    over 513 keys, rope_pack at 32/8 and theta 5e5; each against its plain
    version, beside its bound."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    spec = _spec()
    layers, tag = params["layers"], cfg.name
    _linear_kernels(res, tag, [(k, [lay[k] for lay in layers])
                               for k in ("w_gu", "w_down")], dev, ms=(16, 512))
    head = [("lm_head", [params["lm_head"]])]
    _linear_kernels(res, tag, head, dev, ms=())
    _linear_kernels(res, tag, head, dev, ms=(), matvec="q4k_q8_matvec")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((1, cfg.dim), generator=g, device=dev)
    gu, down = layers[0]["w_gu"].array_shape, layers[0]["w_down"].array_shape
    nbytes = layers[0]["w_gu"].nbytes + layers[0]["w_down"].nbytes
    _versus_plain(res, "fused_mlp", f"{tag} w_gu {gu[0]}x{gu[1]}, w_down "
                  f"{down[0]}x{down[1]} (2 layers)",
                  lambda i: qm.mlp_fused(x, layers[i % 2]["w_gu"],
                                         layers[i % 2]["w_down"]), 5e-3,
                  spec.bound_ms(nbytes + 8 * cfg.dim,
                                2 * (gu[0] * gu[1] + down[0] * down[1]),
                                "int8"))
    hkv, S, length = cfg.n_kv_heads, 1024, 512
    kc = torch.randn((2, 1, hkv, S, cfg.head_dim), generator=g,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 1, hkv, S, cfg.head_dim), generator=g,
                     device=dev).to(torch.bfloat16)
    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=hkv, head_dim=cfg.head_dim,
              rope_theta=cfg.rope_theta)
    inputs = (x, [(lay["wqkv"], lay["wo"]) for lay in layers[:3]], kc, vc,
              lens, kw)
    nbytes, ops = qb.attn_bytes(inputs)
    _versus_plain(res, "fused_attention", f"{tag} Hq={cfg.n_heads} Hkv={hkv} "
                  f"len {length + 1} theta {cfg.rope_theta:g}, "
                  f"{len(fat.split_plan(length, S, hkv, sms, kc.dtype))} "
                  "splits (3 layers)",
                  lambda i: fat.attention_fused(
                      x, *inputs[1][i % 3], kc, vc, lens, i % 2, **kw),
                  5e-3, spec.bound_ms(nbytes, ops, "int8"))
    del kc, vc
    _rope_case(res, spec, dev, g, 512, cfg.n_heads, hkv, cfg.rope_theta, tag)


def phase_llama3(dev, seed, res: Results, card):
    """llama3-8b at full width and depth (32 layers, dim 4096, GQA 32/8,
    vocab 128256, intermediate 14336 padded to 16384 by quantize_params,
    rope_theta 5e5), q4_k layers and head, a bf16 cache: (a) the preset's
    configuration (the fused MLP at Kd 16384), (b) x_quant8 (fused_attention
    + fused_mlp a layer, the int8 head), each through generate and
    generate_scan with its counts and forced layer by layer; (c) bench.py's
    decode (x_quant8 + permute_hidden_params: one model_step a token),
    forced layer by layer (5e-3) and through tools/bench.py --decode."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import _build
    from ggml_cuda_experiments_tpu_torch.ops.probes import _info
    cfg = PRESETS["llama3-8b"]
    L = cfg.n_layers
    t_phase = time.perf_counter()
    log(f"== 13. {cfg.name}: dim {cfg.dim}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, vocab {cfg.vocab_size}, "
        f"intermediate {cfg.intermediate}, rope_theta {cfg.rope_theta:g}, "
        "q4_k layers and head, bf16 cache")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = llama.init_weights(cfg, seed=seed + 50, device=dev)
    params = llama.quantize_params(dense, "q4_k")
    del dense
    torch.cuda.empty_cache()
    metrics = _built(params, t0, card, f"{cfg.name} (init_weights + "
                     "quantize_params)")
    kd = params["layers"][0]["w_down"].array_shape[1]
    log(f"  w_gu {params['layers'][0]['w_gu'].array_shape}, w_down "
        f"{params['layers'][0]['w_down'].array_shape}: intermediate "
        f"{cfg.intermediate} padded to {kd}; layer_decode_kernel layers at "
        f"Kd {kd}: {_info(_build.lib().layer_kernel_info, 0, kd)}")
    if kd != 16384:
        raise AssertionError(f"{cfg.name}: intermediate padded to {kd}")
    _llama3_kernels(res, params, cfg, dev, seed + 52)
    prompts = _prompts(cfg, REQUESTS, seed + 51, dev)

    # (a) the preset's configuration: the fused MLP, the rest unfused
    paths, outs = _generate_and_scan(
        params, cfg, prompts, REQUESTS, cfg.name,
        {"q4k_matvec": 2 * L + 1, "fused_mlp": L, "flash_decode": L,
         "lse_merge": L}, "q4k_matvec", 4 * L)
    timing = {"generate": _time_requests(params, cfg, prompts, REQUESTS,
                                         outs, dev)}
    _check_forced(params, cfg, prompts[0], _forced_tokens(outs, dev), dev)

    # (b) x_quant8: fused_attention + fused_mlp a layer, the int8 head
    xq8 = dataclasses.replace(cfg, x_quant8=True)
    tag = f"{cfg.name} x_quant8"
    p8, outs8 = _generate_and_scan(
        params, xq8, prompts, REQUESTS, tag,
        {"q4k_q8_matvec": 1, "fused_attention": L, "fused_mlp": L},
        "q4k_q8_matvec", 4 * L)
    paths.update(p8)
    timing["generate_x_quant8"] = _time_requests(params, xq8, prompts,
                                                 REQUESTS, outs8, dev)
    _check_forced(params, xq8, prompts[0], _forced_tokens(outs8, dev), dev)
    metrics.update(_graph_rate(params, xq8, prompts[0],
                               timing["generate_x_quant8"],
                               metrics["bound_ms"], card, tag))
    metrics["profile_x_quant8"] = _step_profile(
        params, xq8, prompts[0], dev,
        {"fused_attention": "layer_decode_kernel<true, false>",
         "fused_mlp": "fused_mlp_kernel"})

    # (c) bench.py's decode: model_step, forced layer by layer, then the
    # benchmark entry's --decode on these weights
    bcfg = dataclasses.replace(xq8, hperm=True)
    pb = llama.permute_hidden_params(params, bcfg)
    if "m_pack" not in pb:
        raise AssertionError(f"{cfg.name}: permute_hidden_params built no "
                             "model pack")
    _model_step_check(pb, bcfg, prompts[2], dev, res, card)
    del pb
    b_paths, metrics["bench_decode"] = phase_bench_decode(
        dev, params, cfg.name, card)
    paths.update(b_paths)
    metrics["requests"] = timing
    _phase_end(params, metrics, t_phase, card, "phase 13")
    return paths, metrics


def _l70b_kernels(res, params, cfg, dev, seed):
    """llama2-70b's new shapes: q4k_matvec and q4k_gemm (M 16 on the
    stream route, 128 and 512 on tc) at every linear on the model's own
    weights (wqkv [10240, 8192], W_o [8192, 8192], w_gu [57344, 8192],
    w_down [8192, 28672]), q4k_matvec at the head [32000, 8192],
    flash_decode at 8 query heads a KV head (D 128), flash_attention at
    64/8 heads over 512 tokens, rope_pack at 64/8 heads; each against its
    plain version, beside its bound."""
    import torch
    layers, tag = params["layers"], cfg.name
    _linear_kernels(res, tag, [(k, [lay[k] for lay in layers])
                               for k in ("wqkv", "wo", "w_gu", "w_down")],
                    dev, ms=(16, 128, 512))
    _linear_kernels(res, tag, [("lm_head", [params["lm_head"]])], dev, ms=())
    spec = _spec()
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    hq, hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    _flash_decode_cases(res, spec, randn, ((cfg.n_layers, hq, hkv, 1024, D),),
                        tag)
    _flash_attention_cases(res, spec, randn, ((512, hq, hkv, D),), tag)
    _rope_case(res, spec, dev, g, 512, hq, hkv, cfg.rope_theta, tag)


def phase_llama2_70b(dev, seed, res: Results, card):
    """llama2-70b at full width and depth (80 layers, dim 8192, GQA 64/8,
    intermediate 28672), q4_k layers and head, a bf16 cache, the preset's
    configuration: at dim 8192 every fused gate is closed, so each decode
    linear is its own q4k_matvec and each prefill linear its own q4k_gemm.
    Built on the card one layer at a time (the dense bf16 model, ~138 GB,
    does not fit)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    cfg = PRESETS["llama2-70b"]
    L = cfg.n_layers
    steps = sum(n for _, n in MIXTRAL_REQUESTS)
    t_phase = time.perf_counter()
    log(f"== 14. {cfg.name}: dim {cfg.dim}, {L} layers, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}, intermediate {cfg.intermediate}, "
        "q4_k layers and head, bf16 cache, the preset's configuration "
        "(every fused gate closed at dim 8192)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = _layerwise_params(cfg, seed + 60, dev)
    metrics = _built(params, t0, card, f"{cfg.name} one layer at a time")
    _l70b_kernels(res, params, cfg, dev, seed + 62)
    prompts = _prompts(cfg, MIXTRAL_REQUESTS, seed + 61, dev)
    R = len(MIXTRAL_REQUESTS)
    paths, outs = _generate_and_scan(
        params, cfg, prompts, MIXTRAL_REQUESTS, cfg.name,
        {"q4k_matvec": 4 * L + 1, "flash_decode": L, "lse_merge": L},
        "q4k_matvec", 4 * L,
        by_k={cfg.dim: (3 * L + 1) * steps + R,
              cfg.intermediate: L * steps})
    timing = _time_requests(params, cfg, prompts, MIXTRAL_REQUESTS, outs, dev)
    metrics.update(_graph_rate(params, cfg, prompts[0], timing,
                               metrics["bound_ms"], card, cfg.name))
    metrics["profile"] = _step_profile(params, cfg, prompts[0], dev,
                                       {"matvec": "q4_matvec",
                                        "attention": "flash_decode"})
    _check_forced(params, cfg, prompts[0], _forced_tokens(outs, dev), dev)
    _phase_end(params, metrics, t_phase, card, "phase 14")
    return paths, metrics


# ---------------------------------------------------------------------------
# 15. llama2-7b in q4_k's s6 encoding
# ---------------------------------------------------------------------------

S6_RAGGED = (17, 64, 200, 511)       # the ragged batch: a prompt a row
S6_RAGGED_STEPS = 4


def _s6_params(dense):
    """``dense`` quantized by ``llama.quantize_params`` to q4_k with every
    linear in the s6 encoding (``profile_decode.quantize_model``: its
    quantizer called as ``quantize(w, fmt, enc="s6")``), so the tree has
    quantize_params' layout and MLP pad (7B: 11008 -> 12288)."""
    from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pdc
    return pdc.quantize_model(dense, "q4_k", "s6")


def _s6_case(res, name, case, calls, nbytes, tol, ops, kind,
             headline=False):
    """``calls`` = (s6 call(i), Q4_K-E call(i)), each cycling its weight
    copies: the s6 one against its plain version and timed (a graph of
    ``qgemm_bench.CHAIN`` calls), the e one timed the same way here;
    ``nbytes`` = (s6, e) bytes a call must move. A call's further outputs
    (k_new, v_new) within 2e-2 * max(1, max). Logs both times beside their
    bounds; returns (s6 ms, e ms)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    from ggml_cuda_experiments_tpu_torch.utils.platform import plain_versions
    spec = _spec()
    c6, ce = calls
    y = c6(0)
    with plain_versions():
        ref = c6(0)
    y, ref = ((t,) if isinstance(t, torch.Tensor) else t for t in (y, ref))
    err, sc = rel_err(y[0], ref[0])
    for gk, rk in zip(y[1:], ref[1:]):
        e2, s2 = rel_err(gk, rk)
        if e2 > 2e-2 * max(1.0, s2):
            raise AssertionError(f"{name} {case}: k/v error {e2}")
    ms6 = time_ms(c6, calls=qb.CHAIN)
    mse = time_ms(ce, calls=qb.CHAIN)
    with plain_versions():
        pms = time_ms(c6, calls=2, replays=3)
    b6, be = (spec.bound_ms(n, ops, kind) for n in nbytes)
    res.add(name, case, err, sc, tol, ms6, pms, b6, headline=headline)
    log(f"    s6 {1e3 * ms6:.2f} us ({100 * b6[0] / ms6:.1f}% of its bound "
        f"{1e3 * b6[0]:.2f} us); e {1e3 * mse:.2f} us ({100 * be[0] / mse:.1f}"
        f"% of {1e3 * be[0]:.2f} us); s6 / e {ms6 / mse:.3f}")
    return ms6, mse


def _s6_kernels(res, params, e_layers, e_head, cfg, dev, seed):
    """Every s6 kernel at the 7B shapes on the model's own weights, each
    beside the Q4_K-E kernel of its shape (``e_layers`` / ``e_head``: the
    same dense weights quantized to Q4_K-E): both matvecs at every linear
    and the head, q4k_s6_gemm at M 4, 16 and 512 on each linear,
    fused_mlp_s6, fused_attention_s6 at 1024 keys. Returns {case: (s6 us,
    e us)}."""
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import qgemm_bench as qb
    from ggml_cuda_experiments_tpu_torch.utils.bench import copies_for
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    sets = [(k, [lay[k] for lay in params["layers"]],
             [lay[k] for lay in e_layers]) for k in ("wqkv", "wo", "w_gu",
                                                     "w_down")]
    sets.append(("lm_head", [params["lm_head"]], [e_head]))
    for key, s6, e in sets:
        s6 = s6[:copies_for(s6[0].nbytes)]
        e = e[:copies_for(e[0].nbytes)]
        n, k = s6[0].array_shape
        x = torch.randn((1, k), generator=g, device=dev)
        io = 4 * (k + n)
        for f6, fe, kind in (("q4k_s6_matvec", "q4k_matvec", "f32"),
                             ("q4k_s6_q8_matvec", "q4k_q8_matvec", "int8")):
            f6_, fe_ = getattr(qm, f6), getattr(qm, fe)
            log(f"  {f6} {key} N={n} K={k} ({len(s6)} / {len(e)} copies)")
            out[f"{f6} {key}"] = _s6_case(
                res, f6, f"llama2-7b s6 {key} N={n} K={k}",
                (lambda i: f6_(x, s6[i % len(s6)]),
                 lambda i: fe_(x, e[i % len(e)])),
                (s6[0].nbytes + io, e[0].nbytes + io), 1e-4, 2 * n * k,
                kind, headline=key == ("lm_head" if "q8" in f6 else "w_gu"))
        for m in (4, 16, 512) if key != "lm_head" else ():
            xm = qb.gemm_x(m, n, k, dev)
            io = 2 * m * k + 4 * m * n
            log(f"  q4k_s6_gemm {key} M={m} N={n} K={k} ({qm.gemm_route(m)})")
            out[f"q4k_s6_gemm {key} M={m}"] = _s6_case(
                res, "q4k_s6_gemm", f"llama2-7b s6 {key} M={m} N={n} K={k} "
                f"({qm.gemm_route(m)})",
                (lambda i: qm.q4k_s6_gemm(xm, s6[i % len(s6)]),
                 lambda i: qm.q4k_gemm(xm, e[i % len(e)])),
                (s6[0].nbytes + io, e[0].nbytes + io), 2e-2, 2 * m * n * k,
                "bf16", headline=(key, m) == ("w_gu", 16))
        torch.cuda.empty_cache()
    x = torch.randn((1, cfg.dim), generator=g, device=dev)
    lays = (params["layers"][:2], e_layers[:2])
    nb = [lay[0]["w_gu"].nbytes + lay[0]["w_down"].nbytes for lay in lays]
    gu, dn = lays[0][0]["w_gu"].array_shape, lays[0][0]["w_down"].array_shape
    log(f"  fused_mlp_s6 w_gu {gu[0]}x{gu[1]}, w_down {dn[0]}x{dn[1]} "
        "(2 layers)")
    out["fused_mlp_s6"] = _s6_case(
        res, "fused_mlp_s6", f"llama2-7b s6 MLP w_gu {gu[0]}x{gu[1]}, w_down "
        f"{dn[0]}x{dn[1]} (2 layers)",
        tuple(lambda i, ls=ls: qm.mlp_fused(x, ls[i % len(ls)]["w_gu"],
                                            ls[i % len(ls)]["w_down"])
              for ls in lays),
        tuple(b + 8 * cfg.dim for b in nb), 5e-3,
        2 * (gu[0] * gu[1] + dn[0] * dn[1]), "int8", headline=True)
    hkv, S, length = cfg.n_kv_heads, 1024, 1023
    kc = torch.randn((2, 1, hkv, S, cfg.head_dim), generator=g,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((2, 1, hkv, S, cfg.head_dim), generator=g,
                     device=dev).to(torch.bfloat16)
    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=hkv, head_dim=cfg.head_dim)
    lays = (params["layers"][:3], e_layers[:3])
    nb = [qb.attn_bytes((x, [(ls[0]["wqkv"], ls[0]["wo"])], kc, vc, lens,
                         kw))[0] for ls in lays]
    log(f"  fused_attention_s6 Hq={cfg.n_heads} Hkv={hkv} len {length + 1} "
        "(3 layers)")
    out["fused_attention_s6"] = _s6_case(
        res, "fused_attention_s6", f"llama2-7b s6 Hq={cfg.n_heads} "
        f"Hkv={hkv} len {length + 1} (3 layers)",
        tuple(lambda i, ls=ls: fat.attention_fused(
            x, ls[i % len(ls)]["wqkv"], ls[i % len(ls)]["wo"], kc, vc, lens,
            i % 2, **kw) for ls in lays),
        nb, 5e-3, 2 * (lays[0][0]["wqkv"].array_shape[0] + 4096) * 4096,
        "int8", headline=True)
    return {k: [1e3 * v for v in t] for k, t in out.items()}


def _ragged_batch(params, cfg, dev, seed):
    """A ragged batch: the ``S6_RAGGED`` prompts, each prefilled alone into
    a one-row cache and decoded alone for ``S6_RAGGED_STEPS`` greedy steps
    (its batch-1 run, the MLP unfused: every linear the exact f32 matvec),
    then the rows' caches as they were after their prefills copied into one
    B-row ``KVCache`` (cache rows and ``lengths``) and decoded together,
    teacher-forced with each row's batch-1 tokens: every linear on
    q4k_s6_gemm's stream route, flash_decode over the rows' unequal lengths,
    launches asserted. Each batched step runs with every layer's input
    forced to the batch-1 run's of that row (``_forward``'s layer_hook):
    each layer's output and the logits within 2e-2 * max of the batch-1
    run's, greedy tokens equal or departing at a near-tie (the batch-1
    run's top two within 2e-2 * max). The batch decoded again with only its
    tokens forced (every layer free) is logged."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    cfg1 = dataclasses.replace(cfg, fuse_mlp=False)
    L, B, steps, S = cfg.n_layers, len(S6_RAGGED), S6_RAGGED_STEPS, 1024
    gemm = "q4k_s6_gemm"
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = [llama.KVCache.create(cfg1, B, S, device=dev) for _ in "ff"]
    rows = []
    for b, n in enumerate(S6_RAGGED):
        prompt = torch.randint(1, cfg.vocab_size, (1, n), generator=g,
                               device=dev, dtype=torch.int64)
        cache = llama.KVCache.create(cfg1, 1, S, device=dev)
        logits, cache = llama.prefill(params, cfg1, prompt, cache)
        for c in batch:
            c.k[:, b] = cache.k[:, 0]
            c.v[:, b] = cache.v[:, 0]
            c.lengths[b] = cache.lengths[0]
        row = {"tokens": [], "h": [], "logits": []}
        for _ in range(steps):
            tok = torch.argmax(logits, -1).to(torch.int32)
            rec = {}

            def hook(li, h, b0, rec=rec):
                rec[li] = h.clone()
                return h
            logits, cache = llama._forward(
                params, cfg1, tok[:, None], cache, cache.lengths[:, None]
                .clone(), decode=True, layer_hook=hook)
            row["tokens"].append(tok)
            row["h"].append(rec)
            row["logits"].append(logits[0].float())
        rows.append(row)
        del cache
    log(f"  ragged batch: rows of {list(S6_RAGGED)} tokens, each prefilled "
        f"and decoded alone for {steps} greedy steps (the batch-1 run)")
    torch.cuda.synchronize()
    _reset_counts()
    routes0 = dict(qm.GEMM_ROUTE_LAUNCHES)
    worst_layer, worst_logits, departures = 0.0, 0.0, []
    cache = batch[0]
    for s in range(steps):
        toks = torch.cat([r["tokens"][s] for r in rows])
        errs = []

        def force(li, h, b0, s=s, errs=errs):
            want = torch.cat([r["h"][s][li] for r in rows])
            if li > 0:
                errs.append(float(((h - want).float().abs().amax((1, 2))
                                   / want.float().abs().amax((1, 2))).max()))
            return want
        logits, cache = llama._forward(
            params, cfg1, toks[:, None], cache, cache.lengths[:, None].clone(),
            decode=True, layer_hook=force)
        worst_layer = max(worst_layer, max(errs))
        log(f"    step {s}: each layer's worst row "
            + " ".join(f"{e:.2e}" for e in errs))
        for b, r in enumerate(rows):
            want = r["logits"][s]
            got = logits[b].float()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("ragged batch: non-finite logits")
            err = float((got - want).abs().max() / want.abs().max())
            worst_logits = max(worst_logits, err)
            if int(got.argmax()) != int(want.argmax()):
                top2 = torch.topk(want, 2).values
                departures.append((b, s, float(top2[0] - top2[1]),
                                   float(want.abs().max())))
    counts = _counts()
    routes = {r: n - routes0.get(r, 0)
              for r, n in qm.GEMM_ROUTE_LAUNCHES.items()}
    want = {k: 0 for k in counts}
    want.update({gemm: steps * (4 * L + 1), "flash_decode": steps * L,
                 "lse_merge": steps * L})
    _assert_counts(f"ragged batch of {B} ({steps} steps)", counts, want)
    if routes != {"stream": steps * (4 * L + 1), "tc": 0}:
        raise AssertionError(f"ragged batch: {gemm} by route {routes}")
    log(f"  ragged batch of {B} at lengths {cache.lengths.tolist()} after "
        f"{steps} steps, every layer's input forced to its row's batch-1 "
        f"run: worst layer {worst_layer:.3e} of max, worst logits "
        f"{worst_logits:.3e} of max (bound 2e-2); greedy departures (row, "
        f"step, top-2 gap, max) {departures}; {gemm} by route {routes}")
    far = [d for d in departures if d[2] > 2e-2 * d[3]]
    if worst_layer > 2e-2 or worst_logits > 2e-2 or far:
        raise AssertionError(f"ragged batch: layer {worst_layer}, logits "
                             f"{worst_logits}, departures {far}")
    free, cache, gaps = 0.0, batch[1], []
    for s in range(steps):
        toks = torch.cat([r["tokens"][s] for r in rows])
        logits, cache = llama.decode_step(params, cfg1, toks, cache)
        for b, r in enumerate(rows):
            want = r["logits"][s]
            free = max(free, float((logits[b].float() - want).abs().max()
                                   / want.abs().max()))
            if int(logits[b].argmax()) != int(want.argmax()):
                top2 = torch.topk(want, 2).values
                gaps.append((b, s, float((top2[0] - top2[1])
                                         / want.abs().max())))
    log(f"  the same batch with only its tokens forced ({L} layers free): "
        f"logits within {free:.3e} of max of the batch-1 runs' (printed), "
        f"greedy tokens equal at {B * steps - len(gaps)} of {B * steps}; "
        f"departures (row, step, top-2 gap of max) {gaps}")
    return {"forced_layer": worst_layer, "forced_logits": worst_logits,
            "departures": departures, "free_logits": free,
            "free_departures": gaps, "counts": counts}


def phase_s6(dev, seed, res: Results, card):
    """llama2-7b at full width and depth with every q4_k linear (the head
    too) in the s6 encoding (``_s6_params``): its kernels against their
    plain versions beside the Q4_K-E kernels' times (``_s6_kernels``); the
    preset's configuration (fused_mlp_s6, the rest q4k_s6_matvec a row) and
    x_quant8 (fused_attention_s6 + fused_mlp_s6, q4k_s6_q8_matvec at the
    head) through generate and generate_scan with their counts (no Q4_K-E
    kernel launches and no kernel-path ``scales_to_e``), each forced layer
    by layer; the graph step's ms a token beside the s6 stream bound; a
    ragged batch (``_ragged_batch``). The layer kernel is shut for s6, as
    in the reference."""
    import dataclasses
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import spec_bench as sb
    from ggml_cuda_experiments_tpu_torch.tools.bench import stream_bytes
    from ggml_cuda_experiments_tpu_torch.utils.platform import kernels_for
    cfg = PRESETS["llama2-7b"]
    L = cfg.n_layers
    t_phase = time.perf_counter()
    log(f"== 15. {cfg.name} in q4_k's s6 encoding: dim {cfg.dim}, {L} "
        "layers, every linear and the head s6, bf16 cache")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dense = llama.init_weights(cfg, seed=seed + 70, device=dev)
    params = _s6_params(dense)
    e_params = llama.quantize_params(dense, "q4_k")  # the same weights, e
    del dense
    torch.cuda.empty_cache()
    metrics = _built(params, t0, card, f"{cfg.name} s6 (init_weights + "
                     "quantize_params with an s6 quantizer)")
    encs = {w.enc for lay in params["layers"] for w in lay.values()
            if isinstance(w, qm.QuantLinear)} | {params["lm_head"].enc}
    e_stream = stream_bytes(e_params)
    log(f"  encodings {sorted(encs)}; w_down "
        f"{params['layers'][0]['w_down'].array_shape}; the Q4_K-E model of "
        f"these shapes streams {e_stream:.0f} bytes a token "
        f"({metrics['stream_bytes'] / e_stream:.4f} of it)")
    if encs != {"s6"}:
        raise AssertionError(f"s6 model: encodings {encs}")
    from ggml_cuda_experiments_tpu_torch.ops import _build
    from ggml_cuda_experiments_tpu_torch.ops.probes import _info
    for k in (4096, 12288):             # the exact matvec's ring by K
        log(f"  q4_matvec_kernel K={k}: e "
            f"{_info(_build.lib().q4_matvec_info, 0, k)}; s6 "
            f"{_info(_build.lib().q4_matvec_info, 2, k)}")
    metrics["kernels_us"] = _s6_kernels(res, params, e_params["layers"],
                                        e_params["lm_head"], cfg, dev,
                                        seed + 71)
    prompts = _prompts(cfg, MIXTRAL_REQUESTS, seed + 72, dev)
    steps, R = sum(n for _, n in MIXTRAL_REQUESTS), len(MIXTRAL_REQUESTS)

    expanded = []
    expand = qm.scales_to_e

    def counted(ql):                     # kernel-path expansions of s6
        if ql.s6 and kernels_for(ql.qs):
            expanded.append(ql.shape)
        return expand(ql)

    with contextlib.ExitStack() as stack:
        stack.callback(setattr, qm, "scales_to_e", expand)
        qm.scales_to_e = counted
        # (a) the preset's configuration: fused_mlp_s6, the rest a matvec
        paths, outs = _generate_and_scan(
            params, cfg, prompts, MIXTRAL_REQUESTS, f"{cfg.name} s6",
            {"q4k_s6_matvec": 2 * L + 1, "fused_mlp_s6": L,
             "flash_decode": L, "lse_merge": L}, "q4k_s6_matvec", 4 * L,
            by_k={cfg.dim: (2 * L + 1) * steps + R}, gemm="q4k_s6_gemm",
            matvec="q4k_s6_matvec")
        timing = {"generate": _time_requests(params, cfg, prompts,
                                             MIXTRAL_REQUESTS, outs, dev)}
        # (b) x_quant8: fused_attention_s6 + fused_mlp_s6, the int8 head
        xq8 = dataclasses.replace(cfg, x_quant8=True)
        tag = f"{cfg.name} s6 x_quant8"
        p8, outs8 = _generate_and_scan(
            params, xq8, prompts, MIXTRAL_REQUESTS, tag,
            {"q4k_s6_q8_matvec": 1, "fused_attention_s6": L,
             "fused_mlp_s6": L}, "q4k_s6_q8_matvec", 4 * L,
            by_k={cfg.dim: steps + R}, gemm="q4k_s6_gemm",
            matvec="q4k_s6_q8_matvec")
        paths.update(p8)
        timing["generate_x_quant8"] = _time_requests(
            params, xq8, prompts, MIXTRAL_REQUESTS, outs8, dev)
        metrics["ragged"] = _ragged_batch(params, cfg, dev, seed + 73)
        paths["ragged_batch_s6"] = metrics["ragged"].pop("counts")
    log(f"  kernel-path scales_to_e calls on s6 weights: {len(expanded)} "
        "(must be 0)")
    if expanded:
        raise AssertionError(f"s6 expanded on the kernel path: {expanded}")
    _check_forced(params, cfg, prompts[0], _forced_tokens(outs, dev), dev)
    _check_forced(params, xq8, prompts[0], _forced_tokens(outs8, dev), dev,
                  tol=3e-2)
    metrics["preset"] = _graph_rate(params, cfg, prompts[0],
                                    timing["generate"], metrics["bound_ms"],
                                    card, f"{cfg.name} s6")
    metrics["x_quant8"] = _graph_rate(params, xq8, prompts[0],
                                      timing["generate_x_quant8"],
                                      metrics["bound_ms"], card, tag)
    # the Q4_K-E model of the same weights, its graph step here
    e_ms = {tag_: 1e3 * sb.plain_per_token(e_params, c, prompts[0])
            for tag_, c in (("preset", cfg), ("x_quant8", xq8))}
    log(f"  [{card}] the same weights in Q4_K-E: graph "
        + ", ".join(f"{t} {ms:.3f} ms a token (s6 / e "
                    f"{metrics[t]['graph_ms_per_token'] / ms:.3f})"
                    for t, ms in e_ms.items())
        + f"; the e stream bound {1e3 * e_stream / _spec().hbm_bytes_per_s:.3f}"
        " ms")
    metrics.update(e_stream_bytes=e_stream, e_graph_ms_per_token=e_ms)
    e_params.clear()
    _phase_end(params, metrics, t_phase, card, "phase 15")
    return paths, metrics


PROBE_MODEL = "tinyllama-1.1b"


def _probe_rows(what, out, n_rows, free=()):
    """A probe mode's JSON rows: ``n_rows`` of them, each us finite (and
    positive, but for the rows named in ``free``: a difference of two
    timings), each bound positive and named; logged."""
    import math
    rows = out["rows"]
    json.dumps(out)                      # its JSON line can be printed
    bad = [r for r in rows if not (
        math.isfinite(r["us"]) and (r["us"] > 0 or r["component"] in free)
        and r["bound_us"] >= 0 and r["bound_by"] in ("bytes", "operations"))]
    if len(rows) != n_rows or bad:
        raise AssertionError(f"profile_decode {what}: {len(rows)} rows "
                             f"(want {n_rows}); bad {bad}")
    log(f"  {what}: {n_rows} rows ok: " + "; ".join(
        f"{r['component']} {r['us']:.1f} us" for r in rows))


def phase_probe_modes(dev, seed, card):
    """16. tools/profile_decode.py's probe modes, the counterparts of the
    JAX package's probe tools, each once through ``run`` at reduced reps
    (1 pair, 5 host calls), on tinyllama-1.1b where the mode takes a model,
    every JSON row asserted (``_probe_rows``); q4k_gemm's tc phases at the
    two --pipe shapes at M 512: phase "all" bit-equal to the production
    call, "stream" all zeros, "dequant" and "dot" launched; the GCTC weight
    cache (``cached_params``): tinyllama built and saved, loaded, the same
    tree and the same logits. The modes' and the phases' launches are
    counted as one path, "profile_decode"."""
    import shutil
    import tempfile
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.tools import profile_decode as pdc
    t_phase = time.perf_counter()
    log(f"== 16. profile_decode's probe modes ({PROBE_MODEL}), q4k_gemm's "
        "phases, the GCTC weight cache")
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="gct_probe_")
    metrics = {}
    try:
        cfg = pdc.config(PROBE_MODEL)
        path = os.path.join(tmp, "e.gctc")
        t0 = time.perf_counter()
        built = pdc.cached_params(cfg, "q4_k", seed, dev, ckpt=path)
        t1 = time.perf_counter()
        params = pdc.cached_params(cfg, "q4_k", seed, dev, ckpt=path)
        t2 = time.perf_counter()
        n = _assert_same_tree("the GCTC cache (load against build)", params,
                              built)
        prompt = torch.ones((1, 16), dtype=torch.int64, device=dev)

        def logits(p):
            cache = llama.KVCache.create(cfg, 1, 256, device=dev)
            lg, cache = llama.prefill(p, cfg, prompt, cache)
            return llama.decode_step(p, cfg, torch.argmax(lg, -1), cache)[0]

        if not torch.equal(logits(params), logits(built)):
            raise AssertionError("the GCTC cache: the loaded weights' "
                                 "logits differ from the built ones'")
        del built
        torch.cuda.empty_cache()
        metrics["cache"] = {"build_save_s": t1 - t0, "load_s": t2 - t1,
                            "file_bytes": os.path.getsize(path)}
        log(f"  [{card}] the GCTC cache of {PROBE_MODEL} q4_k: built and "
            f"saved in {t1 - t0:.1f} s, loaded in {t2 - t1:.1f} s "
            f"({os.path.getsize(path)} bytes); {n} bytes of weights "
            "bit-equal, decode logits identical")
        common = ["--model", PROBE_MODEL, "--seed", str(seed)]
        modes = (  # argv, rows, the rows that may read <= 0
            (["--ladder"], 5, ()),
            (["--layer-marginal", "--ablate"], 7,
             ("non-layer (t(L) - L x the full layer)",)),
            (["--nonlayer", "--head-fmt", "q6_k"], 7, ()),
            (["--blocks"], 4, ()),
            (["--embed", "512"], 4, ()),
            (["--pipe", "--pairs", "1"], 12, ()),
            (["--enc", "s6", "--pairs", "1", "--ckpt",
              os.path.join(tmp, "s6.gctc")], 15, ()),
            (["--host", "--n", "5"], 8, ()))
        torch.cuda.synchronize()
        _reset_counts()
        for argv, n_rows, free in modes:
            args = pdc.parse(common + argv)
            t0 = time.perf_counter()
            out = pdc.run(args, dev, params)
            _probe_rows(args.mode, out, n_rows, free)
            metrics[args.mode] = {"rows": out["rows"],
                                  "s": time.perf_counter() - t0}
            torch.cuda.empty_cache()
        g = torch.Generator(device=dev).manual_seed(seed + 160)
        for k, _, nb in pdc.PIPE_SHAPES:
            ql = qm.quantize(torch.randn((nb, k), generator=g, device=dev)
                             / k ** 0.5, "q4_k")
            x = torch.randn((512, k), generator=g,
                            device=dev).to(torch.bfloat16)
            y = qm.q4k_gemm(x, ql)
            if not torch.equal(qm.q4k_gemm(x, ql, phase="all"), y):
                raise AssertionError(f"q4k_gemm phase all != production "
                                     f"at [{nb} x {k}], M 512")
            if qm.q4k_gemm(x, ql, phase="stream").any():
                raise AssertionError("q4k_gemm phase stream wrote non-zero")
            for phase in ("dequant", "dot"):
                qm.q4k_gemm(x, ql, phase=phase)
            torch.cuda.synchronize()
            log(f"  q4k_gemm [{nb} x {k}] M 512: phase all bit-equal to the "
                "production call, stream zeros, dequant and dot launched")
            del ql, x, y
        counts = _counts()
        log(f"  launches in profile_decode: "
            f"{ {k: v for k, v in counts.items() if v} }")
        if not (counts["q4k_gemm_phase"] and counts["q4k_gemm"]
                and counts["fused_mlp"] and counts["fused_attention"]
                and counts["flash_decode"]):
            raise AssertionError(f"profile_decode: {counts}")
        params.clear()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  [{card}] phase 16 in {metrics['phase_s']:.1f} s")
    return {"profile_decode": counts}, metrics


PHASE_SECONDS: dict = {}


def timed(tag, phase, *args):
    """``phase(*args)``, its wall seconds logged on a line of its own and
    kept under ``tag`` in ``PHASE_SECONDS`` (printed in the JSON line)."""
    t0 = time.perf_counter()
    out = phase(*args)
    PHASE_SECONDS[tag] = round(time.perf_counter() - t0, 1)
    log(f"phase {tag}: {PHASE_SECONDS[tag]} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-4i only (no model, no contract "
                    "line)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", metavar="TRACE_DIR", default=None,
                    help="also profile 4 decode steps (torch.profiler) and "
                    "write the Chrome trace into TRACE_DIR")
    args = ap.parse_args()
    t_start = time.perf_counter()
    card = phase_env()
    import torch
    dev = torch.device("cuda", 0)
    timed("2", phase_build)
    timed("3", phase_quantizer, dev, args.seed)
    res = Results()
    for tag, phase in (("4", phase_kernels), ("4b", phase_engine_kernels),
                       ("4c", phase_fused_kernels),
                       ("4d", phase_q4km_kernels),
                       ("4e", phase_format_kernels),
                       ("4f", phase_lab_kernels)):
        timed(tag, phase, dev, args.seed, res)
    vpu_paths = timed("4g", phase_vpu_kernels, dev, args.seed, res)
    probe_times = timed("4h", phase_probe_kernels, dev, args.seed, res)
    timed("4i", phase_lse_kernel, dev, args.seed, res)
    if args.kernels_only:
        log(json.dumps({"kernels": res.kernels}))
        return 0
    counts, timing, params, prompts, head_dense = timed(
        "5", phase_model, dev, args.seed, args.profile)
    fused_paths, fused_timing = timed(
        "5b", phase_fused_decode, dev, args.seed, params, prompts, res, card,
        args.profile)
    q4km_paths, q4km_timing = timed("5c", phase_q4km, dev, args.seed,
                                    params, head_dense, prompts)
    del head_dense
    from ggml_cuda_experiments_tpu_torch.models.config import PRESETS
    paths, engine_metrics = timed("6", phase_engine, dev, args.seed, params,
                                  PRESETS["llama2-7b"], card)
    serving_paths, serving_metrics = timed(
        "6c", phase_serving, dev, args.seed, params, PRESETS["llama2-7b"],
        card)
    spec_paths, spec_metrics = timed("8", phase_speculative, dev, args.seed,
                                     params, card)
    b7_paths, b7_metrics = timed("9 decode llama2-7b", phase_bench_decode,
                                 dev, params, "llama2-7b", card)
    par_paths, par_metrics = timed("10", phase_parallel, dev, args.seed,
                                   params, prompts, card)
    del params
    torch.cuda.empty_cache()
    fmt_paths, fmt_timing = timed("5e 5f 6b", phase_formats, dev, args.seed,
                                  prompts, card)
    tiny_paths, tiny_timing = timed("5d 5g 9 decode tinyllama",
                                    phase_tinyllama, dev, args.seed, card)
    btiny_metrics = tiny_timing.pop("bench_decode_tinyllama")
    torch.cuda.empty_cache()
    lab_paths = timed("7", phase_lab, dev, args.seed)
    bench_paths, bench_metrics = timed("9", phase_bench, dev, args.seed, card)
    torch.cuda.empty_cache()
    ckpt_paths, ckpt_metrics = timed("11", phase_checkpoint, dev, args.seed,
                                     card)
    torch.cuda.empty_cache()
    moe_paths, moe_metrics = timed("12", phase_mixtral, dev, args.seed, res,
                                   card)
    l3_paths, l3_metrics = timed("13", phase_llama3, dev, args.seed, res,
                                 card)
    bl3_metrics = l3_metrics.pop("bench_decode")
    l70_paths, l70_metrics = timed("14", phase_llama2_70b, dev, args.seed,
                                   res, card)
    s6_paths, s6_metrics = timed("15", phase_s6, dev, args.seed, res, card)
    probe_paths, probe_metrics = timed("16", phase_probe_modes, dev,
                                       args.seed, card)
    paths = {"generate": counts, **fused_paths, **q4km_paths, **paths,
             **serving_paths,
             **spec_paths, **fmt_paths, **tiny_paths, **lab_paths,
             **vpu_paths, **b7_paths, **bench_paths, **par_paths,
             **ckpt_paths, **moe_paths, **l3_paths, **l70_paths,
             **s6_paths, **probe_paths}
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "ggml_cuda_experiments_tpu"
           or m.startswith("ggml_cuda_experiments_tpu.")]
    if bad:
        raise AssertionError(f"imported jax or the JAX package: {bad}")
    kernels = []
    for name, (source, replaces, also) in KERNELS.items():
        k = res.kernels[name]
        keys = COUNT_KEYS.get(name, (name,))
        by_path = {p: sum(c[key] for key in keys) for p, c in paths.items()
                   if any(c[key] for key in keys)}
        if not by_path:
            raise AssertionError(f"{name} was launched on no path")
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shape": k["shape"]})
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    log(f"dequantizing GEMM launches by route over the run (gemm_route): "
        f"{dict(qm.GEMM_ROUTE_LAUNCHES)}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels, "requests": timing,
                      "requests_bench_decode": fused_timing,
                      "requests_by_path": {**q4km_timing, **fmt_timing,
                                           **tiny_timing},
                      "engine": engine_metrics,
                      "serving": serving_metrics,
                      "speculative": spec_metrics,
                      "parallel": par_metrics,
                      "checkpoint": ckpt_metrics,
                      "mixtral": moe_metrics,
                      "llama3-8b": l3_metrics,
                      "llama2-70b": l70_metrics,
                      "llama2-7b s6": s6_metrics,
                      "probe_modes": probe_metrics,
                      "phase_seconds": PHASE_SECONDS,
                      "bench": {**bench_metrics, "probe_rungs": probe_times,
                                "decode": {
                                    "llama2-7b": b7_metrics,
                                    "tinyllama-1.1b": btiny_metrics,
                                    "llama3-8b": bl3_metrics}}
                      }))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
