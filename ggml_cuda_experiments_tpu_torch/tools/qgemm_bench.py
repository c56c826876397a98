"""The quantized decode and prefill kernels on the card: the dequantizing
GEMM (``q4k_gemm``, ``q40_gemm``, ``q80_gemm``), the batch-1 exact-f32
matvecs (``q4k_matvec``, ``q40_matvec``), the paged decode attention
(``paged_decode``), the fused decode attention block (``attention_fused``)
and the prefill RoPE repack (``rope_pack_prefill``), through the public
wrappers, so that one command times any checkout of the port:

    python -m ggml_cuda_experiments_tpu_torch.tools.qgemm_bench [--tag new]
    python -m ggml_cuda_experiments_tpu_torch.tools.qgemm_bench \\
        --root DIR --tag parent --kernels matvec,paged
    python -m ggml_cuda_experiments_tpu_torch.tools.qgemm_bench \\
        --kernels fused_attn,rope_pack

``chip_smoke.py`` times its GEMM, matvec, paged, fused-attention and
rope_pack cases with the helpers here (``cases`` / ``gemm_x`` /
``gemm_times``, ``matvec_weights`` / ``matvec_case``, ``paged_inputs`` /
``paged_bytes`` / ``paged_case``, ``attn_inputs`` / ``attn_bytes`` /
``attn_case``, ``rope_inputs`` / ``rope_bytes`` / ``rope_case``), so the
smoke and this tool read one timing path.

Cases (``--kernels``, all five by default):
- gemm: each format at w_gu [24576, 4096] with M = 2, 5, 8, 16, 128, 512,
  and q4k_gemm there at M = 32 and 33 (the routes' crossover); q4k_gemm at
  wqkv [12288, 4096], W_o [4096, 4096] and w_down [4096, 12288] with M = 8
  and 512; at M = 8 and 512 also ``torch.matmul`` of bf16 x against the
  weight already dequantized to bf16 (a yardstick of the product alone,
  not the same function);
- matvec: the three batch-1 matvecs (``q4k_matvec``, ``q40_matvec``,
  ``q80_matvec``) at every linear of llama2-7b (wqkv, W_o, w_gu, w_down
  padded and unpadded, the head) and of tinyllama-1.1b (K = 2048, and
  w_down at K = 5632), with the split their plan picks
  (``matvec_splits``; ``q80_plan`` for q8_0); and at the start cases,
  four rows (N = 4) at K = 4096 and 5632: the launch, x's arrival and one
  short stream (the chain's 20 weight copies stay in the L2);
- paged: ``paged_decode`` at chip_smoke.py phase 4b's headline (B = 8, MHA
  32/32, D 128, page 64, 16 pages a sequence, ragged lengths up to 1024
  over a 2-layer pool) on bf16, int8 and fp8 pages, and at the Engine's
  own shape (the same pool geometry, int8, lengths up to 128);
- fused_attn: ``attention_fused`` at llama2-7b's block (wqkv, W_o in q4_k,
  three copies) over a bf16 cache of S = 1024 (two layers in turn), MHA
  32/32 and GQA 32/8, at length 1024 (the new token at the last slot) and
  a short cache of 57 keys;
- rope_pack: ``rope_pack_prefill`` at T = 512, 32/32, D 128 (y copies
  rotated past the L2), with the tables given (as a prefill hands them to
  each layer: the kernel alone) and made by the call (a checkout whose
  wrapper takes no tables: made).

A case's time: 20 calls captured in one CUDA graph, the median of 5
replays (``utils/bench.py::time_ms``), weights rotated past the 50 MB L2
(``rotating``). The bound: the bytes each call must move (W + x + y; the
valid keys' pages and scales, q, the page table and the output) over the
card's HBM rate, against the operations over their type's peak. The card's
name and power limit first, one line a case, one JSON line of every case
last. With ``--root`` the tool runs itself again in a child process whose
``PYTHONPATH`` is DIR: this file's cases, that checkout's package (its
wrappers and its ``utils/bench.py``, which must have ``time_ms``). Needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

NAMES = {"q4_k": "q4k_gemm", "q4_0": "q40_gemm", "q8_0": "q80_gemm"}
W_GU = (24576, 4096)
LAYERS = (("wqkv", (12288, 4096)), ("W_o", (4096, 4096)),
          ("w_down", (4096, 12288)))
MATVECS = {"q4_k": "q4k_matvec", "q4_0": "q40_matvec", "q8_0": "q80_matvec"}
# bytes a weight of each format, its blocks' scales included
BYTES_PER_WEIGHT = {"q4_k": 0.625, "q4_0": 0.5625, "q8_0": 1.0625}
# each format's split plan in ops/quant_matmul.py: f(N, K, SMs) -> splits
# (q8_0's returns the whole plan, its splits first)
PLANS = {"q4_k": "matvec_splits", "q4_0": "matvec_splits",
         "q8_0": "q80_plan"}
LINEARS = (("wqkv", (12288, 4096)), ("W_o", (4096, 4096)),
           ("w_gu", (24576, 4096)), ("w_down", (4096, 12288)),
           ("w_down 11008", (4096, 11008)), ("head", (32000, 4096)),
           ("tiny wqkv", (2560, 2048)), ("tiny W_o", (2048, 2048)),
           ("tiny w_gu", (11264, 2048)), ("tiny w_down", (2048, 5632)))
# four rows (a warp's group in the q4 matvecs, two in q80_matvec's): what
# a call costs before its stream (the fixed start)
STARTS = (("start", (4, 4096)), ("start 5632", (4, 5632)))
CHAIN = 20          # calls of a timed chain, so copies of a weight used
# chip_smoke.py phase 4b: 7B query heads, page 64, 16 pages a sequence
PAGED_GEOMETRY = dict(H=32, D=128, ps=64, pps=16, L=2)
PAGED_LENGTHS = (1, 63, 64, 65, 300, 512, 777, 1024)
ENGINE_LENGTHS = (17, 40, 64, 65, 90, 100, 127, 128)
KERNELS = ("gemm", "matvec", "paged", "fused_attn", "rope_pack")
# (KV heads, lengths[0]) of the fused_attn cases: 1024 keys and 57
ATTN_CASES = ((32, 1023), (8, 1023), (32, 56), (8, 56))
ATTN_S = 1024


def cases(fmt: str | None = None) -> list:
    """(fmt, layer, (N, K), M) of every GEMM case (of one format if given),
    the cases of one weight next to each other."""
    out = [(f, "w_gu", W_GU, m) for f in NAMES
           for m in ((2, 5, 8, 16, 32, 33, 128, 512) if f == "q4_k"
                     else (2, 5, 8, 16, 128, 512))]
    out += [("q4_k", name, nk, m) for name, nk in LAYERS for m in (8, 512)]
    return [c for c in out if fmt in (None, c[0])]


def gemm_x(m: int, n: int, k: int, dev):
    """The case's activations: bf16 [m, k] from a seed of m and n."""
    import torch
    g = torch.Generator(device=dev).manual_seed(m * 7 + n)
    return torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)


def gemm_times(qm, fn, x, ws) -> dict:
    """``ms``: one call of ``fn(x, w)`` cycling the weight copies ``ws``;
    at M = 8 and 512 also ``matmul_ms``: torch.matmul of x against the
    copies dequantized to bf16."""
    import torch
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    out = {"ms": time_ms(lambda i: fn(x, ws[i % len(ws)]))}
    if x.shape[0] in (8, 512):
        wd = [qm.dequantize(w).to(torch.bfloat16) for w in ws]
        out["matmul_ms"] = time_ms(lambda i: torch.matmul(
            x, wd[i % len(wd)].T))
    return out


def matvec_weights(qm, fmt: str, n: int, k: int, g):
    """Copies of one random [n, k] weight in ``fmt``, enough that a chain of
    calls streams past the L2."""
    import torch
    from ggml_cuda_experiments_tpu_torch.utils.bench import (
        L2_ROTATION_BYTES, rotating)

    def make(i):
        return qm.quantize(torch.randn((n, k), generator=g, device=g.device)
                           * k ** -0.5, fmt)
    nbytes = int(n * k * BYTES_PER_WEIGHT[fmt])
    # a chain reads CHAIN copies at most: more would not be read
    return rotating(make, nbytes, min(L2_ROTATION_BYTES, CHAIN * nbytes))


def matvec_case(qm, fmt: str, ws, x) -> dict:
    """``ms``: one matvec of x against the copies ``ws`` in turn; ``bytes``
    and ``flops`` it must move and do."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    fn = getattr(qm, MATVECS[fmt])
    n, k = ws[0].array_shape
    return {"ms": time_ms(lambda i: fn(x, ws[i % len(ws)]), calls=CHAIN),
            "bytes": ws[0].nbytes + 4 * (k + n), "flops": 2 * n * k}


def matvec_split(qm, fmt: str, n: int, k: int, sms: int):
    """The split the format's plan picks at (N, K), or None where this
    checkout has no such plan."""
    plan = getattr(qm, PLANS[fmt], None)
    if plan is None:
        return None
    s = plan(n, k, sms)
    return s[0] if isinstance(s, tuple) else s


def paged_inputs(dev, fmt: str, lengths, hkv: int | None = None,
                 seed: int = 0):
    """(q, k_pages, v_pages, lengths, page_indices, scale kwargs): a
    sequence a length, PAGED_GEOMETRY's query heads over ``hkv`` KV heads
    (default as many), random pages (int8 / fp8 quantized per token), a
    random page table over B * pps + 1 pages (the last one spare)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.models import llama
    H, D, ps, pps, L = (PAGED_GEOMETRY[k] for k in ("H", "D", "ps", "pps",
                                                    "L"))
    B, hkv = len(lengths), hkv or H
    n_pages = B * pps + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pidx = torch.randperm(n_pages, generator=g, device=dev)[:B * pps]
    pidx = pidx.reshape(B, pps).to(torch.int32)
    q = torch.randn((B, H, D), generator=g, device=dev).to(torch.bfloat16)
    kf = torch.randn((L, n_pages, hkv, ps, D), generator=g, device=dev)
    vf = torch.randn((L, n_pages, hkv, ps, D), generator=g, device=dev)
    if fmt == "bf16":
        kp, vp, kw = kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}
    else:
        kp, ks = llama._quantize_rowwise(kf, fmt)
        vp, vs = llama._quantize_rowwise(vf, fmt)
        kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, lens, pidx, kw


def paged_bytes(lengths, fmt: str, hkv: int | None = None
                ) -> tuple[int, int]:
    """(bytes, operations) a call must move and do: the valid keys' K and V
    rows (and per-token scales) of ``hkv`` KV heads, q, the page table and
    the output; two multiply-adds a K / V element per query head."""
    H, D, pps = (PAGED_GEOMETRY[k] for k in ("H", "D", "pps"))
    B, hkv, keys = len(lengths), hkv or H, sum(lengths)
    es = 2 if fmt == "bf16" else 1
    nbytes = keys * hkv * (2 * D * es + (0 if fmt == "bf16" else 8))
    return nbytes + 2 * 2 * B * H * D + 4 * B * pps, 4 * H * keys * D


def paged_case(pa, inputs) -> float:
    """ms of one ``paged_decode`` over ``inputs`` (paged_inputs), layers in
    turn."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    q, kp, vp, lens, pidx, kw = inputs
    L = kp.shape[0]
    return time_ms(lambda i: pa.paged_decode(q, kp, vp, lens, pidx,
                                             layer=i % L, **kw))


def attn_inputs(qm, dev, hkv: int, length: int, g, cache_dtype=None,
                copies: int = 3, S: int = ATTN_S):
    """(x, [(wqkv, wo)] copies, k_cache, v_cache, lengths, kwargs): one
    llama2-7b attention block (32 query heads of 128 over ``hkv``; q4_k
    weights of the ``copies``, rotated past the L2) over a 2-layer cache
    [2, 1, hkv, S, 128] of ``cache_dtype`` (bf16), lengths [length]."""
    import torch
    cache_dtype = cache_dtype or torch.bfloat16

    def weight(n, k):
        return qm.quantize(torch.randn((n, k), generator=g, device=dev)
                           * k ** -0.5)
    ws = [(weight((32 + 2 * hkv) * 128, 4096), weight(4096, 4096))
          for _ in range(copies)]
    kc = torch.randn((2, 1, hkv, S, 128), generator=g,
                     device=dev).to(cache_dtype)
    vc = torch.randn((2, 1, hkv, S, 128), generator=g,
                     device=dev).to(cache_dtype)
    x = torch.randn((1, 4096), generator=g, device=dev)
    lens = torch.full((1,), length, dtype=torch.int32, device=dev)
    return x, ws, kc, vc, lens, dict(n_heads=32, n_kv_heads=hkv,
                                     head_dim=128)


def attn_bytes(inputs) -> tuple[int, int]:
    """(bytes, operations) of one call: both weights, the valid keys' K and
    V rows of one layer (the new token's included, at most S), x in and o
    out (f32), k_new / v_new out; two int8 operations a weight."""
    x, ws, kc, vc, lens, kw = inputs
    hkv, S, D = kc.shape[2], kc.shape[3], kc.shape[4]
    keys = min(int(lens[0]) + 1, S)
    es = kc.element_size()
    nbytes = (ws[0][0].nbytes + ws[0][1].nbytes + 2 * hkv * keys * D * es
              + 8 * 4096 + 2 * hkv * D * es)
    return nbytes, 2 * (ws[0][0].array_shape[0] + 4096) * 4096


def attn_case(fat, inputs, calls: int = 20) -> float:
    """ms of one ``attention_fused`` over ``inputs`` (attn_inputs), weight
    copies and cache layers in turn."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    x, ws, kc, vc, lens, kw = inputs
    return time_ms(lambda i: fat.attention_fused(
        x, *ws[i % len(ws)], kc, vc, lens, i % kc.shape[0], **kw),
        calls=calls)


def rope_inputs(dev, T: int = 512, H: int = 32, hkv: int = 32, g=None,
                rotate: bool = True):
    """([y [T, (H + 2 hkv) 128] bf16 copies, enough that a chain cycling
    through them and writing q, k, v streams past the L2; one unless
    ``rotate``], positions [T] int32, kwargs)."""
    import torch
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    width = (H + 2 * hkv) * 128
    ys = rotating(lambda i: torch.randn((T, width), generator=g, device=dev
                                        ).to(torch.bfloat16),
                  4 * T * width if rotate else 1 << 62)
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    return ys, pos, dict(n_heads=H, n_kv_heads=hkv, head_dim=128)


def rope_bytes(inputs, given: bool) -> tuple[int, int]:
    """(bytes, operations) of one call: y read and q, k, v written (bf16),
    the positions, and the two f32 tables where they are given; six f32
    operations a roped element."""
    ys, pos, kw = inputs
    T, width = ys[0].shape
    D, nr = kw["head_dim"], kw["n_heads"] + kw["n_kv_heads"]
    nbytes = 2 * 2 * T * width + 4 * T + (8 * T * D if given else 0)
    return nbytes, 6 * T * nr * D


def rope_case(pf, inputs, given: bool, calls: int = 20) -> float:
    """ms of one ``rope_pack_prefill`` over ``inputs`` (rope_inputs), the
    tables made once beforehand and given (``given``) or made by the
    call."""
    from ggml_cuda_experiments_tpu_torch.utils.bench import time_ms
    ys, pos, kw = inputs
    if given:
        tables = pf.rope_tables(pos, kw["head_dim"], 10000.0)
        return time_ms(lambda i: pf.rope_pack_prefill(
            ys[i % len(ys)], pos, **kw, tables=tables), calls=calls)
    return time_ms(lambda i: pf.rope_pack_prefill(ys[i % len(ys)], pos,
                                                  **kw), calls=calls)


def takes_tables(pf) -> bool:
    """Whether this checkout's rope_pack_prefill takes ``tables``."""
    import inspect
    return "tables" in inspect.signature(pf.rope_pack_prefill).parameters


def run(tag: str, kernels=KERNELS) -> list:
    import torch
    from ggml_cuda_experiments_tpu_torch.ops import paged_attention as pa
    from ggml_cuda_experiments_tpu_torch.ops import quant_matmul as qm
    from ggml_cuda_experiments_tpu_torch.utils.bench import rotating
    from ggml_cuda_experiments_tpu_torch.utils.device_info import (
        card_line, card_spec)
    if not torch.cuda.is_available():
        raise RuntimeError("qgemm_bench: needs a CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    spec = card_spec()
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def row(kernel, case, ms, nbytes, flops, kind, **extra):
        bound_ms, by = spec.bound_ms(nbytes, flops, kind)
        r = {"tag": tag, "kernel": kernel, "case": case, "us": 1e3 * ms,
             "bound_us": 1e3 * bound_ms, "bound_by": by,
             "ratio": bound_ms / ms, **extra}
        rows.append(r)
        print(f"{tag} {kernel} {case}: {r['us']:.2f} us, bound "
              f"{r['bound_us']:.2f} us ({by}), ratio {r['ratio']:.3f}"
              + "".join(f", {k} {v}" for k, v in extra.items()), flush=True)

    if "gemm" in kernels:
        route_of = getattr(qm, "gemm_route", None)
        ws, key = None, None
        for fmt, layer, (n, k), m in cases():
            if key != (fmt, layer):
                def make(i, n=n, k=k, fmt=fmt):
                    return qm.quantize(torch.randn(
                        (n, k), generator=g, device=dev) * k ** -0.5, fmt)
                ws, key = None, (fmt, layer)
                torch.cuda.empty_cache()
                ws = rotating(make, make(0).nbytes)
            t = gemm_times(qm, getattr(qm, NAMES[fmt]), gemm_x(m, n, k, dev),
                           ws)
            extra = {"route": route_of(m) if route_of else None,
                     "copies": len(ws)}
            if "matmul_ms" in t:
                extra["matmul_us"] = 1e3 * t["matmul_ms"]
            row(NAMES[fmt], f"{layer} N={n} K={k} M={m}", t["ms"],
                ws[0].nbytes + 2 * m * k + 4 * m * n, 2 * m * n * k, "bf16",
                **extra)
        del ws
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if "matvec" in kernels:
        for fmt in MATVECS:
            for layer, (n, k) in LINEARS + STARTS:
                torch.cuda.empty_cache()
                ws = matvec_weights(qm, fmt, n, k, g)
                x = torch.randn((1, k), generator=g, device=dev)
                t = matvec_case(qm, fmt, ws, x)
                row(MATVECS[fmt], f"{layer} N={n} K={k}", t["ms"],
                    t["bytes"], t["flops"], "f32", copies=len(ws),
                    splits=matvec_split(qm, fmt, n, k, sms))
                del ws
    if "paged" in kernels:
        torch.cuda.empty_cache()
        for case, lengths, fmts in (("headline", PAGED_LENGTHS,
                                     ("bf16", "int8", "fp8")),
                                    ("engine", ENGINE_LENGTHS, ("int8",))):
            for fmt in fmts:
                inputs = paged_inputs(dev, fmt, lengths)
                nbytes, flops = paged_bytes(lengths, fmt)
                row("paged_decode", f"{case} {fmt}", paged_case(pa, inputs),
                    nbytes, flops, "bf16")
                del inputs
    if "fused_attn" in kernels:
        from ggml_cuda_experiments_tpu_torch.ops import fused_attention as fat
        plan = getattr(fat, "split_plan", None)
        for hkv, length in ATTN_CASES:
            torch.cuda.empty_cache()
            inputs = attn_inputs(qm, dev, hkv, length, g)
            nbytes, ops = attn_bytes(inputs)
            row("fused_attention", f"32/{hkv} len {min(length + 1, ATTN_S)}",
                attn_case(fat, inputs), nbytes, ops, "int8",
                splits=len(plan(length, ATTN_S, hkv, sms, torch.bfloat16))
                if plan else None)
            del inputs
    if "rope_pack" in kernels:
        from ggml_cuda_experiments_tpu_torch.ops import prefill_fuse as pf
        inputs = rope_inputs(dev, g=g)
        for given in ((True, False) if takes_tables(pf) else (False,)):
            nbytes, ops = rope_bytes(inputs, given)
            row("rope_pack", "T=512 32/32 D=128, tables "
                + ("given" if given else "made by the call"),
                rope_case(pf, inputs, given), nbytes, ops, "f32")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None,
                    help="time the package of the checkout at this path")
    ap.add_argument("--tag", default="new")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="comma-separated: " + ", ".join(KERNELS))
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        ap.error(f"--kernels: from {', '.join(KERNELS)}")
    if args.root:
        env = dict(os.environ, PYTHONPATH=str(Path(args.root).resolve()))
        return subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tag", args.tag, "--kernels", args.kernels],
                              env=env).returncode
    print(json.dumps({"qgemm_bench": run(args.tag, kernels)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
