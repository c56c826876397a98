"""Randomized kernel correctness and timing harness for the split-KV
flash decode: the port's counterpart of the JAX package's
``tools/kernel_test.py`` (itself the analog of the reference's
``kernel_test`` CLI).

    python -m ggml_cuda_experiments_tpu_torch.tools.kernel_test [--cpu]
        [--kv-size N] [--no-kv-parallel] [--kv-splits N] [--head-dim D]
        [--heads H] [--kv-heads H] [--batch B] [--quantized-kv] [--seed S]
        [--tol T]

It makes random inputs from ``--seed``, runs the NumPy oracle
(``oracle.attention.attention_ref``), runs the port's ``flash_decode``
(split-KV over ``--kv-splits`` partials and the LSE merge, or one split
with ``--no-kv-parallel``; an int8 cache with per-token scales with
``--quantized-kv``), prints the card, the oracle's time, the kernel's time
(CUDA events) and the worst-index difference, and exits 1 when the largest
absolute difference exceeds ``--tol``. The decode takes bf16 q (and a bf16
cache), so the inputs are rounded through bf16 before the oracle sees them:
the difference measures the kernel, not the input cast. ``--cpu`` runs the
plain versions on the CPU and prints no device time.
"""

from __future__ import annotations

import argparse
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-size", type=int, default=512,
                    help="KV length (at least 256)")
    ap.add_argument("--no-kv-parallel", action="store_true",
                    help="one split instead of split-KV + merge")
    ap.add_argument("--kv-splits", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--quantized-kv", action="store_true",
                    help="int8 KV with per-token scales")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="the plain versions on the CPU (no device time)")
    ap.add_argument("--tol", type=float, default=2e-2)
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    import numpy as np
    import torch

    from ggml_cuda_experiments_tpu_torch.ops.flash_decode import flash_decode
    from ggml_cuda_experiments_tpu_torch.oracle.attention import (
        attention_ref)
    from ggml_cuda_experiments_tpu_torch.oracle.quant import (
        dequantize_int8_rowwise, quantize_int8_rowwise)
    from ggml_cuda_experiments_tpu_torch.utils.bench import bench
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.harness import (
        diff_report, max_abs_diff)
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda

    dev = torch.device("cpu") if args.cpu else require_cuda()
    print("device: cpu (the plain versions)" if args.cpu
          else f"card: {card_line()}")
    kv = max(256, args.kv_size)
    splits = 1 if args.no_kv_parallel else args.kv_splits
    B, Hq, Hkv, D = args.batch, args.heads, args.kv_heads, args.head_dim
    print(f"shapes: batch={B} heads={Hq}/{Hkv} head_dim={D} kv={kv} "
          f"{'single-pass' if args.no_kv_parallel else f'split-kv x{splits}'}"
          f"{' int8-kv' if args.quantized_kv else ''}")

    rng = np.random.default_rng(args.seed)

    def bf(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    q = bf(rng.normal(size=(B, Hq, D)).astype(np.float32))
    k = rng.normal(size=(B, Hkv, kv, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, kv, D)).astype(np.float32)
    kwargs = {}
    if args.quantized_kv:
        kq, ks = quantize_int8_rowwise(k)
        vq, vs = quantize_int8_rowwise(v)
        k_oracle = dequantize_int8_rowwise(kq, ks)
        v_oracle = dequantize_int8_rowwise(vq, vs)
        kd, vd = (torch.from_numpy(a).to(dev) for a in (kq, vq))
        kwargs = dict(k_scale=torch.from_numpy(ks[..., 0]).to(dev),
                      v_scale=torch.from_numpy(vs[..., 0]).to(dev))
    else:
        k_oracle, v_oracle = bf(k), bf(v)
        kd, vd = (torch.from_numpy(a).to(dev, torch.bfloat16)
                  for a in (k_oracle, v_oracle))
    qd = torch.from_numpy(q).to(dev, torch.bfloat16)

    t0 = time.perf_counter()
    want = attention_ref(q[:, :, None], k_oracle, v_oracle)[:, :, 0]
    print(f"cpu oracle: {time.perf_counter() - t0:.2f}s")

    def fn():
        return flash_decode(qd, kd, vd, kv_splits=splits, **kwargs)

    got = fn().float().cpu().numpy()
    if args.cpu:
        print("kernel time: not measured (the plain version on the CPU)")
    else:
        kv_bytes = 2 * B * Hkv * kv * D * (1 if args.quantized_kv else 2)
        r = bench(fn, iters=20, name="flash_decode",
                  bytes_per_iter=kv_bytes + 4 * B * Hq * D,
                  flops_per_iter=4 * B * Hq * kv * D)
        print(f"cuda time: {r.seconds_per_iter * 1e3:.4f} ms "
              f"({r.gbytes_per_s:.0f} GB/s, {r.roofline_bw_pct():.1f}% of "
              f"HBM)")

    mad, _ = max_abs_diff(got, want)
    print(diff_report("flash_decode vs oracle", got, want))
    if not mad <= args.tol:
        print(f"FAIL: max diff {mad} > tol {args.tol}")
        return 1
    print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
