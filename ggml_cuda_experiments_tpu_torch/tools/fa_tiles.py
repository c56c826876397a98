"""The flash-attention kernel's query tile and K / V ring depth on the card:
``csrc/flash_attention.cu`` built once per variant with ``FA_WARPS`` (16
query rows a warp: 4 warps = 64-row tiles, 8 = 128-row) and ``FA_STAGES``
replaced, each into its own library under ``build/fa_tiles/``, checked
against the plain version and timed beside SDPA at the prefill shapes.

    python -m ggml_cuda_experiments_tpu_torch.tools.fa_tiles [--variants 4x3,8x3,4x2]

A variant is WARPSxSTAGES. Per shape the variants run in turns, forward
then backward (a, b, b, a), each reading 20 calls captured in a CUDA graph,
the least of 5 replays (CUDA events); one line per (shape, variant) with
both readings, SDPA's, the registers, shared memory and CTAs per SM, and
the card's name and power limit first. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ggml_cuda_experiments_tpu_torch.ops import _build
from ggml_cuda_experiments_tpu_torch.ops.flash_attention import \
    flash_attention_ref

ANCHORS = ("constexpr int FA_STAGES = 3;", "constexpr int FA_WARPS = 4;")
# (name, Sq, Sk, H, D, causal, verify mask)
SHAPES = (("T=512 causal", 512, 512, 32, 128, True, False),
          ("T=128 causal", 128, 128, 32, 128, True, False),
          ("T=5 over S=1024, verify mask", 5, 1024, 32, 128, False, True))


def variant_source(warps: int, stages: int) -> str:
    """The kernel source with FA_WARPS and FA_STAGES replaced."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    for anchor in ANCHORS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"flash_attention.cu: no single {anchor!r}")
    return src.replace(ANCHORS[0], f"constexpr int FA_STAGES = {stages};") \
        .replace(ANCHORS[1], f"constexpr int FA_WARPS = {warps};")


def build_variant(warps: int, stages: int) -> ctypes.CDLL:
    out = _build.BUILD_ROOT.parent / "fa_tiles" / f"{warps}x{stages}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(variant_source(warps, stages))
    lib = out / "libfa.so"
    subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-I",
                    str(_build.CSRC), "-o", str(lib),
                    str(out / "flash_attention.cu")], check=True,
                   capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for name in ("flash_attention_fwd", "flash_attention_info"):
        getattr(cdll, name).argtypes = list(_build.SIGNATURES[name])
        getattr(cdll, name).restype = ctypes.c_int
    return cdll


def _inputs(Sq, Sk, H, D, verify, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, H, n, D), generator=g, device=dev)
               .to(torch.bfloat16) for n in (Sq, Sk, Sk))
    mask = None
    if verify:
        kv = torch.arange(Sk, device=dev)
        pos = Sk - Sq + torch.arange(Sq, device=dev)[:, None]
        mask = torch.where(kv <= pos, 0.0, -torch.inf)[None, None]
    return q, k, v, mask


def _call(cdll, q, k, v, mask, causal, out):
    B, H, Sq, D = q.shape
    strides = (0, 0, 0, 0) if mask is None else torch.broadcast_to(
        mask, (B, H, Sq, k.shape[2])).stride()
    rc = cdll.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(), None, B, H,
        H, Sq, k.shape[2], D, float(D ** -0.5), int(causal), *strides,
        _build.stream_of(q))
    _build.check(rc, "flash_attention_fwd")


def _us(call) -> float:
    from ggml_cuda_experiments_tpu_torch.utils.bench import (capture,
                                                             replay_seconds)
    graph = capture(lambda i: call(), 20)
    return replay_seconds(graph, reps=5) / 20 * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="4x3,8x3,4x2")
    args = ap.parse_args(argv)
    from ggml_cuda_experiments_tpu_torch.utils.device_info import card_line
    from ggml_cuda_experiments_tpu_torch.utils.platform import require_cuda
    dev = require_cuda()
    print(card_line())
    variants = [tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")]
    libs = {v: build_variant(*v) for v in variants}
    from ggml_cuda_experiments_tpu_torch.ops.probes import _info
    for name, Sq, Sk, H, D, causal, verify in SHAPES:
        q, k, v, mask = _inputs(Sq, Sk, H, D, verify, dev)
        ref = flash_attention_ref(q, k, v, mask, causal=causal).float()
        lib_us = _us(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=None if mask is None else mask == 0,
            is_causal=causal))
        times = {var: [] for var in variants}
        for var in variants + variants[::-1]:
            out = torch.empty_like(q)
            times[var].append(_us(lambda: _call(libs[var], q, k, v, mask,
                                                causal, out)))
            err = float((out.float() - ref).abs().max())
            if not err <= 1e-2 * float(ref.abs().max()):
                raise AssertionError(f"{var} {name}: error {err}")
        for var in variants:
            info = _info(libs[var].flash_attention_info, D)
            print(f"{name:30s} {var[0]} warps ({16 * var[0]}-row tiles), "
                  f"{var[1]} stages: {times[var][0]:.1f} / {times[var][1]:.1f}"
                  f" us, SDPA {lib_us:.1f} us ({min(times[var]) / lib_us:.2f}"
                  f"x); regs {info['regs']}, smem {info['dynamic_smem']} B, "
                  f"{info['ctas_per_sm']} CTAs per SM, spill "
                  f"{info['local_bytes']} B", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
