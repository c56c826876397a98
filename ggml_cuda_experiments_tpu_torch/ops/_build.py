"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it
with ``ctypes``.

Every kernel source has a plain C entry point (no PyTorch headers). The
build starts one ``nvcc -c`` per source, all at once, and links the objects
into one library: seconds in all. The library lands in
``build/kernels/<hash>/`` at the root of the checkout (git-ignored), keyed by
a hash of the sources and flags, and is built at the first launch of any
kernel. A missing ``nvcc`` or a failed build raises with nvcc's output.

Each C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("q4k_matmul.cu", "q4k_gemm.cu", "flash_decode.cu",
           "flash_attention.cu", "rope_pack.cu", "paged_attention.cu",
           "q4k_q8.cu", "fused_decode.cu", "q6k_matvec.cu", "q80_matvec.cu",
           "matmul.cu", "primitives.cu", "vpu_attention.cu", "q4_probe.cu",
           "q6_probe.cu", "mosaic_probes.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# name -> argtypes; every entry returns int (a cudaError_t)
SIGNATURES = {
    # x, qs, es, em, y, N, K, splits, stream
    "q4k_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, qs, es, em, y, M, N, K, route, stream
    "q4k_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the same with the tc route's phase (GEMM_PHASES) for the route
    "q4k_gemm_phase": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the q4_k "s6" instances: es, em -> sm (int8 sc | mn), dd (bf16 d | dmin)
    "q4k_s6_matvec": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "q4k_s6_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "q4k_s6_q8_matvec": (_P, _P, _P, _P, _P, _I, _I, _P),
    # the 32-block formats (fp16 d): x, qs, d, y, N, K, [splits,] stream
    "q40_matvec": (_P, _P, _P, _P, _I, _I, _I, _P),
    # x, qs, d, y, N, K, splits, stages, grid, stream
    "q80_matvec": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "q40_q8_matvec": (_P, _P, _P, _P, _I, _I, _P),
    # x, qs, d, y, M, N, K, route, stream
    "q40_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "q80_gemm": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k, v, lengths, o, m, s, B, Hq, Hkv, S, D, layer, n_splits,
    # scale, stream
    "flash_decode_partials": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P),
    # q, k, v (int8 / fp8), k_scale, v_scale, lengths, o, m, s, B, Hq, Hkv,
    # S, D, layer, n_splits, kv_kind, round_pv, scale, stream
    "flash_decode_partials_q": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _F, _P),
    # o, m, s, out, B, Hq, Hkv, D, n_splits, stream
    "lse_merge": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, mask, out, lse, B, Hq, Hkv, Sq, Sk, D, scale, causal, mask
    # strides (b, h, i, j), stream
    "flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _I, _L, _L, _L, _L, _P),
    # y, C, S2, qo, ko, vo, T, nH, nKV, D, stream
    "rope_pack": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # q, k_pages, v_pages, k_scale, v_scale, lengths, page_indices, out,
    # part scratch, tickets, B, Hq, Hkv, n_pages, page_size, D,
    # pages_per_seq, layer, n_splits, kv_kind, scale, stream
    "paged_decode": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, _I, _I, _F, _P),
    # x, qs, es, em, y, N, K, stream
    "q4k_q8_matvec": (_P, _P, _P, _P, _P, _I, _I, _P),
    # x, w_gu qs/es/em, w_down qs/es/em, ygu scratch, y, Kg, Kd, Nd, stream
    "fused_mlp": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "fused_mlp_s6": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # x, wqkv qs/es/em, wo qs/es/em, k, v, lengths, layer, Hq, Hkv, S,
    # cache_f32, theta, scale, yqkv / part / o-image scratch, o, k_new,
    # v_new, tickets, stream
    "fused_attention": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P),
    "fused_attention_s6": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _F, _F, _P, _P, _P, _P, _P, _P, _P,
                           _P),
    # h, ptrs, norms, k, v, lengths, layer0, nL, Hq, Hkv, S, Kd, cache_f32,
    # theta, scale, eps, yqkv / part / ygu / h2 scratch, h_out, k_new,
    # v_new, stream
    "layer_kernel": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P),
    # x, qs, qh, es, y, N, K, stream (both q6_k matvecs)
    "q6k_matvec": (_P, _P, _P, _P, _P, _I, _I, _P),
    "q6k_q8_matvec": (_P, _P, _P, _P, _P, _I, _I, _P),
    # x, w, out, M, N, K, lda, ldb, a_kmajor, b_kmajor, in_kind, out_kind,
    # route, stream
    "matmul_nt": (_P, _P, _P, _I, _I, _I, _L, _L, _I, _I, _I, _I, _I, _P),
    # x, out, R, in_bytes, out_bytes, stream
    "stage_pad": (_P, _P, _I, _I, _I, _P),
    # element count -> the CTAs (partials) of grid_sum
    "grid_sum_blocks": (_L,),
    # x, part, ticket, total, count, kind, stream
    "grid_sum": (_P, _P, _P, _P, _L, _I, _P),
    # x, mx, sm, n, d, kind, stream
    "lane_reduce": (_P, _P, _P, _I, _I, _I, _P),
    # q, k, v, lengths, o_part, m_part, l_part, B, H, T, S, D, scale,
    # causal, q0_pos, span, n_splits, dtype, vec, stream
    "vpu_attention_partials": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _I, _I, _I, _P),
    # o_part, m_part, l_part, o, lse, rows, D, n_splits, dtype, stream
    "vpu_attention_merge": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the q4_k stage ladder: mode, act, x, qs, es, em, y, N, K, ctas,
    # stream; x's int8 operands into device memory: x, out, K, stream
    "q4_ladder": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "q8_prep": (_P, _P, _I, _P),
    # the q6_k probe rungs: qs, qh, es, o, N / qh, xc, es, o, N / qs, lhs,
    # N, seg / z0, z1, ld, es, o, N (each + stream)
    "q6_stream": (_P, _P, _P, _P, _I, _P),
    "q6_bits2": (_P, _P, _P, _P, _I, _P),
    "q6_nib_lhs": (_P, _P, _I, _I, _P),
    "q6_nib_fold": (_P, _P, _I, _P, _P, _I, _P),
    # which, x, e, out, out2, R, C, C2, stream
    "mosaic_probe": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    # registers, shared memory and occupancy (int[7]): K / mode, K
    "q4k_q8_matvec_info": (_I, _P),
    # format (0 q4_k, 1 q4_0, 2 q4_k s6), K; kv_kind, page-list entries
    "q4_matvec_info": (_I, _I, _P),
    "paged_decode_info": (_I, _I, _P),
    "q80_matvec_info": (_I, _I, _P),      # K, stages
    "q4_ladder_info": (_I, _I, _P),
    # D / dtype, D
    "flash_attention_info": (_I, _P),
    # the layer kernel (0) or its attention block (1), Kd
    "layer_kernel_info": (_I, _I, _P),
    "vpu_attention_info": (_I, _I, _P),
    # clears and returns the runtime's last error
    "kernels_clear_error": (),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_INFO: dict = {}        # seconds, path, nvcc log of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc")]
    if home:
        cands.append(str(Path(home) / "bin" / "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the port's kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash has no library yet) and
    return the library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libkernels.so"
    if lib_path.exists():
        BUILD_INFO.update(seconds=0.0, path=str(lib_path), log="(cached)")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    t0 = time.perf_counter()
    jobs = []
    for src in SOURCES:
        obj = out_dir / f"{Path(src).stem}.{pid}.o"
        cmd = [nvcc, *FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(out)
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out}")
    tmp = out_dir / f"libkernels.{pid}.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                      log="".join(log) + proc.stdout + proc.stderr)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            cdll.kernels_error_string.argtypes = [ctypes.c_int]
            cdll.kernels_error_string.restype = ctypes.c_char_p
            _lib = cdll
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib().kernels_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as an int for ctypes."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
