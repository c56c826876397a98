"""Build ``csrc/*.cu`` with ``nvcc`` into one shared library and bind it
with ``ctypes``.

Every kernel source has a plain C entry point (no PyTorch headers), so the
whole build is one ``nvcc`` call of seconds. The library lands in
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
SOURCES = ("q4k_matmul.cu", "flash_decode.cu", "flash_attention.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every entry returns int (a cudaError_t)
SIGNATURES = {
    # x, qs, es, em, y, N, K, stream
    "q4k_matvec": (_P, _P, _P, _P, _P, _I, _I, _P),
    # x, qs, es, em, y, M, N, K, stream
    "q4k_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # q, k, v, lengths, o, m, s, B, Hq, Hkv, S, D, layer, n_splits,
    # scale, stream
    "flash_decode_partials": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _F, _P),
    # o, m, s, out, B, Hq, Hkv, D, n_splits, stream
    "lse_merge": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, k, v, out, B, Hq, Hkv, Sq, Sk, D, scale, causal, stream
    "flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                            _P),
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
    tmp = out_dir / f"libkernels.{os.getpid()}.so"
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(seconds=secs, path=str(lib_path),
                      log=proc.stdout + proc.stderr)
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
