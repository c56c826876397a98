"""The port's host-side C++ library: the multithreaded block-quant codec
(here) and the continuous-batching scheduler (``utils/native_sched.py``).

The port's counterpart of the JAX package's ``utils/native.py``. The C++
sources are the port's own copies, ``csrc/native/gct_native.cpp`` and
``gct_sched.cpp``; the JAX side's ``native/libgct_native.so`` is never
loaded. ``build`` compiles both with ``$CXX`` (g++ by default) and the JAX
side's ``native/Makefile`` flags into one shared library under
``build/native/<digest>/`` at the root of the checkout (git-ignored),
keyed by a hash of the sources, the compiler and the flags; ``lib`` builds
it at first use and loads it with ``ctypes``. Several processes may build
at once: each writes its own temporary and moves it into place. A missing
compiler or a failed build raises ``RuntimeError`` with the compiler's
output: there is no quiet fallback to the oracle.

``quantize`` / ``dequantize`` cover Q8_0, Q4_0, Q4_K and Q6_K, split over
``threads`` worker threads by rows, bit-equal to ``oracle/quant.py`` (the
port's tests hold them so) and returning its dataclasses, which
``ops/quant_matmul.py::from_oracle`` takes. The codec runs on the host;
the card's path quantizes on the device (``quant_matmul.quantize``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

from ggml_cuda_experiments_tpu_torch.oracle import quant as quant_ref

SRC = Path(__file__).resolve().parent.parent / "csrc" / "native"
SOURCES = ("gct_native.cpp", "gct_sched.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
LIB_NAME = "libgct_native.so"

_i64 = ctypes.c_int64
_int = ctypes.c_int
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_vp = ctypes.c_void_p

# name -> (restype, argtypes) of every C entry of the two sources
SIGNATURES = {
    "gct_version": (_int, ()),
    "gct_quantize_q8_0": (None, (_f32p, _i8p, _f32p, _i64, _i64, _int)),
    "gct_quantize_q4_0": (None, (_f32p, _u8p, _f32p, _i64, _i64, _int)),
    "gct_quantize_q4_k": (None, (_f32p, _u8p, _u8p, _u8p, _f32p, _f32p,
                                 _i64, _i64, _int)),
    "gct_quantize_q6_k": (None, (_f32p, _u8p, _i8p, _f32p, _i64, _i64,
                                 _int)),
    "gct_dequantize_q8_0": (None, (_i8p, _f32p, _f32p, _i64, _i64, _int)),
    "gct_dequantize_q4_0": (None, (_u8p, _f32p, _f32p, _i64, _i64, _int)),
    "gct_dequantize_q4_k": (None, (_u8p, _u8p, _u8p, _f32p, _f32p, _f32p,
                                   _i64, _i64, _int)),
    "gct_dequantize_q6_k": (None, (_u8p, _i8p, _f32p, _f32p, _i64, _i64,
                                   _int)),
    "gct_sched_new": (_vp, (_int,) * 5),
    "gct_sched_free": (None, (_vp,)),
    "gct_sched_add_request": (None, (_vp, _int, _int, _int)),
    "gct_sched_admit": (_int, (_vp, _i32p, _i32p, _i32p)),
    "gct_sched_step_complete": (_int, (_vp, _u8p, _i32p, _i32p)),
    "gct_sched_num_running": (_int, (_vp,)),
    "gct_sched_num_waiting": (_int, (_vp,)),
    "gct_sched_num_free_pages": (_int, (_vp,)),
    "gct_sched_state": (None, (_vp, _i32p, _i32p)),
}

THREADS = max(1, os.cpu_count() or 1)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> list[str]:
    """``$CXX`` split as a shell would (g++ when unset)."""
    return shlex.split(os.environ.get("CXX") or "g++")


def _digest(cxx: list[str]) -> str:
    h = hashlib.sha256(" ".join([*cxx, *FLAGS]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(root: Path = BUILD_ROOT) -> Path:
    """Compile the two sources (if this digest has no library under
    ``root`` yet) and return the library's path; raises ``RuntimeError``
    with the compiler's output when it cannot."""
    cxx = _compiler()
    out_dir = Path(root) / _digest(cxx)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    if not cxx or shutil.which(cxx[0]) is None:
        raise RuntimeError(f"native build: no compiler {cxx!r} (set CXX)")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [*cxx, *FLAGS, "-o", str(tmp), *(str(SRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded library, built at the first call."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.restype = restype
                fn.argtypes = list(argtypes)
            _lib = cdll
        return _lib


def _rows(x: np.ndarray) -> tuple[np.ndarray, tuple]:
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim == 0:
        raise ValueError("quantize: x needs at least one axis")
    return x.reshape(-1, x.shape[-1]), x.shape


def _check_k(fmt: str, k: int) -> None:
    block = quant_ref.QK if fmt in ("q8_0", "q4_0") else quant_ref.QK_K
    if k % block:
        raise ValueError(f"{fmt}: last dim {k} must be a multiple of {block}")


def quantize(x: np.ndarray, fmt: str, threads: int = THREADS):
    """``x`` [..., K] f32 -> the oracle's ``Q8_0`` / ``Q4_0`` / ``Q4_K`` /
    ``Q6_K`` of it, bit for bit, by the C++ codec on ``threads`` threads."""
    x2, shape = _rows(x)
    n, k = x2.shape
    lead = shape[:-1]
    _check_k(fmt, k)
    c = lib()
    if fmt == "q8_0":
        qs = np.empty((n, k), np.int8)
        d = np.empty((n, k // 32), np.float32)
        c.gct_quantize_q8_0(x2, qs, d, n, k, threads)
        return quant_ref.Q8_0(qs=qs.reshape(shape),
                              d=d.reshape(*lead, k // 32), shape=shape)
    if fmt == "q4_0":
        qs = np.empty((n, k // 2), np.uint8)
        d = np.empty((n, k // 32), np.float32)
        c.gct_quantize_q4_0(x2, qs, d, n, k, threads)
        return quant_ref.Q4_0(qs=qs.reshape(*lead, k // 2),
                              d=d.reshape(*lead, k // 32), shape=shape)
    if fmt == "q4_k":
        qs = np.empty((n, k // 2), np.uint8)
        sc = np.empty((n, k // 32), np.uint8)
        mn = np.empty((n, k // 32), np.uint8)
        d = np.empty((n, k // 256), np.float32)
        dmin = np.empty((n, k // 256), np.float32)
        c.gct_quantize_q4_k(x2, qs, sc, mn, d, dmin, n, k, threads)
        return quant_ref.Q4_K(
            qs=qs.reshape(*lead, k // 2), sc=sc.reshape(*lead, k // 32),
            mn=mn.reshape(*lead, k // 32), d=d.reshape(*lead, k // 256),
            dmin=dmin.reshape(*lead, k // 256), shape=shape)
    if fmt == "q6_k":
        qs = np.empty((n, k), np.uint8)
        sc = np.empty((n, k // 16), np.int8)
        d = np.empty((n, k // 256), np.float32)
        c.gct_quantize_q6_k(x2, qs, sc, d, n, k, threads)
        return quant_ref.Q6_K(qs=qs.reshape(shape),
                              sc=sc.reshape(*lead, k // 16),
                              d=d.reshape(*lead, k // 256), shape=shape)
    raise ValueError(f"quantize: fmt q8_0, q4_0, q4_k or q6_k, got {fmt!r}")


def _c(a, dtype, n: int, m: int) -> np.ndarray:
    return np.ascontiguousarray(a, dtype).reshape(n, m)


def dequantize(t, threads: int = THREADS) -> np.ndarray:
    """The oracle's blocks ``t`` -> f32 [..., K], bit for bit, by the C++
    codec on ``threads`` threads."""
    *lead, k = t.shape
    n = int(np.prod(lead)) if lead else 1
    out = np.empty((n, k), np.float32)
    c = lib()
    if isinstance(t, quant_ref.Q8_0):
        c.gct_dequantize_q8_0(_c(t.qs, np.int8, n, k),
                              _c(t.d, np.float32, n, k // 32), out, n, k,
                              threads)
    elif isinstance(t, quant_ref.Q4_0):
        c.gct_dequantize_q4_0(_c(t.qs, np.uint8, n, k // 2),
                              _c(t.d, np.float32, n, k // 32), out, n, k,
                              threads)
    elif isinstance(t, quant_ref.Q4_K):
        c.gct_dequantize_q4_k(_c(t.qs, np.uint8, n, k // 2),
                              _c(t.sc, np.uint8, n, k // 32),
                              _c(t.mn, np.uint8, n, k // 32),
                              _c(t.d, np.float32, n, k // 256),
                              _c(t.dmin, np.float32, n, k // 256), out, n, k,
                              threads)
    elif isinstance(t, quant_ref.Q6_K):
        c.gct_dequantize_q6_k(_c(t.qs, np.uint8, n, k),
                              _c(t.sc, np.int8, n, k // 16),
                              _c(t.d, np.float32, n, k // 256), out, n, k,
                              threads)
    else:
        raise TypeError(f"dequantize: {type(t).__name__} is none of Q8_0, "
                        "Q4_0, Q4_K, Q6_K")
    return out.reshape(t.shape)
