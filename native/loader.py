"""ctypes loader for the C++/OpenMP baseline (native/krylov_ref.cpp).

Compiles the shared library on first use (g++ is baked into the image;
pybind11 is not, so the binding layer is plain ctypes) and caches the
.so next to the source keyed by a source hash. The flags replicate the
reference build (CMakeLists.txt:5: -O3 -march=native -funroll-loops
-fopenmp).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "krylov_ref.cpp")
_LIB = None


def _build() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    so = os.path.join(_DIR, f"libkrylov_ref_{tag}.so")
    if not os.path.exists(so):
        # Build to a unique temp name and rename atomically: a partial
        # .so from an interrupted or racing compile must never satisfy
        # the existence check.
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [
            "g++", "-O3", "-march=native", "-funroll-loops", "-fopenmp",
            "-shared", "-fPIC", "-o", tmp, _SRC,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native baseline compile failed:\n{proc.stderr}"
            )
        os.replace(tmp, so)
    return so


def load(threads: Optional[int] = None) -> ctypes.CDLL:
    """Compile (if needed) and load the library; idempotent."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        dp = ctypes.POINTER(ctypes.c_double)
        i64 = ctypes.c_int64
        lib.krylov_ref_set_threads.argtypes = [ctypes.c_int]
        lib.krylov_ref_stencil.argtypes = [dp, dp, i64]
        lib.krylov_ref_pcg.argtypes = [
            i64, dp, dp, ctypes.c_double, i64, ctypes.c_double,
            ctypes.c_double, dp,
        ]
        lib.krylov_ref_pcg.restype = i64
        lib.krylov_ref_hh_gmres.argtypes = [
            i64, dp, dp, i64, ctypes.c_double, i64, ctypes.c_double,
            ctypes.c_double, ctypes.POINTER(i64), dp, i64,
        ]
        lib.krylov_ref_hh_gmres.restype = i64
        _LIB = lib
    if threads is not None:
        _LIB.krylov_ref_set_threads(threads)
    return _LIB


def _as_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def stencil(x: np.ndarray) -> np.ndarray:
    lib = load()
    n = x.shape[0]
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.empty_like(x)
    lib.krylov_ref_stencil(_as_ptr(x), _as_ptr(y), n)
    return y


def pcg(
    n: int, b: np.ndarray, tol: float = 1e-9, max_iter: int = 10_000,
    lo: float = 0.2, hi: float = 8.2, threads: Optional[int] = None,
):
    """Returns (x, iterations, final_res)."""
    lib = load(threads)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1)
    x = np.zeros_like(b)
    res = ctypes.c_double(0.0)
    it = lib.krylov_ref_pcg(
        n, _as_ptr(b), _as_ptr(x), tol, max_iter, lo, hi,
        ctypes.byref(res),
    )
    return x, int(it), float(res.value)


def hh_gmres(
    n: int, b: np.ndarray, m: int = 50, tol: float = 1e-8,
    max_restarts: int = 1000, lo: float = 0.2, hi: float = 8.2,
    threads: Optional[int] = None, certify_true: bool = False,
):
    """Returns (x, total_iterations, restarts, final_rel_res).
    certify_true: stop on the true residual after full cycles, as
    ``gmres(certify="true")`` does."""
    lib = load(threads)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1)
    x = np.zeros_like(b)
    res = ctypes.c_double(0.0)
    restarts = ctypes.c_int64(0)
    it = lib.krylov_ref_hh_gmres(
        n, _as_ptr(b), _as_ptr(x), m, tol, max_restarts, lo, hi,
        ctypes.byref(restarts), ctypes.byref(res), int(certify_true),
    )
    return x, int(it), int(restarts.value), float(res.value)
