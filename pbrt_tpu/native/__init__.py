"""Native (C++) host runtime components, loaded via ctypes.

The reference's host runtime is all C++ (SURVEY.md section 2); the
pieces worth keeping native here are the scene-build hot paths — the
BVH builder first. Compiled on demand with g++ (no pybind11 in the
image); every caller has a pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_dir() -> str:
    return os.path.dirname(os.path.abspath(__file__))


def _cache_dir() -> str:
    """Where the compiled library lives: `$PBRT_TPU_CACHE`, else next to
    its source inside the checkout (`*.so` there is git-ignored)."""
    d = os.environ.get("PBRT_TPU_CACHE") or _build_dir()
    os.makedirs(d, exist_ok=True)
    return d


def load_native():
    """-> ctypes.CDLL or None.

    Always compiles on the running host, into a cache dir keyed by the
    SOURCE CONTENT hash — never a checked-in binary (a foreign-arch or
    -march=native .so from another machine would SIGILL on load, which
    ctypes cannot catch) and never an mtime comparison (fresh checkouts
    give source and binary the same mtime)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_build_dir(), "bvh_builder.cpp")
        try:
            with open(src, "rb") as f:
                h = hashlib.sha256(f.read()).hexdigest()[:16]
            so = os.path.join(_cache_dir(), f"libpbrt_native-{h}.so")
            if not os.path.exists(so):
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                     src, "-o", tmp],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.pbrt_build_bvh.restype = ctypes.c_int
            lib.pbrt_build_bvh.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int,
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_build_bvh(lo, hi, method: str):
    """numpy bounds -> (node_lo, node_hi, node_meta, order) or None."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    n = len(lo)
    method_id = {"sah": 0, "middle": 1, "equal": 2, "aac": 3}.get(method, 0)
    max_nodes = max(16, 4 * n)
    lo_c = np.ascontiguousarray(lo, np.float32)
    hi_c = np.ascontiguousarray(hi, np.float32)
    node_lo = np.zeros((max_nodes, 3), np.float32)
    node_hi = np.zeros((max_nodes, 3), np.float32)
    meta = np.zeros((max_nodes, 3), np.int32)
    order = np.zeros(n, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    cnt = lib.pbrt_build_bvh(
        lo_c.ctypes.data_as(fp), hi_c.ctypes.data_as(fp), n, method_id,
        node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
        meta.ctypes.data_as(ip), order.ctypes.data_as(ip), max_nodes,
    )
    if cnt <= 0:
        return None
    return node_lo[:cnt], node_hi[:cnt], meta[:cnt], order
