"""ctypes bridge to the native C++ BVH builders (port of
cuda_pt_tpu/accel/native.py: the same C ABI, signatures and output dicts).

accel/cpp/bvh_builder.cpp (binned SAH, the default build) and
accel/cpp/sbvh_builder.cpp (spatial splits) are the port's copies of the
reference's sources, built at first use by utils/host_build.py into
build/cuda_pt_torch/host/. Where g++ is missing or fails, the library is
unavailable: the port warns once per library, available() /
sbvh_available() say False, and callers fall back to the NumPy builder
(accel/bvh_build.py), as the reference does.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import host_build

_CPP = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp")
_SRC = os.path.join(_CPP, "bvh_builder.cpp")
_SRC_SBVH = os.path.join(_CPP, "sbvh_builder.cpp")

_LOCK = threading.Lock()
_LIBS: dict = {}  # source -> CDLL or None, loaded once per process

_F = ctypes.POINTER(ctypes.c_float)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    # lo, hi, cent, n, max_leaf, overlap_w, out_min, out_max, out_skip,
    # out_base, out_count, out_order
    _SRC: ("bvh_build", [_F, _F, _F, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
                         _F, _F, _I32, _I32, _I32, _I64]),
    # p0, e1, e2, is_sphere, n, max_leaf, overlap_w, dup_budget_frac,
    # out_min, out_max, out_skip, out_base, out_count, out_order, out_m
    _SRC_SBVH: ("sbvh_build", [_F, _F, _F, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                               ctypes.c_int32, ctypes.c_float, ctypes.c_float,
                               _F, _F, _I32, _I32, _I32, _I64, _I64]),
}


def _load(src: str):
    with _LOCK:
        if src not in _LIBS:
            extra = ("-pthread",) if src == _SRC_SBVH else ()
            lib = host_build.load(src, extra, "the BVH builds fall back to the NumPy SAH "
                                  "builder (accel/bvh_build.py)")
            if lib is not None:
                name, argtypes = _SIGNATURES[src]
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int64
                fn.argtypes = argtypes
            _LIBS[src] = lib
        return _LIBS[src]


def available() -> bool:
    return _load(_SRC) is not None


def sbvh_available() -> bool:
    return _load(_SRC_SBVH) is not None


def _p(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def build_bvh_native(lo: np.ndarray, hi: np.ndarray, cent: np.ndarray,
                     max_leaf: int = 4, overlap_w: float = 1.0):
    """Native counterpart of bvh_build.build_bvh; returns the same dict or
    None when the native library is unavailable."""
    lib = _load(_SRC)
    if lib is None:
        return None
    n = lo.shape[0]
    if n == 0:
        return None
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    cent = np.ascontiguousarray(cent, np.float32)
    cap = 2 * n + 8
    out_min = np.empty((cap, 3), np.float32)
    out_max = np.empty((cap, 3), np.float32)
    out_skip = np.empty(cap, np.int32)
    out_base = np.empty(cap, np.int32)
    out_count = np.empty(cap, np.int32)
    out_order = np.empty(n, np.int64)
    f, i32, i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    m = lib.bvh_build(
        _p(lo, f), _p(hi, f), _p(cent, f), n, max_leaf, overlap_w,
        _p(out_min, f), _p(out_max, f), _p(out_skip, i32), _p(out_base, i32),
        _p(out_count, i32), _p(out_order, i64))
    if m <= 0:
        return None
    return {
        "node_min": out_min[:m].copy(),
        "node_max": out_max[:m].copy(),
        "node_skip": out_skip[:m].copy(),
        "node_base": out_base[:m].copy(),
        "node_count": out_count[:m].copy(),
        "order": out_order.copy(),
    }


def build_sbvh_native(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                      is_sphere: np.ndarray, max_leaf: int = 4,
                      overlap_w: float = 1.0, dup_budget_frac: float = 0.5):
    """Spatial-split BVH (accel/cpp/sbvh_builder.cpp).

    Returns the bvh_build dict, where ``order`` (n_out >= n, with duplicate
    original prim ids) maps output slot -> original prim. None on failure.
    Subtrees of more than 4,096 refs build on threads that share one
    duplicate budget, so where it binds the tree can differ between runs,
    as the reference's does.
    """
    lib = _load(_SRC_SBVH)
    if lib is None:
        return None
    n = p0.shape[0]
    if n == 0:
        return None
    p0 = np.ascontiguousarray(p0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    sph = np.ascontiguousarray(is_sphere, np.uint8)
    ncap = 4 * n + 8
    out_min = np.empty((ncap, 3), np.float32)
    out_max = np.empty((ncap, 3), np.float32)
    out_skip = np.empty(ncap, np.int32)
    out_base = np.empty(ncap, np.int32)
    out_count = np.empty(ncap, np.int32)
    out_order = np.empty(3 * n, np.int64)
    out_m = np.zeros(1, np.int64)
    f, i32, i64 = ctypes.c_float, ctypes.c_int32, ctypes.c_int64
    n_out = lib.sbvh_build(
        _p(p0, f), _p(e1, f), _p(e2, f), _p(sph, ctypes.c_uint8), n, max_leaf,
        overlap_w, dup_budget_frac,
        _p(out_min, f), _p(out_max, f), _p(out_skip, i32), _p(out_base, i32),
        _p(out_count, i32), _p(out_order, i64), _p(out_m, i64))
    if n_out <= 0:
        return None
    m = int(out_m[0])
    return {
        "node_min": out_min[:m].copy(),
        "node_max": out_max[:m].copy(),
        "node_skip": out_skip[:m].copy(),
        "node_base": out_base[:m].copy(),
        "node_count": out_count[:m].copy(),
        "order": out_order[:n_out].copy(),
    }
