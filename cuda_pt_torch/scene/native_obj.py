"""ctypes bridge to the native OBJ parser (port of
cuda_pt_tpu/scene/native_obj.py; scene/cpp/obj_loader.cpp is the port's copy
of the reference's source).

Built at first use by utils/host_build.py into build/cuda_pt_torch/host/,
as accel/native.py builds the BVH builders; where g++ is missing the port
warns once and load_obj falls back to the pure-Python parser
(scene/obj_loader.py).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils import host_build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cpp", "obj_loader.cpp")
_LOCK = threading.Lock()
_STATE: dict = {}  # "lib" -> CDLL or None, loaded once per process


def _load():
    with _LOCK:
        if "lib" not in _STATE:
            lib = host_build.load(_SRC, (), "OBJ files load with the Python parser "
                                  "(scene/obj_loader.py)")
            if lib is not None:
                fp = ctypes.POINTER(ctypes.c_float)
                lib.obj_parse.restype = ctypes.c_void_p
                lib.obj_parse.argtypes = [ctypes.c_char_p]
                lib.obj_num_tris.restype = ctypes.c_int64
                lib.obj_num_tris.argtypes = [ctypes.c_void_p]
                lib.obj_fill.restype = None
                lib.obj_fill.argtypes = [ctypes.c_void_p, fp, fp, fp]
                lib.obj_free.restype = None
                lib.obj_free.argtypes = [ctypes.c_void_p]
            _STATE["lib"] = lib
        return _STATE["lib"]


def available() -> bool:
    return _load() is not None


def load_obj_native(path: str):
    """Native load_obj: dict {p (T,3,3), n (T,3,3), uv (T,3,2)} float32,
    or None when the native library is unavailable or parsing fails."""
    lib = _load()
    if lib is None:
        return None
    h = lib.obj_parse(os.fsencode(path))
    if not h:
        return None
    try:
        T = int(lib.obj_num_tris(h))
        p = np.zeros((T, 3, 3), np.float32)
        n = np.zeros((T, 3, 3), np.float32)
        uv = np.zeros((T, 3, 2), np.float32)
        if T:
            fp = ctypes.POINTER(ctypes.c_float)
            lib.obj_fill(h, p.ctypes.data_as(fp), n.ctypes.data_as(fp), uv.ctypes.data_as(fp))
        return {"p": p, "n": n, "uv": uv}
    finally:
        lib.obj_free(h)
