"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each library is compiled at first use for sm_90a into build/cuda_pt_torch/
(listed in .gitignore) under a name that hashes its sources and flags, so
an edit rebuilds and an unchanged tree reuses the library. The C entry
points take raw pointers and the stream as ``c_void_p`` and return
cudaGetLastError() of their launch. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "cuda_pt_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# Per-thread traversal stack of the CUDA walk; make_pack raises for a scene
# that needs more.
MK_MAX_STACK = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (csrc/megakernel.cu)
_SIGNATURES = {
    "mk_trace": [_P] * 11 + [_I] * 8 + [_P],
    "mk_closest_hit": [_P] * 12 + [_I] * 3 + [_P],
}

_lib = None  # the CDLL, built from the sources as they were at first load


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _defines() -> list:
    """The constants the kernel shares with the plain path, passed from their
    one Python definition (floats as f32 literals)."""
    from . import intersect as isect
    from . import megakernel as mk

    return [f"-DHIT_EPS={isect.HIT_EPS!r}f", f"-DRAY_OFFSET={isect.RAY_OFFSET!r}f",
            f"-DSHADOW_T_FACTOR={1.0 - isect.SHADOW_T_SCALE!r}f",
            f"-DSLOT_F={mk.SLOT_F}", f"-DMAX_EMITTERS={mk.MAX_EMITTERS}",
            f"-DMK_MAX_STACK={MK_MAX_STACK}"]


def _flags() -> list:
    # FMA contraction stays on (nvcc's default, stated here); PERF.md records
    # its cost against -fmad=false.
    return [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-fmad=true", *_defines()]


def _sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith((".cu", ".cuh")))


def library_path() -> str:
    h = hashlib.sha1(" ".join(_flags()).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmegakernel_{h.hexdigest()[:12]}.so")


def start_build():
    """Start nvcc; returns (Popen or None if built, path)."""
    out = library_path()
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(out[:-3] + ".log", "w")
    cmd = [_nvcc(), *_flags(), "-o", tmp, os.path.join(CSRC, "megakernel.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc.log, proc.tmp = log, tmp
    return proc, out


def finish_build(proc, out: str) -> str:
    if proc is None:
        return out
    rc = proc.wait()
    proc.log.close()
    if rc != 0:
        with open(out[:-3] + ".log") as f:
            raise RuntimeError(f"nvcc failed ({rc}):\n{f.read()}")
    os.replace(proc.tmp, out)
    return out


def build() -> float:
    """Build the library if needed; returns the wall seconds."""
    t0 = time.perf_counter()
    finish_build(*start_build())
    return time.perf_counter() - t0


def build_log() -> str:
    """nvcc's output of the last build (ptxas register and spill counts),
    or "" when the library was reused."""
    path = library_path()[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load() -> ctypes.CDLL:
    """The megakernel library, built if needed. The sources are hashed once
    per process, not on every launch."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(finish_build(*start_build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
