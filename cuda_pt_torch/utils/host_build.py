"""Build the port's host C++ sources (the native OBJ parser and the SAH and
SBVH builders) with g++ and load them with ctypes.

Each library is compiled at first use, with the reference package's flags
(so that on one machine both packages' builders give bit-equal trees),
into build/cuda_pt_torch/host/ under a name that hashes its source and
flags: an edit rebuilds, an unchanged tree reuses the library. The compiler
writes a temporary file that os.replace moves into place, so processes that
build at once (test workers) never load a half-written library. Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "cuda_pt_torch", "host")
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")


def library_path(src: str, extra=()) -> str:
    """Where the library of src built with FLAGS + extra lives."""
    flags = (*FLAGS, *extra)
    h = hashlib.sha256()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(HOST_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def build(src: str, extra=()) -> str:
    """Compile src into its library (library_path) unless it is there;
    return the path. Raises OSError where g++ is missing and
    subprocess.CalledProcessError where it fails."""
    path = library_path(src, extra)
    if os.path.exists(path):
        return path
    os.makedirs(HOST_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *FLAGS, *extra, "-o", tmp, src], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def load(src: str, extra=(), what: str = "") -> ctypes.CDLL | None:
    """The CDLL of src, built at first use; None (with one warning naming
    what falls back) where it cannot be built or loaded."""
    try:
        return ctypes.CDLL(build(src, extra))
    except (OSError, subprocess.SubprocessError) as e:
        detail = e.stderr.decode(errors="replace")[-2000:] if getattr(e, "stderr", None) else e
        warnings.warn(f"{os.path.basename(src)} did not build ({detail}); {what}",
                      RuntimeWarning, stacklevel=3)
        return None
