"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each library is compiled at first use for sm_90a into build/cuda_pt_torch/
(listed in .gitignore) under a name that hashes its sources and flags, so
an edit rebuilds and an unchanged tree reuses the library. Its translation
units compile in parallel, one nvcc each, and are then linked. The C entry
points take raw pointers and the stream as ``c_void_p`` and return
cudaGetLastError() of their launch. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "cuda_pt_torch")
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# Per-thread traversal stack of the CUDA walk; make_pack raises for a scene
# that needs more.
MK_MAX_STACK = 64
# Resident 128-thread blocks per SM the trace kernel is built for
# (__launch_bounds__); caps its registers at 65536 / (128 * MK_MIN_BLOCKS).
# The walks wait on memory: on the H100 more resident warps beat the local
# memory traffic of the spills this causes (PERF.md; measured with
# tools/kernel_variants.py).
MK_MIN_BLOCKS = 8
# The whole-path kernel stages a w8 pack's f32 node, prim, attr, material
# and emitter tables in shared memory where they take at most this many
# bytes (csrc/trace.cuh: cornell's 8 KB ran K2 14 % faster, PERF.md):
# eight resident blocks then leave most of the SM's L1 to the spills.
MK_STAGE_BYTES = 16384

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (csrc/megakernel*.cu: the first pointer is a host
# array of the pack's table pointers; csrc/traverse.cu: kernel K1;
# csrc/node_bench.cu: kernel S1; csrc/extract_ab.cu, lanegather.cu and
# mxuleaf.cu: kernels S2, S3 and S4)
_SIGNATURES = {
    "mk_trace": [_P] * 6 + [_I] * 17 + [_P, _P],
    "mk_closest_hit": [_P] * 7 + [_I] * 5 + [_P],
    "mk_closest_hit_sorted": [_P] * 8 + [_I] * 5 + [_P],
    "mk_trace_seg": [_P, _P, _I, _I, _I, _P, _P, _P] + [_I] * 17 + [_P, _P],
    "mk_traverse_resolve": [_P, _P, _I, _P, _I, _I, _P, _P, _P] + [_I] * 6 + [_P],
    "k1_traverse": [_P] * 3 + [_I] * 3 + [_P] * 3 + [_I] * 5 + [_P] * 7,
    "s1_node_bench": [_P, _I, _I, _P, _P, _P, _I, _P],
    "s2_extract_ab": [_I, _I, _P, _I, _I, _P, _P, _P, _I, _I, _P],
    "s2_cluster_size": [_I, _I],
    "s3_lanegather": [_I, _I, _P, _P, _P, _P, _I, _I, _P],
    "s4_mxuleaf": [_I, _P, _I, _P, _P, _P, _I, _P, _P],
    "s4_mxuleaf_scratch": [_I],
}
# entry points that return another type than int
_RESTYPES = {"s4_mxuleaf_scratch": ctypes.c_longlong}

_lib = None  # the CDLL, built from the sources as they were at first load


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def _defines(min_blocks: int) -> list:
    """The constants the kernel shares with the plain path, passed from their
    one Python definition (floats as f32 literals)."""
    from ..bsdf import spectral
    from . import intersect as isect
    from . import megakernel as mk

    def f32(x) -> str:
        return f"({float(x)!r}f)"

    spec = [f"-DSPEC_WL_MIN={f32(spectral.WL_MIN)}", f"-DSPEC_WL_MAX={f32(spectral.WL_MAX)}"]
    spec += [f"-DSPEC_M{r}{c}={f32(spectral.XYZ_TO_SRGB[r, c])}"
             for r in range(3) for c in range(3)]
    spec += [f"-DSPEC_NORM_{ch}={f32(v)}" for ch, v in zip("RGB", spectral.NORM)]
    # one define per number: nvcc reads commas in a -D value as a list
    lobes = [lobe for axis in spectral.XYZ_LOBES for lobe in axis]
    spec += [f"-DSPEC_LOBE{li}{k}={f32(x)}" for li, lobe in enumerate(lobes)
             for k, x in enumerate(lobe)]
    return [f"-DHIT_EPS={isect.HIT_EPS!r}f", f"-DRAY_OFFSET={isect.RAY_OFFSET!r}f",
            f"-DSHADOW_T_FACTOR={1.0 - isect.SHADOW_T_SCALE!r}f",
            f"-DSLOT_F={mk.SLOT_F}", f"-DMAX_EMITTERS={mk.MAX_EMITTERS}",
            f"-DT9_PER_ROW={mk.T9_PER_ROW}",
            f"-DMK_MAX_STACK={MK_MAX_STACK}", f"-DMK_MIN_BLOCKS={min_blocks}",
            f"-DMK_STAGE_BYTES={MK_STAGE_BYTES}", *spec]


def _flags(fmad: bool = False, min_blocks: int = MK_MIN_BLOCKS) -> list:
    # FMA contraction off: the kernel then rounds as the plain PyTorch
    # version does, which keeps per-lane agreement on scenes whose specular
    # chains amplify rounding (PERF.md records the cost and the gain).
    return [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-fmad={str(fmad).lower()}", *_defines(min_blocks)]


def _sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh", ".inc")))


def units() -> list:
    """The translation units linked into the library (csrc/*.cu)."""
    return [f for f in _sources() if f.endswith(".cu")]


def library_path(flags: list | None = None) -> str:
    h = hashlib.sha1(" ".join(_flags() if flags is None else flags).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmegakernel_{h.hexdigest()[:12]}.so")


def start_build(flags: list | None = None):
    """Start one nvcc per translation unit; returns (the running build, or
    None if the library is built, its path)."""
    flags = _flags() if flags is None else flags
    out = library_path(flags)
    if os.path.exists(out):
        return None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(out[:-3] + ".log", "w")
    objs, procs = [], []
    for unit in units():
        obj = f"{tmp}.{os.path.basename(unit)[:-3]}.o"
        objs.append(obj)
        procs.append(subprocess.Popen([_nvcc(), *flags, "-c", "-o", obj, unit],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return {"procs": procs, "objs": objs, "log": log, "tmp": tmp, "flags": flags}, out


def finish_build(build, out: str) -> str:
    """Wait for start_build's compiles, link them into the library at out."""
    if build is None:
        return out
    log, rcs = build["log"], []
    for proc in build["procs"]:
        log.write(proc.communicate()[0].decode(errors="replace"))
        rcs.append(proc.returncode)
    if not any(rcs):
        arch = [f for f in build["flags"] if f.startswith("-gencode")]
        link = subprocess.run([_nvcc(), *arch, "-shared", "-o", build["tmp"], *build["objs"]],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        log.write(link.stdout.decode(errors="replace"))
        rcs.append(link.returncode)
    log.close()
    for obj in build["objs"]:
        if os.path.exists(obj):
            os.remove(obj)
    if any(rcs):
        with open(out[:-3] + ".log") as f:
            raise RuntimeError(f"nvcc failed ({rcs}):\n{f.read()}")
    os.replace(build["tmp"], out)
    return out


def build() -> float:
    """Build the library if needed; returns the wall seconds."""
    t0 = time.perf_counter()
    finish_build(*start_build())
    return time.perf_counter() - t0


def start_variant_build(fmad: bool, min_blocks: int):
    """start_build of a tuning variant of the library: FMA contraction and
    MK_MIN_BLOCKS replaced. Load the result with use_library."""
    return start_build(_flags(fmad, min_blocks))


def build_log(lib_path: str | None = None) -> str:
    """nvcc's output of the last build of the library at lib_path (default:
    the one load() uses), with ptxas' register and spill counts; "" when
    the library was reused."""
    path = (lib_path or library_path())[:-3] + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _demangle(name: str) -> str:
    """A kernel's mangled name as name<args> (its bool and int template
    arguments: 1 / 0 for a flag)."""
    m = re.match(r"_Z(\d+)", name)
    if not m:
        return name
    n = int(m.group(1))
    base = name[m.end():m.end() + n]
    args = re.match(r"I((?:L[bi]\d+E)+)E", name[m.end() + n:])
    return f"{base}<{','.join(re.findall(r'L[bi](\d+)E', args.group(1)))}>" if args else base


def ptxas_report(log: str) -> list:
    """Per kernel entry in a build log (nvcc -Xptxas -v): (kernel, registers,
    spill store bytes, spill load bytes), in the log's order."""
    rows, cur, props, spill = [], None, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur, spill = m.group(1), (0, 0)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur and props == cur:  # the entry's own, not a callee's
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            rows.append((_demangle(cur), int(m.group(1)), *spill))
            cur = None
    return rows


def check_inputs(*tensors):
    """Raise unless the tensors a kernel reads through raw pointers are
    contiguous and on one device."""
    if any(t.device != tensors[0].device or not t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous and on one device")


def load() -> ctypes.CDLL:
    """The megakernel library, built if needed. The sources are hashed once
    per process, not on every launch."""
    global _lib
    if _lib is None:
        _lib = open_library(finish_build(*start_build()))
    return _lib


def use_library(lib):
    """Make the wrappers launch lib, the path of a built library (a tuning
    variant, or another checkout's from start_tree_build) or a library
    that use_library returned, and return the one they launched before
    (None: load() builds this tree's at the next launch)."""
    global _lib
    prev, _lib = _lib, open_library(lib) if isinstance(lib, str) else lib
    return prev


def start_tree_build(tree: str) -> subprocess.Popen:
    """Build the library of another checkout of the repository (unpacked
    with git archive; its own sources, flags and build directory) in a
    process of its own; finish_tree_build waits for it."""
    code = ("from cuda_pt_torch.ops import cuda_build as cb; "
            "print(cb.finish_build(*cb.start_build()))")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    return subprocess.Popen([sys.executable, "-c", code], cwd=tree, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_tree_build(proc: subprocess.Popen) -> str:
    """The library path of a start_tree_build (its build log beside it)."""
    out = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"the other tree's build failed:\n{out[-4000:]}")
    return out.strip().splitlines()[-1]


def open_library(path: str) -> ctypes.CDLL:
    """Load a built library and declare the C signatures of its entry
    points. Another checkout's library may lack some of this tree's entry
    points, or take other arguments at one; its caller declares that one."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return lib
