"""The CUDA megakernel's source built as host C++ and held to its plain
PyTorch version on the CPU.

csrc/megakernel.cu runs only on a card, but its arithmetic is plain C++:
with a small header that maps the CUDA built-ins it uses onto the C++
library (device qualifiers, float4, __ldg, rsqrtf, the u32 -> f32 convert)
and each <<<launch>>> rewritten as a loop over the grid's threads, g++
builds its translation units into a host library with the same C entry
points. FMA
contraction is off, as in the nvcc build (ops/cuda_build._flags). These
tests hold that library to trace_megakernel_reference lane by lane on
small scenes of every template instantiation, so a fault in the kernel's
logic shows here before a card sees it. The card itself is exercised by
tests/test_torch_cuda.py and chip_smoke.py. The media scenes run the MED
instantiations (kernel K4) against the fused volume path tracer, and
kernel K1 (csrc/traverse.cu) runs its per-ray form, closest and any hit,
in f32 and bf16 rows (its packet form votes across a block's threads and
runs on a card only).

Skips where no g++ is installed. Contract: allclose(rtol 1e-4, atol 1e-5)
on >= 98 % of lanes, image means within 5e-3."""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core.config import MaxDepthParams
from cuda_pt_torch.ops import cuda_build as cb
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec

_SHIM = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __restrict__
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
inline float4 __ldg(const float4* p) { return *p; }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline float __uint2float_rn(unsigned x) { return (float)x; }
inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
enum { cudaErrorInvalidValue = 1 };
// the persistent grid (csrc/persist.cuh) on a warp of one thread: a card of
// one SM that holds one block, the work counter's atomics as plain updates
#define PERSIST_WARP 1
#define MK_HOST_BUILD  // no shared memory or bulk copy: no STAGE build
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidConfiguration = 9, cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
    *n = 1;
    return cudaSuccess;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int atomicAdd(int* p, int v) { int old = *p; *p += v; return old; }
inline int atomicExch(int* p, int v) { int old = *p; *p = v; return old; }
inline void __threadfence() {}
// the tile vote of K1's packet form, which runs on a card only: the host
// loop runs a block's threads one after another
inline int __syncthreads_or(int p) { return p; }
// the warp votes and shared memory of the sorted-lane walk (csrc/walk.cuh),
// and a warp's shuffle and barrier, on a warp of one thread: a block's static __shared__ array is one array that the host
// loop's threads index one after another
#define __shared__
inline int __any_sync(unsigned, int p) { return p; }
inline unsigned __ballot_sync(unsigned, int p) { return p ? 1u : 0u; }
template <class T> inline T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
inline void __syncwarp(unsigned = 0xffffffffu) {}
struct HostDim { int x; };
static HostDim blockIdx, blockDim, threadIdx;
using std::isfinite; using std::min; using std::max;
"""

SCENES = {
    "cornell": lambda: t_ts.cornell_box(16, 16),
    "glass": lambda: t_ts.cornell_box(16, 16, tall_box_bsdf=BSDFSpec(
        btype=TT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)),
    "gold": lambda: t_ts.cornell_box(16, 16, tall_box_bsdf=BSDFSpec(
        btype=TT.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444), k=(3.983, 2.386, 1.603),
        roughness_x=0.2, roughness_y=0.2)),
    "plastic": lambda: t_ts.cornell_box(16, 16, tall_box_bsdf=BSDFSpec(
        btype=TT.BSDF_PLASTIC, k_d=(0.1, 0.3, 0.65), k_s=(1, 1, 1), ior=1.5, thickness=0.2)),
    "rough_glass": lambda: t_ts.cornell_box(16, 16, tall_box_bsdf=BSDFSpec(
        btype=TT.BSDF_GGX_DIELECTRIC, k_s=(0.95, 0.95, 0.95), ior=1.5, roughness_x=0.25,
        roughness_y=0.25)),
    "lights": lambda: t_ts.cornell_box_lights(16, 16),
    "oren_nayar_forward": lambda: t_ts.oren_nayar_forward(16, 16),
    "spot": lambda: t_ts.spot_light(16, 16),
    "furnace": lambda: t_ts.furnace(16, 16),
    "textured_floor": lambda: t_ts.textured_floor(16, 16),
    "kitchen_small": lambda: t_ts.kitchen_stress(16, 16, grid=2, ns=6, nt=4),
}


# kernels S2-S4 (csrc/extract_ab.cu, lanegather.cu, mxuleaf.cu) cooperate
# across a block's threads or a warp's lanes every step (a tile vote, shared
# memory, shuffles, mma.sync), which a loop over the threads one after
# another cannot run: test_torch_cuda.py and chip_smoke.py hold them on a card
CARD_ONLY = {"extract_ab.cu", "lanegather.cu", "mxuleaf.cu"}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source as host C++")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "cuda_runtime.h").write_text(_SHIM)
    launches = 0
    for name in os.listdir(cb.CSRC):  # every host-runnable source, launches rewritten
        if name in CARD_ONLY:
            continue
        with open(os.path.join(cb.CSRC, name)) as f:
            src = f.read()
        src, n = re.subn(
            r"(\w+(?:<[^<>]*>)?)<<<[^>]*>>>\(([^;]*)\);",
            lambda m: ("for (int b_ = 0; b_ < blocks; ++b_) for (int t_ = 0; t_ < threads; ++t_) "
                       "{ blockIdx.x = b_; threadIdx.x = t_; blockDim.x = threads; "
                       f"{m.group(1)}({m.group(2)}); }}"), src, flags=re.S)
        launches += n
        (d / (name[:-3] + "_host.cpp" if name.endswith(".cu") else name)).write_text(src)
    # the trace, closest-hit, segment, traverse, K1 and S1 launches, and the
    # two of the sorted-lane walk's check entry (f32 and compact tables)
    assert launches == 8
    defines = [f for f in cb._flags() if f.startswith("-D")]
    out = d / "libmegakernel_host.so"
    host_units = [str(d / (os.path.basename(u)[:-3] + "_host.cpp")) for u in cb.units()
                  if os.path.basename(u) not in CARD_ONLY]
    # one g++ per unit, all started together, then the link
    flags = ["-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", f"-I{d}", *defines]
    objs = [u[:-4] + ".o" for u in host_units]
    procs = [subprocess.Popen([gxx, *flags, "-c", u, "-o", o], stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for u, o in zip(host_units, objs)]
    for u, p in zip(host_units, procs):
        err = p.communicate()[1]
        assert p.returncode == 0, f"{u}: {err[-4000:]}"
    res = subprocess.run([gxx, "-shared", "-fPIC", *objs, "-o", str(out)], capture_output=True,
                         text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    lib = ctypes.CDLL(str(out))  # the entry points of the host-runnable units
    for name, argtypes in cb._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    assert not hasattr(lib, "s2_extract_ab") and hasattr(lib, "s1_node_bench")
    return lib


# kernel K4 (the MED instantiations): vpt packs of media scenes
MEDIA_SCENES = {
    "medium_box": lambda: t_ts.medium_box(16, 16),
    "cornell_vpt": lambda: t_ts.cornell_vpt(16, 16),
    "nested_media": lambda: t_ts.nested_media(16, 16),
    "medium_box_env": lambda: t_ts.medium_box(16, 16, env_scale=0.5),
}


def _host_trace(lib, pack, md, o, d, rng, nee_m, expect=None):
    L = torch.empty_like(o)
    rng32 = t_mk.rng_bits(rng)  # held: the call reads it through a raw pointer
    variant = ctypes.c_int(-1)
    rc = lib.mk_trace(t_mk._tables(pack), o.data_ptr(), d.data_ptr(),
                      rng32.data_ptr(), L.data_ptr(), None, o.shape[0],
                      *t_mk.walk_args(pack), int(pack.has_env), int(pack.textured),
                      int(pack.has_disp), int(pack.all_families), int(pack.has_media),
                      pack.ambient_med, md.max_depth, md.max_diffuse, md.max_specular,
                      md.max_transmit, md.max_volume, nee_m, ctypes.byref(variant), None)
    assert rc == 0
    if expect is not None:
        assert t_mk.instantiation_name(variant.value) == expect
    return L


@pytest.mark.parametrize("kind", list(SCENES))
def test_host_kernel_matches_plain(host_lib, kind):
    scene, cam, _ = SCENES[kind]()
    pack = t_mk.make_pack(scene, node_fmt="w8")
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    md = MaxDepthParams()
    for nee_m in (1, 3):
        rng = t_qmc.make_state("pcg", 11, perm, nee_m)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        Lk = _host_trace(host_lib, pack, md, o, d, rng, nee_m)
        Lp = t_mk.trace_megakernel_reference(pack, md, o, d, rng, nee_m)
        assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
        close = torch.isclose(Lk, Lp, rtol=1e-4, atol=1e-5).all(dim=-1)
        assert float(close.float().mean()) >= 0.98, (kind, nee_m, float(close.float().mean()))
        assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


@pytest.mark.parametrize("kind", list(MEDIA_SCENES))
def test_host_kernel_media_matches_plain(host_lib, kind):
    """The MED instantiations (K4; K3 x MED with the envmap) against the
    fused volume path tracer, two passes at the default depth caps. Both
    sides take the same vpt pack: the plain version is trace_megakernel's
    own CPU branch, which the pack sends to the volume path tracer."""
    scene, cam, _ = MEDIA_SCENES[kind]()
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=True)
    assert pack.has_media and pack.has_env == (kind == "medium_box_env")
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    md = MaxDepthParams()
    for i in range(2):
        rng = t_qmc.make_state("pcg", 13, perm, i)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        expect = "K3+ALL+MED" if pack.has_env else "ALL+MED"
        Lk = _host_trace(host_lib, pack, md, o, d, rng, 1, expect)
        Lp = t_mk.trace_megakernel(pack, md, o, d, rng)
        assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
        close = torch.isclose(Lk, Lp, rtol=1e-4, atol=1e-5).all(dim=-1)
        assert float(close.float().mean()) >= 0.98, (kind, i, float(close.float().mean()))
        assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def test_host_walk_matches_skip_walk(host_lib):
    """mk_closest_hit (the w8 walk) against accel/traverse on kitchen."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    rs = np.random.default_rng(3)
    B = 2048
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(B, 3)).astype(np.float32)),
                                      dim=1)
    t = torch.empty(B)
    prim = torch.empty(B, dtype=torch.int32)
    b1, b2 = torch.empty(B), torch.empty(B)
    rc = host_lib.mk_closest_hit(t_mk._tables(pack), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                                 prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), B,
                                 *t_mk.walk_args(pack), None)
    assert rc == 0
    h = t_mk.closest_hit_plain(scene, o, d)
    np.testing.assert_array_equal(prim.long().numpy(), h["prim"].numpy())
    hit = h["hit"].numpy()
    np.testing.assert_allclose(t.numpy()[hit], h["t"].numpy()[hit], rtol=1e-6)


@pytest.mark.parametrize("fmts", [dict(), dict(prim_fmt="t9", attr_fmt="bf16")])
@pytest.mark.parametrize("kind", ["kitchen_small", "lights", "textured_floor"])
def test_host_sorted_walk_matches_skip_walk(host_lib, kind, fmts):
    """mk_closest_hit_sorted (the sorted-lane walk of csrc/walk.cuh alone:
    the short stack, 128-bit node loads, the phase votes) against the skip
    walk on rays from inside the scene's box: prim ids equal; t, prims and
    barycentrics bit-equal to the w8 walk's (mk_closest_hit: the same visit
    order); the stack's most entries within the pack's walk stack."""
    scene, _, _ = SCENES[kind]()
    pack = t_mk.make_pack(scene, node_fmt="w8", **fmts)
    rs = np.random.default_rng(23)
    B = 2048
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(B, 3)).astype(np.float32)),
                                      dim=1)
    outs = {}
    for entry in ("mk_closest_hit", "mk_closest_hit_sorted"):
        t = torch.empty(B)
        prim = torch.empty(B, dtype=torch.int32)
        b1, b2 = torch.empty(B), torch.empty(B)
        depth = torch.zeros(B, dtype=torch.int32)
        extra = [depth.data_ptr()] if entry.endswith("sorted") else []
        rc = getattr(host_lib, entry)(t_mk._tables(pack), o.data_ptr(), d.data_ptr(),
                                      t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
                                      b2.data_ptr(), *extra, B, *t_mk.walk_args(pack), None)
        assert rc == 0
        outs[entry] = (t, prim, b1, b2, depth)
    h = t_mk.closest_hit_plain(scene, o, d)
    t, prim, b1, b2, depth = outs["mk_closest_hit_sorted"]
    np.testing.assert_array_equal(prim.long().numpy(), h["prim"].numpy())
    hit = h["hit"].numpy()
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(t.numpy()[hit], h["t"].numpy()[hit], rtol=1e-6)
    for a, b in zip((t, prim, b1, b2), outs["mk_closest_hit"][:4]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(depth.min()) >= 1 and int(depth.max()) <= pack.max_stack


def test_sorted_walk_wrapper_runs_plain_on_cpu():
    """closest_hit_sorted on CPU tensors is closest_hit_plain (no stack
    depth) and launches nothing; a binary pack raises."""
    scene, _, _ = SCENES["kitchen_small"]()
    pack = t_mk.make_pack(scene, node_fmt="w8")
    rs = np.random.default_rng(29)
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (512, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(512, 3)).astype(np.float32)),
                                      dim=1)
    t_mk.reset_launches()
    t, prim, b1, b2, depth = t_mk.closest_hit_sorted(pack, o, d)
    h = t_mk.closest_hit_plain(scene, o, d)
    assert depth is None and t_mk.LAUNCHES["closest_hit_sorted"] == 0
    assert torch.equal(prim, h["prim"]) and torch.equal(t, h["t"])
    with pytest.raises(ValueError, match="w8"):
        t_mk.closest_hit_sorted(t_mk.make_pack(scene, node_fmt="f32"), o, d)


# ---------------------------------------------------------------------------
# kernels K5 (the segment kernel, SEG and SHADE forms) and K6 (the traverse
# kernel) under the sorted-wavefront driver
# ---------------------------------------------------------------------------


def _host_driver(monkeypatch, lib, launched: set):
    """Point trace_megakernel_swf's kernel route at the host library: its
    segment and traverse steps call mk_trace_seg and mk_traverse_resolve on
    CPU tensors, recording the instantiations launched."""

    def seg(pack, md, st, n, bounce, nee_m=1, hit=None, flight=None, stats=None):
        variant = ctypes.c_int(-1)
        rc = lib.mk_trace_seg(
            t_mk._tables(pack), st.data_ptr(), st.shape[1], n, bounce,
            hit.data_ptr() if hit is not None else None,
            flight.data_ptr() if flight is not None else None, None, *t_mk.walk_args(pack),
            int(pack.has_env), int(pack.textured), int(pack.has_disp),
            int(pack.all_families), int(pack.has_media), int(pack.has_grid), pack.ambient_med, md.max_depth, md.max_diffuse, md.max_specular, md.max_transmit,
            md.max_volume, nee_m, ctypes.byref(variant), None)
        assert rc == 0
        launched.add(t_mk.instantiation_name(variant.value))

    def walk(pack, st, n, trav=None, stats=None):
        out = _host_traverse_resolve(lib, pack, st, n, trav)
        launched.add("K6")
        return out

    monkeypatch.setattr(t_mk, "trace_megakernel_seg", seg)
    monkeypatch.setattr(t_mk, "traverse_resolve", walk)
    monkeypatch.setattr(t_mk, "_check_rays", lambda *a: None)


def grid_smoke_dispersion(width: int, height: int, device="cpu"):
    """grid_smoke with a dispersive glass sphere beside the cube: a grid
    pack with has_disp, the split driver's K3 shade instantiation."""
    _, cam, b = t_ts.grid_smoke(width, height, device=device)
    glass = b.add_bsdf(BSDFSpec(btype=TT.BSDF_DISPERSION, k_s=(0.99, 0.99, 0.99),
                                cauchy_a=1.5046, cauchy_b=0.0042))
    b.add_sphere((1.5, -0.7, -0.9), 0.5, glass)
    return b.compile(device=device), cam, b


SEG_SCENES = {
    # name: (scene, vpt pack, the segment instantiation it runs); a grid
    # pack takes the split driver: K6 and the SHADE form
    "cornell": (lambda: t_ts.cornell_box(16, 16), False, "SEG+K2"),
    "glass": (SCENES["glass"], False, "SEG+K2"),
    "furnace": (SCENES["furnace"], False, "SEG+K3"),
    "textured_floor": (SCENES["textured_floor"], False, "SEG+K3"),
    "kitchen_small": (SCENES["kitchen_small"], False, "SEG+K3+ALL"),
    "gold": (SCENES["gold"], False, "SEG+ALL"),
    "medium_box": (MEDIA_SCENES["medium_box"], True, "SEG+ALL+MED"),
    "medium_box_env": (MEDIA_SCENES["medium_box_env"], True, "SEG+K3+ALL+MED"),
    "nested_media": (MEDIA_SCENES["nested_media"], True, "SEG+ALL+MED"),
    "grid_smoke": (lambda: t_ts.grid_smoke(12, 12), True, "SEG+SHADE+ALL+MED+GRID"),
    "grid_smoke_dispersion": (lambda: grid_smoke_dispersion(12, 12), True,
                              "SEG+SHADE+K3+ALL+MED+GRID"),
}


@pytest.mark.parametrize("kind", list(SEG_SCENES))
def test_host_segment_kernel_matches_plain(host_lib, monkeypatch, kind):
    """The driver on the host-built K5 (and K6 in its split form) against
    the same driver on the plain versions, default depth caps, key
    "pos_dir": the phase-4 contract, and the instantiation expected."""
    make, vpt, expect = SEG_SCENES[kind]
    scene, cam, _ = make()
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    rng = t_qmc.make_state("pcg", 17, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    Lp = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    launched = set()
    _host_driver(monkeypatch, host_lib, launched)
    Lk = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir", plain=False)
    assert launched == ({expect, "K6"} if pack.has_grid else {expect})
    assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
    close = torch.isclose(Lk, Lp, rtol=1e-4, atol=1e-5).all(dim=-1)
    assert float(close.float().mean()) >= 0.98, (kind, float(close.float().mean()))
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def _host_traverse_resolve(lib, pack, st, n, trav=None):
    """mk_traverse_resolve (K6) of the host library on CPU tensors -> the
    hit planes; trav ((4, n)): the walk's (t, gid, u, v) planes too."""
    hit = torch.empty((t_mk.hit_planes(pack), n))
    ghit = pack["g_hit"]
    rc = lib.mk_traverse_resolve(t_mk._tables(pack), ghit.data_ptr(), t_mk._nbytes(ghit),
                                 st.data_ptr(), st.shape[1], n, hit.data_ptr(),
                                 trav.data_ptr() if trav is not None else None, None,
                                 *t_mk.walk_args(pack), int(pack.textured), int(pack.has_media),
                                 None)
    assert rc == 0
    return hit


def _k6_state(pack, scene, n: int, seed: int):
    """State planes of n random rays from inside the scene's bounds, every
    fifth lane dead."""
    rs = np.random.default_rng(seed)
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32)),
                                      dim=1)
    st = t_mk.seg_init(pack, o, d, torch.zeros((n, 2), dtype=torch.int64))
    st.view(torch.float32)[t_mk.S_ACT, ::5] = 0.0
    return st


def test_host_traverse_matches_plain(host_lib):
    """mk_traverse_resolve's (t, gid, u, v) output (K6) against
    traverse_plain on kitchen: prim ids equal, a dead lane reports no
    hit."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    n = 2048
    st = _k6_state(pack, scene, n, 5)
    out = torch.empty((4, n))
    _host_traverse_resolve(host_lib, pack, st, n, out)
    ref = t_mk.traverse_plain(pack, st, n)
    np.testing.assert_array_equal(out[1].numpy(), ref[1].numpy())
    assert (out[1, ::5] == -1).all() and (out[1] >= 0).float().mean() > 0.2
    hit = ref[1] >= 0
    np.testing.assert_allclose(out[0][hit].numpy(), ref[0][hit].numpy(), rtol=1e-6)


K6_SCENES = {
    # name: (scene, vpt pack, the optional hit planes it carries)
    "grid_smoke": (lambda: t_ts.grid_smoke(16, 16, n=16), True, "medium"),
    "kitchen_small": (lambda: t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4), False, "uv"),
    "furnace": (lambda: t_ts.furnace(8, 8), False, "sphere"),
}


@pytest.mark.parametrize("kind", list(K6_SCENES))
def test_host_traverse_resolve_matches_resolve_hit(host_lib, kind):
    """K6 with the hit resolve in the kernel: its hit planes bit-equal to
    resolve_hit of the same launch's (t, gid, u, v) output, on hits, misses
    and dead lanes; prim ids equal to traverse_plain's, t within rtol
    1e-6. grid_smoke carries the medium planes, small kitchen the uv
    planes, furnace's sphere the sphere flag and the centre normal."""
    make, vpt, extra = K6_SCENES[kind]
    scene = make()[0]
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    assert (pack.has_media, pack.textured, not pack.tri_only) == (
        extra == "medium", extra == "uv", extra == "sphere")
    n = 1024
    st = _k6_state(pack, scene, n, 23)
    trav = torch.empty((4, n))
    hit = _host_traverse_resolve(host_lib, pack, st, n, trav)
    want = t_mk.resolve_hit(pack, trav)
    assert hit.shape == want.shape == (t_mk.hit_planes(pack), n)
    assert torch.equal(hit.view(torch.int32), want.view(torch.int32))
    ref = t_mk.traverse_plain(pack, st, n)
    assert torch.equal(trav[1], ref[1])
    found = ref[1] >= 0
    np.testing.assert_allclose(trav[0][found].numpy(), ref[0][found].numpy(), rtol=1e-6)
    assert (trav[1, ::5] == -1).all() and 0.1 < float(found.float().mean()) < 0.79
    if extra == "sphere":
        sph = t_mk.hit_planes(pack) - 2  # the sphere flag, then bid
        assert bool((hit[sph][found] > 0.5).any())
    plain = t_mk.traverse_resolve(pack, st, n)  # CPU tensors: the plain version
    assert torch.equal(plain.view(torch.int32), t_mk.resolve_hit(pack, ref).view(torch.int32))


# ---------------------------------------------------------------------------
# kernel K1 (csrc/traverse.cu), its per-ray form
# ---------------------------------------------------------------------------


def _host_k1(lib, forest, o, d, t_far, occlusion: bool, max_leaf: int = 4):
    n = o.shape[0]
    prim = torch.empty(n, dtype=torch.int32)
    t, b1, b2 = torch.empty(n), torch.empty(n), torch.empty(n)
    stats = torch.zeros((n, 2), dtype=torch.int32)
    rc = lib.k1_traverse(
        forest.nodes.data_ptr(), forest.prims.data_ptr(), forest.n_nodes.data_ptr(),
        forest.nodes.shape[0], forest.nodes.shape[1], forest.prims.shape[1], o.data_ptr(),
        d.data_ptr(), t_far.data_ptr() if t_far is not None else None, n, max_leaf,
        int(occlusion), int(forest.node_fmt == "bf16"), 0,
        None if occlusion else t.data_ptr(), prim.data_ptr(),
        None if occlusion else b1.data_ptr(), None if occlusion else b2.data_ptr(), None,
        stats.data_ptr(), None)
    assert rc == 0
    return t, prim.long(), b1, b2, stats


@pytest.mark.parametrize("node_fmt", ["f32", "bf16"])
def test_host_k1_matches_plain(host_lib, node_fmt):
    """k1_traverse's per-ray form on a four-chunk forest of small kitchen
    against traverse_forest_reference: closest hit (prim ids equal, t, b1,
    b2 within 1 ulp) and any hit (occlusion equal), in f32 and bf16 rows;
    the stats plane counts a fetch per node and a test per prim."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64,
                                      node_fmt=node_fmt)
    forest = scene.forest
    assert forest.num_chunks == 4
    rs = np.random.default_rng(9)
    n = 1024
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32)),
                                      dim=1)
    t_far = torch.as_tensor(rs.uniform(0.05, 6.0, n).astype(np.float32))
    t, prim, b1, b2, stats = _host_k1(host_lib, forest, o, d, None, False)
    ref = tk.traverse_forest_reference(forest, o, d)
    np.testing.assert_array_equal(prim.numpy(), ref["prim"].numpy())
    hit = ref["hit"].numpy()
    assert 0.2 < hit.mean() < 1.0 and (stats[:, 0] > 0).all()
    for got, want in ((t, ref["t"]), (b1, ref["b1"]), (b2, ref["b2"])):
        ulps = np.abs(got.numpy()[hit].view(np.int32).astype(np.int64)
                      - want.numpy()[hit].view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, ulps.max()
    _, occ, _, _, _ = _host_k1(host_lib, forest, o, d, t_far, True)
    ref_occ = tk.traverse_forest_reference(forest, o, d, t_far, occlusion=True)["occluded"]
    np.testing.assert_array_equal((occ >= 0).numpy(), ref_occ.numpy())
    assert 0.05 < ref_occ.float().mean() < 0.95


# ---------------------------------------------------------------------------
# the persistent grid of K2-K4 (csrc/persist.cuh): on the host shim a launch
# is one block of 128 threads run one after another, so its first thread
# takes every path in turn, each starting from the state the last one left
# behind; and K1's per-ray form, batch against single rays
# ---------------------------------------------------------------------------


def _host_trace_stats(lib, pack, md, o, d, rng):
    L = torch.empty_like(o)
    stats = torch.full((o.shape[0], 2), -1, dtype=torch.int32)
    rng32 = t_mk.rng_bits(rng)
    rc = lib.mk_trace(t_mk._tables(pack), o.data_ptr(), d.data_ptr(), rng32.data_ptr(),
                      L.data_ptr(), stats.data_ptr(), o.shape[0], *t_mk.walk_args(pack),
                      int(pack.has_env), int(pack.textured), int(pack.has_disp),
                      int(pack.all_families), int(pack.has_media), pack.ambient_med,
                      md.max_depth, md.max_diffuse, md.max_specular, md.max_transmit,
                      md.max_volume, 1, None, None)
    assert rc == 0
    return L, stats


REGEN_SCENES = {
    "cornell": (SCENES["cornell"], False),
    "glass": (SCENES["glass"], False),
    "gold": (SCENES["gold"], False),
    "kitchen_small": (SCENES["kitchen_small"], False),
    "medium_box": (MEDIA_SCENES["medium_box"], True),
}


@pytest.mark.parametrize("kind", list(REGEN_SCENES))
def test_host_persistent_kernel_regenerates_paths(host_lib, kind):
    """One launch of 256 paths, all traced by one host thread after one
    another, against each path launched alone: L and the stats plane (node
    fetches, prim tests) bit-equal per lane, so no per-path variable
    survives into the next path; L against the plain version under the
    phase-4 contract."""
    make, vpt = REGEN_SCENES[kind]
    scene, cam, _ = make()
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    rng = t_qmc.make_state("pcg", 31, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    L, stats = _host_trace_stats(host_lib, pack, md, o, d, rng)
    assert o.shape[0] == 256 and bool((stats[:, 0] > 0).all())
    for k in range(o.shape[0]):
        Lk, sk = _host_trace_stats(host_lib, pack, md, o[k:k + 1], d[k:k + 1], rng[k:k + 1])
        assert torch.equal(Lk.view(torch.int32), L[k:k + 1].view(torch.int32)), (kind, k)
        assert torch.equal(sk, stats[k:k + 1]), (kind, k)
    _hold(L, t_mk.trace_megakernel_reference(pack, md, o, d, rng), kind)


@pytest.mark.parametrize("occlusion", [False, True])
def test_host_k1_batch_matches_single_rays(host_lib, occlusion):
    """K1's per-ray form on a four-chunk forest of small kitchen: one launch
    of 512 rays against each ray launched alone: t, prim, b1, b2 and the
    stats plane bit-equal per ray; prim ids (closest) or occlusion (any
    hit) equal to the plain version."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64)
    forest = scene.forest
    rs = np.random.default_rng(37)
    n = 512
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (n, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32)),
                                      dim=1)
    t_far = torch.as_tensor(rs.uniform(0.05, 6.0, n).astype(np.float32)) if occlusion else None
    batch = _host_k1(host_lib, forest, o, d, t_far, occlusion)
    for k in range(n):
        one = _host_k1(host_lib, forest, o[k:k + 1], d[k:k + 1],
                       t_far[k:k + 1] if occlusion else None, occlusion)
        fields = (1, 4) if occlusion else range(5)
        for f in fields:
            assert torch.equal(one[f].view(torch.int32) if one[f].is_floating_point() else one[f],
                               batch[f][k:k + 1].view(torch.int32)
                               if batch[f].is_floating_point() else batch[f][k:k + 1]), (k, f)
    ref = tk.traverse_forest_reference(forest, o, d, t_far, occlusion=occlusion)
    if occlusion:
        np.testing.assert_array_equal((batch[1] >= 0).numpy(), ref["occluded"].numpy())
        assert 0.05 < float(ref["occluded"].float().mean()) < 0.95
    else:
        np.testing.assert_array_equal(batch[1].numpy(), ref["prim"].numpy())
        assert 0.2 < float(ref["hit"].float().mean()) < 1.0


# ---------------------------------------------------------------------------
# the reference's compact and binary pack formats in the same kernels
# ---------------------------------------------------------------------------

FORMAT_CASES = {
    # name: (scene, vpt pack, make_pack's formats)
    "cornell_bin_f32": (SCENES["cornell"], False, dict(node_fmt="f32")),
    "cornell_bin_bf16_t9_attr_bf16": (SCENES["cornell"], False,
                                      dict(node_fmt="bf16", prim_fmt="t9", attr_fmt="bf16")),
    "kitchen_bin_bf16_t9_attr_bf16": (SCENES["kitchen_small"], False,
                                      dict(node_fmt="bf16", prim_fmt="t9", attr_fmt="bf16")),
    "kitchen_w8_t9_attr_bf16": (SCENES["kitchen_small"], False,
                                dict(node_fmt="w8", prim_fmt="t9", attr_fmt="bf16")),
    "medium_box_bin_f32_attr_bf16": (MEDIA_SCENES["medium_box"], True,
                                     dict(node_fmt="f32", attr_fmt="bf16")),
    "medium_box_w8_t9_attr_bf16": (MEDIA_SCENES["medium_box"], True,
                                   dict(node_fmt="w8", prim_fmt="t9", attr_fmt="bf16")),
}


def _hold(Lk, Lp, label):
    assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
    close = torch.isclose(Lk, Lp, rtol=1e-4, atol=1e-5).all(dim=-1)
    assert float(close.float().mean()) >= 0.98, (label, float(close.float().mean()))
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


@pytest.mark.parametrize("kind", list(FORMAT_CASES))
def test_host_pack_formats_match_plain(host_lib, monkeypatch, kind):
    """Binary f32 and bf16 nodes, t9 prims and bf16 attrs through the
    whole-path kernel (mk_trace) and through the driver on K5's segment
    form (mk_trace_seg), each against its plain version on the same pack
    (bf16 attrs: the scene's normals truncated to bf16) under the phase-4
    contract; a binary pack runs the BIN instantiations, a w8 pack with t9
    prims or bf16 attrs the CPT ones."""
    make, vpt, fmts = FORMAT_CASES[kind]
    scene, cam, _ = make()
    pack = t_mk.make_pack(scene, vpt=vpt, **fmts)
    assert (pack.node_fmt, pack.prim_fmt, pack.attr_fmt) == (
        fmts["node_fmt"], fmts.get("prim_fmt", "f32"), fmts.get("attr_fmt", "f32"))
    suffix = "+BIN" if pack.node_fmt != "w8" else "+CPT"
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    rng = t_qmc.make_state("pcg", 19, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    variant = ctypes.c_int(-1)
    Lk = torch.empty_like(o)
    rng32 = t_mk.rng_bits(rng)
    rc = host_lib.mk_trace(t_mk._tables(pack), o.data_ptr(), d.data_ptr(), rng32.data_ptr(),
                           Lk.data_ptr(), None, o.shape[0], *t_mk.walk_args(pack),
                           int(pack.has_env), int(pack.textured), int(pack.has_disp),
                           int(pack.all_families), int(pack.has_media), pack.ambient_med,
                           md.max_depth, md.max_diffuse, md.max_specular, md.max_transmit,
                           md.max_volume, 1, ctypes.byref(variant), None)
    assert rc == 0
    assert t_mk.instantiation_name(variant.value).endswith(suffix)
    _hold(Lk, t_mk.trace_megakernel_reference(pack, md, o, d, rng), f"{kind} whole path")
    Lp = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    launched = set()
    _host_driver(monkeypatch, host_lib, launched)
    Lk = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir", plain=False)
    assert launched and all(name.startswith("SEG") and name.endswith(suffix) for name in launched)
    _hold(Lk, Lp, f"{kind} segment form")


def test_host_bf16_attrs_plain_scene_truncates_normals():
    """The plain version of a bf16-attr pack renders normals cut to their
    high 16 bits (tk._pack2's truncation, not round-to-nearest), and the
    image differs from the f32 pack's."""
    scene, cam, _ = SCENES["kitchen_small"]()
    pack = t_mk.make_pack(scene, node_fmt="w8", attr_fmt="bf16")
    n0 = t_mk.pack_scene(pack).geom.n0
    bits = scene.geom.n0.view(torch.int32) & -65536
    assert torch.equal(n0.view(torch.int32), bits)
    assert not torch.equal(n0, scene.geom.n0.to(torch.bfloat16).float())


def test_host_binary_walk_matches_k1(host_lib):
    """mk_closest_hit on binary packs (f32 and bf16 rows, t9 prims) against
    kernel K1's per-ray form over the scene's BVH as one chunk, both built
    here: prim ids equal on every ray, t bit-equal in f32 rows."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    scene, _, _ = SCENES["kitchen_small"]()
    forest = tk.single_chunk_forest(scene.geom, scene.bvh)
    rs = np.random.default_rng(21)
    B = 2048
    lo, hi = scene.bvh.node_min[0].numpy(), scene.bvh.node_max[0].numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(B, 3)).astype(np.float32)),
                                      dim=1)
    t1, p1, _, _, _ = _host_k1(host_lib, forest, o, d, None, False)
    for fmts in (dict(node_fmt="f32"), dict(node_fmt="bf16", prim_fmt="t9")):
        pack = t_mk.make_pack(scene, **fmts)
        t = torch.empty(B)
        prim = torch.empty(B, dtype=torch.int32)
        b1, b2 = torch.empty(B), torch.empty(B)
        rc = host_lib.mk_closest_hit(t_mk._tables(pack), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                                     prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), B,
                                     *t_mk.walk_args(pack), None)
        assert rc == 0
        np.testing.assert_array_equal(prim.long().numpy(), p1.numpy())
        hit = p1 >= 0
        assert 0.2 < float(hit.float().mean()) < 1.0
        np.testing.assert_array_equal(t[hit].numpy(), t1[hit].numpy())


def test_host_node_bench_bit_equal(host_lib):
    """Kernel S1 (s1_node_bench) against its plain version on cornell's
    binary f32 rows, bit for bit: the reference's rays (every ray equal)
    and random rays, 200 steps (past the rows' end, so the walk wraps)."""
    from cuda_pt_torch.ops import node_bench as nb
    from cuda_pt_torch.ops import traverse_kernel as tk

    scene, _, _ = SCENES["cornell"]()
    nodes = torch.as_tensor(tk.pack_nodes(scene.bvh))
    o, d = nb.reference_rays(64)
    rs = np.random.default_rng(23)
    o = torch.cat([o, torch.as_tensor(rs.uniform(0.05, 0.95, (64, 3)).astype(np.float32))])
    d = torch.cat([d, torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(64, 3)).astype(np.float32)), dim=1)]).contiguous()
    out = torch.empty(o.shape[0])
    rc = host_lib.s1_node_bench(nodes.data_ptr(), nodes.shape[0] * tk.SLOTS, 200, o.data_ptr(),
                                d.data_ptr(), out.data_ptr(), o.shape[0], None)
    assert rc == 0
    ref = nb.node_bench_reference(nodes, o, d, 200)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (out[:64] == out[0]).all() and float(out[0]) != 0.0


# ---- kernels S2-S4 (card only): their wrappers and plain versions on the CPU


def _s2_node_rows(slots: list) -> torch.Tensor:
    """Binary f32 node rows from (lo, hi, skip, count) per slot, 8 per row."""
    rows = np.zeros((len(slots) // 8, 128), np.float32)
    for k, (lo, hi, skip, cnt) in enumerate(slots):
        rows.reshape(-1, 16)[k, :9] = [*lo, *hi, skip, 0, cnt]
    return torch.as_tensor(rows)


def _diag_rays():
    """128 equal rays from the origin along (1, 1, 1) / sqrt(3)."""
    d = np.full((128, 3), 1.0 / np.sqrt(3.0), np.float32)
    return torch.zeros((128, 3)), torch.as_tensor(d)


def test_extract_ab_w2_second_slot_wraps_in_its_row():
    """w2's second slot is (slot + 1) % 8 of the same row, as the
    reference's (sb + SLOT_F) % 128 is: walking slots 0-7 of row 0, the
    step at slot 7 adds slot 0's box (hit at tn = 1 * inv) and not slot 8's
    (the next row's, hit at 5 * inv), and with it slot 7's own tn (-3 *
    inv: the second box's hit counts as the step's); v0 adds slot 0 once."""
    from cuda_pt_torch.ops import extract_ab as ab

    hit = lambda a: ((a, a, a), (a + 1, a + 1, a + 1))  # noqa: E731
    miss = ((-3.0,) * 3, (-2.5,) * 3)  # behind the ray: tf < 0
    slots = [(*hit(1.0), 1, 1)]  # a leaf: the walk goes to its skip
    slots += [(*miss, k + 1, 0) for k in range(1, 7)] + [(*miss, 15, 0)]
    slots += [(*hit(5.0), 9, 0)] + [(*miss, 0, 0)] * 7
    o, d = _diag_rays()
    inv = np.float32(1.0) / d[0, 0].numpy()
    w2 = ab.extract_ab("w2", _s2_node_rows(slots), o, d, 8, tile=128)
    v0 = ab.extract_ab("v0", _s2_node_rows(slots), o, d, 8, tile=128)
    np.testing.assert_allclose(w2.numpy(), (1.0 + 1.0 - 3.0) * inv, rtol=1e-6)
    np.testing.assert_allclose(v0.numpy(), 1.0 * inv, rtol=1e-6)
    slots[8] = (*hit(7.0), 9, 0)  # the next row's first slot is not read
    assert torch.equal(ab.extract_ab("w2", _s2_node_rows(slots), o, d, 8, tile=128), w2)


def test_extract_ab_e3_reads_lo_x_for_every_axis():
    """e3 takes a node's lo_x as the box minimum on all three axes and
    steps ptr + 1 on a tile hit, ptr + 2 otherwise: its output moves with
    lo_x only."""
    from cuda_pt_torch.ops import extract_ab as ab

    o, d = _diag_rays()
    slots = [((2.0, 3.0, 4.0), (5.0, 5.0, 5.0), 1, 0)] + [((9.0,) * 3, (9.0,) * 3, 0, 0)] * 7
    e3 = ab.extract_ab("e3", _s2_node_rows(slots), o, d, 1, tile=128)
    np.testing.assert_allclose(e3.numpy(), 2.0 / d[0, 0].numpy(), rtol=1e-6)
    slots[0] = ((2.0, -7.0, 11.0), (0.0, 0.0, 0.0), 1, 0)
    assert torch.equal(ab.extract_ab("e3", _s2_node_rows(slots), o, d, 1, tile=128), e3)
    slots[0] = ((3.0, 3.0, 4.0), (5.0, 5.0, 5.0), 1, 0)
    assert not torch.equal(ab.extract_ab("e3", _s2_node_rows(slots), o, d, 1, tile=128), e3)


def test_microkernel_wrappers_check_their_inputs():
    """The wrappers' shape and type checks raise on the CPU as on the card;
    the contiguity and device check of the kernel path raises too."""
    from cuda_pt_torch.ops import extract_ab as ab
    from cuda_pt_torch.ops import lanegather as lg
    from cuda_pt_torch.ops import mxuleaf as mx

    nodes = torch.zeros((4, 128))
    o, d = _diag_rays()
    with pytest.raises(ValueError, match="tile"):
        ab.extract_ab("v0", nodes, o, d, 2, tile=96)
    with pytest.raises(ValueError, match="tile"):
        ab.extract_ab("v0", nodes, o[:100], d[:100], 2, tile=128)
    with pytest.raises(ValueError, match="node rows"):
        ab.extract_ab("v0", nodes[:, :64], o, d, 2, tile=128)
    with pytest.raises(ValueError, match="unknown tag"):
        ab.extract_ab("v3", nodes, o, d, 2, tile=128)
    with pytest.raises(ValueError, match="pointers"):
        ab.extract_ab("v0_ilp4", torch.zeros((2, 128)), o, d, 2, tile=128)
    x, row, idx = lg.make_inputs(0, 2)
    with pytest.raises(ValueError, match="idx"):
        lg.lanegather("g1", x, row, idx.long())
    with pytest.raises(ValueError, match="row"):
        lg.gather(row[:, :64], idx)
    with pytest.raises(ValueError, match="x"):
        lg.lanegather("g1", x[:1], row, idx)
    with pytest.raises(ValueError, match="unknown tag"):
        lg.lanegather("g2", x, row, idx)
    inp = mx.make_inputs(0, 1, 2)
    with pytest.raises(ValueError, match="coefficient rows"):
        mx.leaf_min_t("mxu", inp["prow"], inp["o"], inp["d"])
    with pytest.raises(ValueError, match="leaf rows"):
        mx.leaf_min_t("scalar", inp["coef"], inp["o"], inp["d"])
    with pytest.raises(ValueError, match="multiple of 128"):
        mx.leaf_min_t("scalar", inp["prow"], inp["o"][:64], inp["d"][:64])
    with pytest.raises(ValueError, match="unknown form"):
        mx.leaf_min_t("mxu_2xtf32", inp["coef"], inp["o"], inp["d"])
    with pytest.raises(ValueError, match="contiguous"):
        cb.check_inputs(inp["o"], inp["coef"].t())
    cb.check_inputs(inp["o"], inp["d"], inp["coef"])


@pytest.mark.parametrize("entry", ["extract_ab", "lanegather", "mxuleaf"])
def test_microkernel_entries_run_plain_on_cpu(entry):
    """On CPU tensors each entry runs its plain version and launches no
    kernel: main(--device cpu) prints the reference's rows with no time;
    the public functions equal the plain versions."""
    import importlib

    mod = importlib.import_module(f"cuda_pt_torch.ops.{entry}")
    t_mk.reset_launches()
    argv = {"extract_ab": ["--scene", "cornell", "--iters", "6"],
            "lanegather": ["--rows", "2", "--iters", "8"],
            "mxuleaf": ["--rows", "1", "--nleaf", "8"]}[entry]
    rows = mod.main(["--device", "cpu", *argv])
    assert t_mk.LAUNCHES[entry] == 0
    timed = [r for r in rows if any(k in r for k in ("c_node_ns", "per_iter_ns", "sec"))]
    assert timed and all(r.get("c_node_ns", r.get("per_iter_ns", r.get("sec"))) is None
                         for r in timed)
    if entry == "extract_ab":
        assert all(r["match_v0"] for r in rows if r.get("variant") in ("v1", "v2"))
    elif entry == "lanegather":
        assert {"check": "gather_bit_exact", "ok": True} in rows
    else:
        parity = next(r for r in rows if r.get("check") == "parity")
        assert parity["agree_frac"] == 1.0 and parity["hitmask_match"] == 1.0


def test_microkernel_make_inputs_are_the_scripts():
    """make_inputs draws the scripts' arrays: exp_lanegather.py's x, row,
    idx and exp_r5_mxuleaf.py's rays, prim rows and coefficients (their
    code, at R = 2 and NLEAF = 3)."""
    from cuda_pt_torch.ops import lanegather as lg
    from cuda_pt_torch.ops import mxuleaf as mx

    rs = np.random.default_rng(0)
    x = rs.normal(size=(2, 128)).astype(np.float32)
    row = rs.normal(size=(1, 128)).astype(np.float32)
    idx = rs.integers(0, 128, size=(2, 128)).astype(np.int32)
    for a, b in zip(lg.make_inputs(0, 2), (x, row, idx)):
        np.testing.assert_array_equal(a.numpy(), b)
    R, NLEAF, NP8 = 2, 3, 8
    rs = np.random.default_rng(0)
    o_np = rs.uniform(-1, 1, (R, 128, 3)).astype(np.float32)
    d_np = rs.normal(size=(R, 128, 3)).astype(np.float32)
    d_np /= np.linalg.norm(d_np, axis=-1, keepdims=True)
    M = NLEAF * NP8
    a_np = rs.uniform(-1, 1, (M, 3)).astype(np.float32)
    e1_np = rs.uniform(-0.5, 0.5, (M, 3)).astype(np.float32)
    e2_np = rs.uniform(-0.5, 0.5, (M, 3)).astype(np.float32)
    prow = np.zeros((NLEAF, 128), np.float32)
    prow[:, :NP8 * 9] = np.concatenate([a_np, e1_np, e2_np], -1).reshape(NLEAF, NP8 * 9)
    n_np = np.cross(e1_np, e2_np)
    coef = np.zeros((M, 4, 16), np.float32)
    coef[:, 0, 3:6] = -n_np
    coef[:, 1, 0:3] = e2_np
    coef[:, 1, 3:6] = np.cross(a_np, e2_np)
    coef[:, 2, 0:3] = -e1_np
    coef[:, 2, 3:6] = np.cross(e1_np, a_np)
    coef[:, 3, 6:9] = n_np
    coef[:, 3, 9] = -np.sum(a_np * n_np, -1)
    inp = mx.make_inputs(0, R, NLEAF)
    np.testing.assert_array_equal(inp["o"].numpy(), o_np.reshape(-1, 3))
    np.testing.assert_array_equal(inp["d"].numpy(), d_np.reshape(-1, 3))
    np.testing.assert_array_equal(inp["prow"].numpy(), prow)
    np.testing.assert_array_equal(inp["coef"].numpy(), coef.reshape(NLEAF * 32, 16))
