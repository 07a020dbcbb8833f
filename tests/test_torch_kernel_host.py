"""The CUDA megakernel's source built as host C++ and held to its plain
PyTorch version on the CPU.

csrc/megakernel.cu runs only on a card, but its arithmetic is plain C++:
with a small header that maps the CUDA built-ins it uses onto the C++
library (device qualifiers, float4, __ldg, rsqrtf, the u32 -> f32 convert)
and each <<<launch>>> rewritten as a loop over the grid's threads, g++
builds it into a host library with the same C entry points. FMA
contraction is off, as in the nvcc build (ops/cuda_build._flags). These
tests hold that library to trace_megakernel_reference lane by lane on
small scenes of every template instantiation, so a fault in the kernel's
logic shows here before a card sees it. The card itself is exercised by
tests/test_torch_cuda.py and chip_smoke.py.

Skips where no g++ is installed. Contract: allclose(rtol 1e-4, atol 1e-5)
on >= 98 % of lanes, image means within 5e-3."""

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
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CUDA source as host C++")
    d = tmp_path_factory.mktemp("host_kernel")
    (d / "cuda_runtime.h").write_text(_SHIM)
    with open(os.path.join(cb.CSRC, "megakernel.cu")) as f:
        src = f.read()
    src, n = re.subn(
        r"(\w+(?:<[^<>]*>)?)<<<[^>]*>>>\(([^;]*)\);",
        lambda m: ("for (int b_ = 0; b_ < blocks; ++b_) for (int t_ = 0; t_ < threads; ++t_) "
                   "{ blockIdx.x = b_; threadIdx.x = t_; blockDim.x = threads; "
                   f"{m.group(1)}({m.group(2)}); }}"), src, flags=re.S)
    assert n == 2  # the trace and closest-hit launches
    (d / "megakernel_host.cpp").write_text(src)
    defines = [f for f in cb._flags() if f.startswith("-D")]
    out = d / "libmegakernel_host.so"
    res = subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC",
                          f"-I{d}", f"-I{cb.CSRC}", *defines, str(d / "megakernel_host.cpp"),
                          "-o", str(out)], capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return cb.open_library(str(out))


def _host_trace(lib, pack, md, o, d, rng, nee_m):
    L = torch.empty_like(o)
    rng32 = t_mk.rng_bits(rng)  # held: the call reads it through a raw pointer
    rc = lib.mk_trace(t_mk._tables(pack), o.data_ptr(), d.data_ptr(),
                      rng32.data_ptr(), L.data_ptr(), None, o.shape[0],
                      pack.max_leaf, int(pack.tri_only), int(pack.has_env), int(pack.textured),
                      int(pack.has_disp), int(pack.all_families), md.max_depth, md.max_diffuse,
                      md.max_specular, md.max_transmit, nee_m, None)
    assert rc == 0
    return L


@pytest.mark.parametrize("kind", list(SCENES))
def test_host_kernel_matches_plain(host_lib, kind):
    scene, cam, _ = SCENES[kind]()
    pack = t_mk.make_pack(scene)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    md = MaxDepthParams()
    for nee_m in (1, 3):
        rng = t_qmc.make_state("pcg", 11, perm, nee_m)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        Lk = _host_trace(host_lib, pack, md, o, d, rng, nee_m)
        Lp = t_mk.trace_megakernel_reference(scene, md, o, d, rng, nee_m)
        assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
        close = torch.isclose(Lk, Lp, rtol=1e-4, atol=1e-5).all(dim=-1)
        assert float(close.float().mean()) >= 0.98, (kind, nee_m, float(close.float().mean()))
        assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def test_host_walk_matches_skip_walk(host_lib):
    """mk_closest_hit (the w8 walk) against accel/traverse on kitchen."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    pack = t_mk.make_pack(scene)
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
                                 prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), B, pack.max_leaf,
                                 int(pack.tri_only), None)
    assert rc == 0
    h = t_mk.closest_hit_plain(scene, o, d)
    np.testing.assert_array_equal(prim.long().numpy(), h["prim"].numpy())
    hit = h["hit"].numpy()
    np.testing.assert_allclose(t.numpy()[hit], h["t"].numpy()[hit], rtol=1e-6)
