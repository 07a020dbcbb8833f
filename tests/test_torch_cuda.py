"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA (marker ``cuda``) and skips where
torch.cuda.is_available() is false. The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda

Per-lane contract: allclose(rtol=1e-4, atol=1e-5) on all three channels,
with at most 2 % of lanes differing."""

import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig
from cuda_pt_torch.ops import intersect as t_isect
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene

pytestmark = pytest.mark.cuda

SPECS = {
    "white": None,
    "mirror": BSDFSpec(btype=TT.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95)),
    "glass": BSDFSpec(btype=TT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lanes_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((~torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)).float().mean())


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("nee_m", [1, 4])
def test_kernel_matches_plain(cuda, kind, nee_m):
    scene, cam, _ = t_ts.cornell_box(64, 64, tall_box_bsdf=SPECS[kind], device=cuda)
    pack = t_mk.make_pack(scene)
    perm, _ = t_mk.tile_swizzle(64, 64, cuda)
    rng = t_qmc.make_state("pcg", 3, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    n0 = t_mk.LAUNCHES["trace_megakernel"]
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_m)
    torch.cuda.synchronize()
    assert t_mk.LAUNCHES["trace_megakernel"] == n0 + 1
    Lp = t_mk.trace_megakernel_reference(scene, md, o, d, rng, nee_candidates=nee_m)
    assert torch.isfinite(Lk).all()
    assert _lanes_differing(Lk, Lp) <= 0.02


@pytest.mark.parametrize("nee_m", [1, 4])
def test_kernel_matches_plain_multi_light(cuda, nee_m):
    """Area light, point light, emissive box: the kernel's emitter and
    emitter-prim pick against the plain version's."""
    scene, cam, _ = t_ts.cornell_box_lights(64, 64, device=cuda)
    pack = t_mk.make_pack(scene)
    perm, _ = t_mk.tile_swizzle(64, 64, cuda)
    rng = t_qmc.make_state("pcg", 4, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_m)
    Lp = t_mk.trace_megakernel_reference(scene, md, o, d, rng, nee_candidates=nee_m)
    assert torch.isfinite(Lk).all()
    assert _lanes_differing(Lk, Lp) <= 0.02
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def test_walk_matches_brute_force(cuda):
    scene, _, _ = t_ts.cornell_box(8, 8, device=cuda)
    rs = np.random.default_rng(6)
    o = torch.as_tensor(rs.uniform(0.05, 0.95, (8192, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rs.normal(size=(8192, 3)).astype(np.float32), device=cuda), dim=1)
    t, prim, _, _ = t_mk.closest_hit_w8(t_mk.make_pack(scene), o, d)
    h = t_isect.closest_hit_brute(scene.geom, o, d)
    differ = prim != h["prim"]
    torch.testing.assert_close(t[~differ], h["t"][~differ], rtol=1e-6, atol=0)
    # only exact ties may differ: the walk's prim is also at the brute minimum
    t_all, _, _, _ = t_isect.intersect_gather(scene.geom, o, d,
                                              *t_isect.all_prims(scene.geom, 8192))
    t_walk_prim = torch.gather(t_all, 1, prim.clamp(min=0)[:, None])[:, 0]
    assert torch.equal(t_walk_prim[differ], h["t"][differ])


def test_renderer_cuda_matches_cpu(cuda):
    scene, cam, _ = t_ts.cornell_box(32, 24)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=24,
                                                     md=MaxDepthParams(max_depth=6)))
    r = Renderer(parsed)  # device=None -> cuda
    img_k = r.render(2)
    img_p = Renderer(parsed, device="cpu").render(2)
    assert r.info()["device"].startswith("cuda") and np.isfinite(img_k).all()
    assert np.isclose(img_k, img_p, rtol=1e-4, atol=1e-5).mean() > 0.98
