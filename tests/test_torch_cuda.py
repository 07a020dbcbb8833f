"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs CUDA (marker ``cuda``) and skips where
torch.cuda.is_available() is false. The file imports no JAX, so it runs on
a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py --noconftest -o addopts="" -m cuda

Per-lane contract: allclose(rtol=1e-4, atol=1e-5) on all three channels,
with at most 2 % of lanes differing. The media tests hold kernel K4 (the
volume path tracer's MED instantiations) to the same contract, and the
sorted-wavefront tests kernel K5 (the segment kernel, under
trace_megakernel_swf) and K6 (the traverse kernel of its split form); the
forest tests kernel K1 (ops/traverse_kernel.traverse_forest), prim ids
and occlusion equal to its plain version and t bit-equal."""

import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.ops import intersect as t_isect
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.ops import traverse_kernel as t_tk
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene

pytestmark = pytest.mark.cuda

SPECS = {
    "white": None,
    "mirror": BSDFSpec(btype=TT.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95)),
    "glass": BSDFSpec(btype=TT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5),
    "gold": BSDFSpec(btype=TT.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444),
                     k=(3.983, 2.386, 1.603), roughness_x=0.2, roughness_y=0.2),
    "plastic": BSDFSpec(btype=TT.BSDF_PLASTIC, k_d=(0.1, 0.3, 0.65), k_s=(1.0, 1.0, 1.0),
                        ior=1.5, thickness=0.2),
    "rough_glass": BSDFSpec(btype=TT.BSDF_GGX_DIELECTRIC, k_s=(0.95, 0.95, 0.95), ior=1.5,
                            roughness_x=0.25, roughness_y=0.25),
}
# scenes of the K3 envelope and the remaining families: (builder, spp)
K3_SCENES = {
    "oren_nayar_forward": lambda dev: t_ts.oren_nayar_forward(32, 32, device=dev),
    "spot": lambda dev: t_ts.spot_light(32, 32, device=dev),
    "furnace": lambda dev: t_ts.furnace(32, 32, device=dev),
    "textured_floor": lambda dev: t_ts.textured_floor(32, 32, device=dev),
    "kitchen_small": lambda dev: t_ts.kitchen_stress(32, 32, grid=2, ns=6, nt=4, device=dev),
}
# kernel K4 (the MED instantiations): vpt packs of media scenes
MEDIA_SCENES = {
    "medium_box": lambda dev: t_ts.medium_box(48, 48, device=dev),
    "cornell_vpt": lambda dev: t_ts.cornell_vpt(48, 48, device=dev),
    "nested_media": lambda dev: t_ts.nested_media(48, 48, device=dev),
    "medium_box_env": lambda dev: t_ts.medium_box(48, 48, env_scale=0.5, device=dev),
}


def grid_smoke_dispersion(width: int, height: int, device="cpu"):
    """grid_smoke with a dispersive glass sphere beside the cube: a grid
    pack with has_disp, the split driver's K3 shade instantiation."""
    _, cam, b = t_ts.grid_smoke(width, height, device=device)
    glass = b.add_bsdf(BSDFSpec(btype=TT.BSDF_DISPERSION, k_s=(0.99, 0.99, 0.99),
                                cauchy_a=1.5046, cauchy_b=0.0042))
    b.add_sphere((1.5, -0.7, -0.9), 0.5, glass)
    return b.compile(device=device), cam, b


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stage(pack) -> str:
    """The name suffix of the whole-path kernel's STAGE build where the
    pack's tables fit in shared memory (ops/megakernel.stages)."""
    return "+STAGE" if t_mk.stages(pack) else ""


def _lanes_differing(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((~torch.isclose(a, b, rtol=1e-4, atol=1e-5).all(dim=-1)).float().mean())


@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("nee_m", [1, 4])
def test_kernel_matches_plain(cuda, kind, nee_m):
    scene, cam, _ = t_ts.cornell_box(64, 64, tall_box_bsdf=SPECS[kind], device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    perm, _ = t_mk.tile_swizzle(64, 64, cuda)
    rng = t_qmc.make_state("pcg", 3, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    n0 = t_mk.LAUNCHES["trace_megakernel"]
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_m)
    torch.cuda.synchronize()
    assert t_mk.LAUNCHES["trace_megakernel"] == n0 + 1
    Lp = t_mk.trace_megakernel_reference(pack, md, o, d, rng, nee_candidates=nee_m)
    assert torch.isfinite(Lk).all()
    assert _lanes_differing(Lk, Lp) <= 0.02


@pytest.mark.parametrize("kind", list(K3_SCENES))
def test_kernel_matches_plain_k3_envelope(cuda, kind):
    """The K3 flags (envmap, diffuse textures, dispersion), Oren-Nayar,
    Forward and the area-spot cone: kernel vs its plain version."""
    scene, cam, _ = K3_SCENES[kind](cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height, cuda)
    rng = t_qmc.make_state("pcg", 5, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng)
    Lp = t_mk.trace_megakernel_reference(pack, md, o, d, rng)
    assert torch.isfinite(Lk).all()
    assert _lanes_differing(Lk, Lp) <= 0.02
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3 * max(1.0, abs(float(Lp.mean())))


@pytest.mark.parametrize("nee_m", [1, 4])
def test_kernel_matches_plain_multi_light(cuda, nee_m):
    """Area light, point light, emissive box: the kernel's emitter and
    emitter-prim pick against the plain version's."""
    scene, cam, _ = t_ts.cornell_box_lights(64, 64, device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    perm, _ = t_mk.tile_swizzle(64, 64, cuda)
    rng = t_qmc.make_state("pcg", 4, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_m)
    Lp = t_mk.trace_megakernel_reference(pack, md, o, d, rng, nee_candidates=nee_m)
    assert torch.isfinite(Lk).all()
    assert _lanes_differing(Lk, Lp) <= 0.02
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def test_walk_matches_brute_force(cuda):
    scene, _, _ = t_ts.cornell_box(8, 8, device=cuda)
    rs = np.random.default_rng(6)
    o = torch.as_tensor(rs.uniform(0.05, 0.95, (8192, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rs.normal(size=(8192, 3)).astype(np.float32), device=cuda), dim=1)
    t, prim, _, _ = t_mk.closest_hit_w8(t_mk.make_pack(scene, node_fmt="w8"), o, d)
    h = t_isect.closest_hit_brute(scene.geom, o, d)
    differ = prim != h["prim"]
    torch.testing.assert_close(t[~differ], h["t"][~differ], rtol=1e-6, atol=0)
    # only exact ties may differ: the walk's prim is also at the brute minimum
    t_all, _, _, _ = t_isect.intersect_gather(scene.geom, o, d,
                                              *t_isect.all_prims(scene.geom, 8192))
    t_walk_prim = torch.gather(t_all, 1, prim.clamp(min=0)[:, None])[:, 0]
    assert torch.equal(t_walk_prim[differ], h["t"][differ])


@pytest.mark.parametrize("fmts", [dict(), dict(prim_fmt="t9", attr_fmt="bf16")])
def test_sorted_walk_matches_w8_walk(cuda, fmts):
    """The sorted-lane walk alone (closest_hit_sorted) on small kitchen,
    rays sorted by direction octant and origin as the driver sorts lanes and
    in random order: t, prim ids and barycentrics bit-equal to the w8 walk
    (the same visit order); the stack's most entries within the pack's
    walk stack; a binary pack raises."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8", **fmts)
    rs = np.random.default_rng(8)
    B = 8192
    lo, hi = scene.bvh.node_min[0].cpu().numpy(), scene.bvh.node_max[0].cpu().numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(
        torch.as_tensor(rs.normal(size=(B, 3)).astype(np.float32), device=cuda), dim=1)
    key = ((d > 0).long() * torch.tensor([4, 2, 1], device=cuda)).sum(1) * B + \
        torch.argsort(o[:, 0]).argsort()
    for order in (torch.argsort(key), torch.arange(B, device=cuda)):
        oo, dd = o[order].contiguous(), d[order].contiguous()
        t_mk.reset_launches()
        t, prim, b1, b2, depth = t_mk.closest_hit_sorted(pack, oo, dd)
        ref = t_mk.closest_hit_w8(pack, oo, dd)
        torch.cuda.synchronize()
        assert t_mk.LAUNCHES["closest_hit_sorted"] == 1
        for a, b in zip((t, prim, b1, b2), ref):
            assert torch.equal(a, b)
        assert 0.2 < float((prim >= 0).float().mean()) < 1.0
        assert int(depth.min()) >= 1 and int(depth.max()) <= pack.max_stack
    with pytest.raises(ValueError, match="w8"):
        t_mk.closest_hit_sorted(t_mk.make_pack(scene, node_fmt="f32"), o, d)


def test_renderer_cuda_matches_cpu(cuda):
    scene, cam, _ = t_ts.cornell_box(32, 24)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=24,
                                                     md=MaxDepthParams(max_depth=6)))
    r = Renderer(parsed)  # device=None -> cuda
    img_k = r.render(2)
    img_p = Renderer(parsed, device="cpu").render(2)
    assert r.info()["device"].startswith("cuda") and np.isfinite(img_k).all()
    assert np.isclose(img_k, img_p, rtol=1e-4, atol=1e-5).mean() > 0.98


@pytest.mark.parametrize("kind", list(MEDIA_SCENES))
def test_k4_matches_plain(cuda, kind):
    """Kernel K4 against the fused volume path tracer; the C side reports
    the MED instantiation it launched (K3 x MED with the envmap)."""
    scene, cam, _ = MEDIA_SCENES[kind](cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=True)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height, cuda)
    rng = t_qmc.make_state("pcg", 8, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    t_mk.reset_launches()
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng)
    torch.cuda.synchronize()
    name = ("K3+ALL+MED" if kind == "medium_box_env" else "ALL+MED") + _stage(pack)
    assert t_mk.LAUNCHES["trace_megakernel"] == 1 and t_mk.INSTANTIATION_LAUNCHES == {name: 1}
    Lp = t_mk.trace_megakernel_reference(pack, md, o, d, rng)
    assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
    assert _lanes_differing(Lk, Lp) <= 0.02
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


def test_vpt_renderer_cuda_matches_cpu(cuda):
    """Renderer(VOLUME_PT) on the card launches the MED instantiation and
    matches the same Renderer on the CPU."""
    scene, cam, _ = t_ts.nested_media(32, 24)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=24,
                                                     md=MaxDepthParams(max_depth=8)))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT)  # device=None -> cuda
    t_mk.reset_launches()
    img_k = r.render(2)
    assert t_mk.INSTANTIATION_LAUNCHES == {"ALL+MED" + _stage(r._pack): 2}
    assert r.info()["has_media"]
    img_p = Renderer(parsed, renderer=RendererType.VOLUME_PT, device="cpu").render(2)
    assert np.isfinite(img_k).all()
    assert np.isclose(img_k, img_p, rtol=1e-4, atol=1e-5).mean() > 0.98


def test_wrapper_branches_agree_on_media_scene(cuda):
    """A vpt pack of one media scene built on the card and on the CPU: the
    CUDA branch of trace_megakernel (the MED instantiation) and its CPU
    branch (the fused volume path tracer) agree per lane; without vpt the
    scene does not pack at all."""
    md = MaxDepthParams()
    out = {}
    for dev in (cuda, torch.device("cpu")):
        scene, cam, _ = t_ts.medium_box(48, 48, device=dev)
        with pytest.raises(ValueError, match="vpt=True"):
            t_mk.make_pack(scene, node_fmt="w8")
        pack = t_mk.make_pack(scene, node_fmt="w8", vpt=True)
        perm, _ = t_mk.tile_swizzle(cam.width, cam.height, dev)
        rng = t_qmc.make_state("pcg", 9, perm, 0)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        t_mk.reset_launches()
        out[dev.type] = t_mk.trace_megakernel(pack, md, o, d, rng).cpu()
        assert t_mk.INSTANTIATION_LAUNCHES == (
            {"ALL+MED" + _stage(pack): 1} if dev.type == "cuda" else {})
    assert torch.isfinite(out["cuda"]).all() and float(out["cpu"].mean()) > 0.01
    assert _lanes_differing(out["cuda"], out["cpu"]) <= 0.02
    assert abs(float(out["cuda"].mean()) - float(out["cpu"].mean())) < 5e-3


# kernel K5 under the sorted-wavefront driver: (scene, vpt pack, the
# segment instantiation launched); a grid pack takes the split form (K6 and
# the SHADE instantiations)
SEG_SCENES = {
    "cornell": (lambda dev: t_ts.cornell_box(48, 48, device=dev), False, "SEG+K2"),
    "kitchen_small": (K3_SCENES["kitchen_small"], False, "SEG+K3+ALL"),
    "textured_floor": (K3_SCENES["textured_floor"], False, "SEG+K3"),
    "medium_box_env": (MEDIA_SCENES["medium_box_env"], True, "SEG+K3+ALL+MED"),
    "nested_media": (MEDIA_SCENES["nested_media"], True, "SEG+ALL+MED"),
    "grid_smoke": (lambda dev: t_ts.grid_smoke(48, 48, device=dev), True,
                   "SEG+SHADE+ALL+MED+GRID"),
    "grid_smoke_dispersion": (lambda dev: grid_smoke_dispersion(48, 48, device=dev), True,
                              "SEG+SHADE+K3+ALL+MED+GRID"),
}


@pytest.mark.parametrize("kind", list(SEG_SCENES))
def test_k5_matches_plain(cuda, kind):
    """The driver on the kernels against the same driver on their plain
    versions (same rays, key "pos_dir"); the instantiations launched."""
    make, vpt, name = SEG_SCENES[kind]
    scene, cam, _ = make(cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height, cuda)
    rng = t_qmc.make_state("pcg", 12, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    t_mk.reset_launches()
    Lk = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    assert set(t_mk.INSTANTIATION_LAUNCHES) == {name}
    assert (t_mk.LAUNCHES["traverse_resolve"] > 0) == pack.has_grid
    assert t_mk.LAUNCHES["trace_megakernel"] == 0
    Lp = t_mk.trace_megakernel_swf_reference(pack, md, o, d, rng, key_mode="pos_dir")
    assert torch.isfinite(Lk).all() and float(Lp.mean()) > 0.01
    assert _lanes_differing(Lk, Lp) <= 0.02
    assert abs(float(Lk.mean()) - float(Lp.mean())) < 5e-3


@pytest.mark.parametrize("kind", ["cornell", "nested_media"])
def test_k5_matches_whole_path_kernel(cuda, kind):
    """On untextured scenes the driver on K5 and the whole-path kernel
    compute the same estimator lane for lane."""
    make, vpt, _ = SEG_SCENES[kind]
    scene, cam, _ = make(cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height, cuda)
    rng = t_qmc.make_state("pcg", 13, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    L_whole = t_mk.trace_megakernel(pack, md, o, d, rng)
    L_swf = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    assert float(L_whole.mean()) > 0.01
    assert _lanes_differing(L_swf, L_whole) <= 0.02


def test_k6_matches_plain_walk(cuda):
    """The traverse kernel's prim ids against the plain walk's on kitchen
    rays with every fifth lane dead (no hit there)."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=16, nt=12, device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    st, n = _k6_state(pack, scene, 16384, 6, cuda)
    t_mk.reset_launches()
    out = torch.empty((4, n), device=cuda)
    t_mk.traverse_resolve(pack, st, n, out)
    assert t_mk.LAUNCHES["traverse_resolve"] == 1
    ref = t_mk.traverse_plain(pack, st, n)
    assert torch.equal(out[1], ref[1]) and bool((out[1, ::5] == -1).all())


def _k6_state(pack, scene, n: int, seed: int, dev):
    """State planes of n random rays from inside the scene's bounds, every
    fifth lane dead -> (planes, n)."""
    rs = np.random.default_rng(seed)
    lo, hi = scene.bvh.node_min[0].cpu().numpy(), scene.bvh.node_max[0].cpu().numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (n, 3)).astype(np.float32), device=dev)
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32),
                                                      device=dev), dim=1)
    st = t_mk.seg_init(pack, o, d, torch.zeros((n, 2), dtype=torch.int64, device=dev))
    st.view(torch.float32)[t_mk.S_ACT, ::5] = 0.0
    return st, n


K6_SCENES = {
    # name: (scene, vpt pack, whether the kernel stages the tables)
    "grid_smoke": (lambda dev: t_ts.grid_smoke(16, 16, n=16, device=dev), True, True),
    "furnace": (lambda dev: t_ts.furnace(16, 16, device=dev), False, True),
    "kitchen_small": (lambda dev: t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, device=dev),
                      False, False),
}


@pytest.mark.parametrize("kind", list(K6_SCENES))
def test_k6_resolve_matches_resolve_hit(cuda, kind, monkeypatch):
    """K6 with the hit resolve in the kernel: its hit planes bit-equal to
    resolve_hit of its own (t, gid, u, v) output and to the same launch
    with the tables left in device memory (the table sizes withheld);
    prim ids equal to the plain walk's; the planes within the per-lane
    contract of resolve_hit(traverse_plain); the tables staged where
    k6_stages says."""
    make, vpt, staged = K6_SCENES[kind]
    scene = make(cuda)[0]
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=vpt)
    assert t_mk.k6_stages(pack) == staged
    st, n = _k6_state(pack, scene, 20000, 41, cuda)
    trav = torch.empty((4, n), device=cuda)
    hit = t_mk.traverse_resolve(pack, st, n, trav)
    torch.cuda.synchronize()
    assert torch.equal(hit.view(torch.int32), t_mk.resolve_hit(pack, trav).view(torch.int32))
    ref = t_mk.traverse_plain(pack, st, n)
    assert torch.equal(trav[1], ref[1]) and bool((trav[1, ::5] == -1).all())
    assert _lanes_differing(hit.T, t_mk.resolve_hit(pack, ref).T) <= 0.02
    real = t_mk._tables

    def unsized(p):
        t = real(p)
        for k in range(len(t) - len(t_mk.STAGE_KEYS), len(t)):
            t[k] = 0
        return t

    monkeypatch.setattr(t_mk, "_tables", unsized)
    again = t_mk.traverse_resolve(pack, st, n)
    torch.cuda.synchronize()
    assert torch.equal(again.view(torch.int32), hit.view(torch.int32))


def test_renderer_routes_as_the_reference(cuda):
    """The Renderer takes K5 on a scene of 512 boxes or more and the split
    driver (K6 + K5's shade phase) on grid_smoke, whose image matches the
    same Renderer on the CPU."""
    scene, cam, _ = t_ts.kitchen_stress(32, 24, grid=2, ns=16, nt=12)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=24, md=MaxDepthParams()))
    r = Renderer(parsed)
    t_mk.reset_launches()
    r.render(1)
    assert r.info()["driver"] == "swf" and set(t_mk.INSTANTIATION_LAUNCHES) == {"SEG+K3+ALL"}
    scene, cam, _ = t_ts.grid_smoke(32, 24)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=24,
                                                     md=MaxDepthParams(max_depth=6)))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT)
    t_mk.reset_launches()
    img_k = r.render(2)
    assert r.info()["driver"] == "swf_split" and t_mk.LAUNCHES["traverse_resolve"] > 0
    img_p = Renderer(parsed, renderer=RendererType.VOLUME_PT, device="cpu").render(2)
    assert np.isfinite(img_k).all() and img_k.mean() > 0.01
    assert np.isclose(img_k, img_p, rtol=1e-4, atol=1e-5).mean() > 0.98


def _forest_rays(scene, n: int, seed: int, dev):
    rs = np.random.default_rng(seed)
    lo, hi = scene.bvh.node_min[0].cpu().numpy(), scene.bvh.node_max[0].cpu().numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (n, 3)).astype(np.float32), device=dev)
    d = torch.nn.functional.normalize(torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32),
                                                      device=dev), dim=1)
    return o, d, torch.as_tensor(rs.uniform(0.05, 6.0, n).astype(np.float32), device=dev)


@pytest.mark.parametrize("node_fmt", ["f32", "bf16"])
def test_k1_matches_plain(cuda, node_fmt):
    """K1 per ray on a four-chunk forest of small kitchen: closest hit (prim
    ids equal, t, b1, b2 bit-equal), any hit (occlusion equal), the stats
    plane counting the walk; one launch each."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64,
                                      node_fmt=node_fmt, device=cuda)
    o, d, t_far = _forest_rays(scene, 8192, 3, cuda)
    t_mk.reset_launches()
    stats = torch.zeros((8192, 2), dtype=torch.int32, device=cuda)
    k = t_tk.traverse_forest(scene.forest, o, d, stats=stats)
    occ = t_tk.traverse_forest(scene.forest, o, d, t_far, occlusion=True)["occluded"]
    torch.cuda.synchronize()
    assert t_mk.LAUNCHES["traverse_forest"] == 2
    p = t_tk.traverse_forest_reference(scene.forest, o, d)
    for key in ("prim", "t", "b1", "b2"):
        assert torch.equal(k[key], p[key]), key
    assert torch.equal(occ, t_tk.traverse_forest_reference(scene.forest, o, d, t_far,
                                                           occlusion=True)["occluded"])
    assert 0.2 < float(p["hit"].float().mean()) < 1.0 and bool((stats[:, 0] > 0).all())


@pytest.mark.parametrize("occlusion", [False, True])
def test_k1_packet_form_counts_as_the_plain_version(cuda, occlusion):
    """The packet form (count_iters, tiles of 512 and of 256 rays, a ragged
    last tile): tile_iters and the per-ray results equal the plain
    version's packet walk, and the per-ray form's results."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64, device=cuda)
    o, d, t_far = _forest_rays(scene, 3000, 4, cuda)
    tf = t_far if occlusion else None
    key = "occluded" if occlusion else "prim"
    per_ray = t_tk.traverse_forest(scene.forest, o, d, tf, occlusion=occlusion)[key]
    for tile in (512, 256):
        k = t_tk.traverse_forest(scene.forest, o, d, tf, occlusion=occlusion, count_iters=True,
                                 tile=tile)
        p = t_tk.traverse_forest_reference(scene.forest, o, d, tf, occlusion=occlusion,
                                           count_iters=True, tile=tile)
        assert k["tile_iters"].shape == (-(-3000 // tile),)
        assert torch.equal(k["tile_iters"], p["tile_iters"]) and torch.equal(k[key], p[key])
        assert torch.equal(k[key], per_ray)


def test_k1_launch_error_raises(cuda, monkeypatch):
    """A launch the card refuses surfaces as an exception and counts no
    launch: the packet form's C entry handed a tile of 2048 threads per
    block (cudaErrorInvalidConfiguration), through the wrapper."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64, device=cuda)
    o, d, _ = _forest_rays(scene, 2048, 5, cuda)
    with pytest.raises(ValueError, match="multiple of 128"):
        t_tk.traverse_forest(scene.forest, o, d, count_iters=True, tile=2048)
    real = t_tk.cuda_build.load()

    class OversizedTile:
        def k1_traverse(self, *args):
            return real.k1_traverse(*args[:13], 2048, *args[14:])  # args[13] is the tile

    monkeypatch.setattr(t_tk.cuda_build, "load", OversizedTile)
    t_mk.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError"):
        t_tk.traverse_forest(scene.forest, o, d, count_iters=True, tile=1024)
    assert t_mk.LAUNCHES["traverse_forest"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()  # the refused launch left no fault behind
    assert t_tk.traverse_forest(scene.forest, o, d)["hit"].any()


def test_pallas_launches_k1_past_the_vmem_rule(cuda, monkeypatch):
    """On CUDA tensors traversal "pallas" walks a scene without a compiled
    forest on K1 even where the reference's scene_fits_vmem fails (a TPU
    limit): the BVH as one chunk, prim ids equal to the skip walk's; the
    Renderer packs that forest once, on its own copy of the scene."""
    monkeypatch.setattr(t_tk, "VMEM_BUDGET_BYTES", 0)
    scene, cam, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, device=cuda)
    o, d, t_far = _forest_rays(scene, 4096, 6, cuda)
    live = torch.ones(4096, dtype=torch.bool, device=cuda)
    want = t_pt.closest_hit(scene, o, d, live)
    scene.traversal = "pallas"
    t_mk.reset_launches()
    got = t_pt.closest_hit(scene, o, d, live)
    occ = t_pt.occluded(scene, o, d, t_far, live)
    assert t_mk.LAUNCHES["traverse_forest"] == 2 and torch.equal(got["prim"], want["prim"])
    scene.traversal = "xla"
    assert torch.equal(occ, t_pt.occluded(scene, o, d, t_far, live))
    scene.traversal = ""
    r = Renderer(ParsedScene(scene, cam, RenderingConfig(width=8, height=8)),
                 traversal="pallas")
    assert scene.forest is None and r.scene.forest.nodes.shape[0] == 1


def test_wavefront_renderer_cuda_matches_cpu(cuda):
    """Renderer(WAVEFRONT_PT, traversal="pallas") on the card (K1 for every
    closest and shadow walk, no other kernel) against the same Renderer on
    the CPU, 32x32, per lane."""
    scene, cam, _ = t_ts.kitchen_stress(32, 32, grid=2, ns=16, nt=12, forest_chunk=512)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=32, height=32,
                                                     md=MaxDepthParams(max_depth=6)))
    r = Renderer(parsed, renderer=RendererType.WAVEFRONT_PT, traversal="pallas")
    t_mk.reset_launches()
    img_k = r.render(2)
    launched = {k: v for k, v in t_mk.LAUNCHES.items() if v}
    assert set(launched) == {"traverse_forest"} and launched["traverse_forest"] <= 2 * 2 * 6
    img_p = Renderer(parsed, renderer=RendererType.WAVEFRONT_PT, traversal="pallas",
                     device="cpu").render(2)
    assert np.isfinite(img_k).all() and img_k.mean() > 0.01
    assert np.isclose(img_k, img_p, rtol=1e-4, atol=1e-5).all(axis=-1).mean() > 0.98


# ---------------------------------------------------------------------------
# the reference's binary and compact pack formats; kernel S1
# ---------------------------------------------------------------------------

FORMATS = {
    "bin_f32": dict(node_fmt="f32"),
    "bin_bf16": dict(node_fmt="bf16"),
    "w8_t9": dict(node_fmt="w8", prim_fmt="t9"),
    "w8_attr_bf16": dict(node_fmt="w8", attr_fmt="bf16"),
    "bin_bf16_t9_attr_bf16": dict(node_fmt="bf16", prim_fmt="t9", attr_fmt="bf16"),
}


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("kind", ["kitchen_small", "medium_box"])
def test_pack_formats_match_plain(cuda, kind, fmt):
    """Each table format through the whole-path kernel (K2 / K3, K4 on the
    media scene) and through the driver on K5, per lane against the plain
    versions on the same pack; a binary pack launches the BIN
    instantiations, a w8 pack with t9 prims or bf16 attrs the CPT ones."""
    vpt = kind == "medium_box"
    scene, cam, _ = (MEDIA_SCENES if vpt else K3_SCENES)[kind](cuda)
    pack = t_mk.make_pack(scene, vpt=vpt, **FORMATS[fmt])
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height, cuda)
    rng = t_qmc.make_state("pcg", 8, perm, 0)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = MaxDepthParams()
    t_mk.reset_launches()
    Lk = t_mk.trace_megakernel(pack, md, o, d, rng)
    Ls = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    suffix = "+BIN" if pack.node_fmt != "w8" else "+CPT"
    assert all(name.endswith(suffix) for name in t_mk.INSTANTIATION_LAUNCHES)
    for L, Lp in ((Lk, t_mk.trace_megakernel_reference(pack, md, o, d, rng)),
                  (Ls, t_mk.trace_megakernel_swf_reference(pack, md, o, d, rng,
                                                           key_mode="pos_dir"))):
        assert torch.isfinite(L).all()
        assert _lanes_differing(L, Lp) <= 0.02
        assert abs(float(L.mean()) - float(Lp.mean())) < 5e-3


def test_binary_walk_matches_k1(cuda):
    """The binary walk (closest_hit_w8 on binary f32 and bf16 packs) against
    K1's per-ray form over the BVH as one chunk: prim ids equal."""
    scene, _, _ = t_ts.kitchen_stress(32, 32, grid=2, ns=6, nt=4, device=cuda)
    forest = t_tk.single_chunk_forest(scene.geom, scene.bvh)
    rs = np.random.default_rng(4)
    lo, hi = scene.bvh.node_min[0].cpu().numpy(), scene.bvh.node_max[0].cpu().numpy()
    o = torch.as_tensor(rs.uniform(lo, hi, (8192, 3)).astype(np.float32), device=cuda)
    d = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(8192, 3)).astype(np.float32), device=cuda), dim=1).contiguous()
    k1 = t_tk.traverse_forest(forest, o, d)
    for node_fmt in ("f32", "bf16"):
        _, prim, _, _ = t_mk.closest_hit_w8(t_mk.make_pack(scene, node_fmt=node_fmt), o, d)
        assert torch.equal(prim, k1["prim"])


def test_grid_pack_with_binary_nodes_raises(cuda):
    """A grid pack takes the split driver, which needs a w8 pack (g_hit), as
    in the reference."""
    scene, cam, _ = t_ts.grid_smoke(16, 16, device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="f32", vpt=True)
    assert pack.has_grid and t_mk.driver_of(pack) == "swf_split"
    perm, _ = t_mk.tile_swizzle(16, 16, cuda)
    o, d, rng = t_cam.generate_rays(cam, perm, t_qmc.make_state("pcg", 1, perm, 0))
    with pytest.raises(ValueError, match="w8 pack"):
        t_mk.auto_trace(pack, MaxDepthParams(), o, d, rng)


def test_node_bench_bit_equal(cuda):
    """Kernel S1 against its plain version on cornell's binary f32 rows, bit
    for bit, on the reference's rays and on random rays; launches counted."""
    from cuda_pt_torch.ops import node_bench as t_nb

    scene, _, _ = t_ts.cornell_box(8, 8)
    nodes = torch.as_tensor(t_tk.pack_nodes(scene.bvh), device=cuda)
    o, d = t_nb.reference_rays(4096, cuda)
    rs = np.random.default_rng(6)
    o[2048:] = torch.as_tensor(rs.uniform(0.05, 0.95, (2048, 3)).astype(np.float32), device=cuda)
    d[2048:] = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(2048, 3)).astype(np.float32), device=cuda), dim=1)
    n0 = t_nb.LAUNCHES["node_bench"]
    out = t_nb.node_bench(nodes, o, d, 300)
    torch.cuda.synchronize()
    assert t_nb.LAUNCHES["node_bench"] == n0 + 1
    ref = t_nb.node_bench_reference(nodes, o, d, 300)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("n, iters", [(1, 301), (129, 300), (65537, 97), (129, 0)])
def test_node_bench_ragged_counts(cuda, n, iters):
    """Kernel S1 bit-equal to its plain version at ray counts that are no
    multiple of the block size or the unroll, odd step counts and 0 steps,
    on kitchen-small's rows (random rays, the first one the reference's)."""
    from cuda_pt_torch.ops import node_bench as t_nb

    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    nodes = torch.as_tensor(t_tk.pack_nodes(scene.bvh), device=cuda)
    lo, hi = scene.bvh.node_min[0].numpy() - 1.0, scene.bvh.node_max[0].numpy() + 1.0
    o, d = _s2_rays(1, n - 1, lo, hi, n, cuda)
    out = t_nb.node_bench(nodes, o, d, iters)
    ref = t_nb.node_bench_reference(nodes, o, d, iters)
    torch.cuda.synchronize()
    assert out.shape == (n,) and torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert (float(out[0]) != 0.0) == (iters > 0)


def _s2_rays(n_equal: int, n_random: int, lo, hi, seed: int, dev):
    """n_equal of the reference's equal rays, then n_random random rays with
    origins in [lo, hi] (some outside the scene's box) -> (o, d)."""
    from cuda_pt_torch.ops import node_bench as t_nb

    o, d = t_nb.reference_rays(n_equal, dev)
    rs = np.random.default_rng(seed)
    o_r = torch.as_tensor(rs.uniform(lo, hi, (n_random, 3)).astype(np.float32), device=dev)
    d_r = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_random, 3)).astype(np.float32), device=dev), dim=1)
    return torch.cat([o, o_r]).contiguous(), torch.cat([d, d_r]).contiguous()


def test_extract_ab_bit_equal(cuda):
    """Kernel S2, every tag against its plain version bit for bit on small
    kitchen's binary f32 rows: tiles of 256 lanes (one of equal rays, three
    of random rays) and of 2,048 and 8,192 random lanes (2 and 8 lanes per
    thread), 200 steps; v0 = v1 = v2 per lane, v0 on equal rays = S1."""
    from cuda_pt_torch.ops import extract_ab as t_ab
    from cuda_pt_torch.ops import node_bench as t_nb

    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    nodes = torch.as_tensor(t_tk.pack_nodes(scene.bvh), device=cuda)
    lo, hi = scene.bvh.node_min[0].numpy() - 1.0, scene.bvh.node_max[0].numpy() + 1.0
    cases = {256: _s2_rays(256, 768, lo, hi, 8, cuda), 2048: _s2_rays(0, 2048, lo, hi, 9, cuda),
             8192: _s2_rays(0, 8192, lo, hi, 10, cuda)}
    outs = {}
    for tag in t_ab.TAGS:
        for tile, (o, d) in cases.items():
            n0 = t_ab.LAUNCHES["extract_ab"]
            out = t_ab.extract_ab(tag, nodes, o, d, 200, tile)
            torch.cuda.synchronize()
            assert t_ab.LAUNCHES["extract_ab"] == n0 + 1
            ref = t_ab.extract_ab_reference(tag, nodes, o, d, 200, tile)
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), (tag, tile)
            outs[tag, tile] = out
    for tile in cases:
        assert torch.equal(outs["v0", tile], outs["v1", tile])
        assert torch.equal(outs["v0", tile], outs["v2", tile])
    o, d = cases[256]
    s1 = t_nb.node_bench(nodes, o[:256], d[:256], 200)
    assert torch.equal(outs["v0", 256][:256], s1) and float(s1[0]) != 0.0


def test_extract_ab_cluster_and_block_forms(cuda):
    """Kernel S2 on 8,192-lane tiles in each form the launch can take: a
    cluster of 8, 4 or 2 blocks per tile where the tiles times the size fit
    the SMs, else one block per tile (8 lanes per thread): every form's
    output bit-equal to the plain version, tags v0, v1, e3, w2 and
    v0_ilp2, 64 steps."""
    from cuda_pt_torch.ops import extract_ab as t_ab

    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    nodes = torch.as_tensor(t_tk.pack_nodes(scene.bvh), device=cuda)
    lo, hi = scene.bvh.node_min[0].numpy() - 1.0, scene.bvh.node_max[0].numpy() + 1.0
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    sizes = {}
    for tiles in (2, sms // 4, sms // 2 + 1):
        want = next((c for c in (8, 4, 2) if tiles * c <= sms), 1)
        sizes[tiles] = t_ab.cluster_size(tiles)
        assert sizes[tiles] == want, (tiles, sizes[tiles], want)
        o, d = _s2_rays(64, tiles * t_ab.TILE - 64, lo, hi, tiles, cuda)
        for tag in ("v0", "v1", "e3", "w2", "v0_ilp2"):
            out = t_ab.extract_ab(tag, nodes, o, d, 64)
            ref = t_ab.extract_ab_reference(tag, nodes, o, d, 64)
            torch.cuda.synchronize()
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32)), (tag, tiles)
    assert set(sizes.values()) >= {8, 1}


def test_lanegather_bit_equal(cuda):
    """Kernel S3, every tag against its plain version bit for bit at the
    reference's (64, 128) inputs, 64 iterations; the check gather against
    torch.take_along_dim; the shuffle forms equal the gather forms."""
    from cuda_pt_torch.ops import lanegather as t_lg

    x, row, idx = t_lg.make_inputs(0, 64, cuda)
    outs = {}
    for tag in t_lg.TAGS:
        n0 = t_lg.LAUNCHES["lanegather"]
        outs[tag] = t_lg.lanegather(tag, x, row, idx, 64)
        torch.cuda.synchronize()
        assert t_lg.LAUNCHES["lanegather"] == n0 + 1
        ref = t_lg.lanegather_reference(tag, x, row, idx, 64)
        assert torch.equal(outs[tag].view(torch.int32), ref.view(torch.int32)), tag
    for n in (1, 4, 14):
        assert torch.equal(outs[f"s{n}"], outs[f"g{n}"])
    g = t_lg.gather(row, idx)
    assert torch.equal(g, torch.take_along_dim(row.expand(64, 128), idx.long(), dim=1))


@pytest.mark.parametrize("rows", [1, 3, 8193])
def test_lanegather_gather_rows(cuda, rows):
    """Kernel S3's gather bit-equal to torch.take_along_dim at 1, 3 and 8,193
    rows (grids that end inside a block), on random idx and on idx of 0 and
    127 only; a misaligned idx is refused."""
    from cuda_pt_torch.ops import lanegather as t_lg

    _, row, idx = t_lg.make_inputs(rows, rows, cuda)
    edges = torch.where(idx < 64, 0, 127).to(torch.int32)
    for ix in (idx, edges):
        n0 = t_lg.LAUNCHES["lanegather"]
        g = t_lg.gather(row, ix)
        torch.cuda.synchronize()
        assert t_lg.LAUNCHES["lanegather"] == n0 + 1
        assert torch.equal(g, torch.take_along_dim(row.expand(rows, 128), ix.long(), dim=1))
    flat = torch.zeros(rows * 128 + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        t_lg.gather(row, flat[1:].view(rows, 128))


def test_mxuleaf_matches_plain(cuda):
    """Kernel S4 at 4,096 rays x 64 leaves: scalar bit-equal to its plain
    version; mxu (3xTF32) under the script's parity contract (agree and hit
    mask >= 0.999) against the plain product and against scalar; the
    1xTF32 A/B's hit mask >= 0.99."""
    from cuda_pt_torch.ops import mxuleaf as t_mx

    inp = t_mx.make_inputs(0, 32, 64, cuda)
    o, d = inp["o"], inp["d"]
    n0 = t_mx.LAUNCHES["mxuleaf"]
    t_s = t_mx.leaf_min_t("scalar", inp["prow"], o, d)
    t_m = t_mx.leaf_min_t("mxu", inp["coef"], o, d)
    t_1 = t_mx.leaf_min_t("mxu_1xtf32", inp["coef"], o, d)
    torch.cuda.synchronize()
    assert t_mx.LAUNCHES["mxuleaf"] == n0 + 3
    ref_s = t_mx.scalar_reference(inp["prow"], o, d)
    ref_m = t_mx.mxu_reference(inp["coef"], o, d)
    assert torch.equal(t_s.view(torch.int32), ref_s.view(torch.int32))
    assert 0.2 < float(torch.isfinite(t_s).float().mean()) < 1.0
    for other in (ref_m, t_s):
        p = t_mx.parity(other.cpu().numpy(), t_m.cpu().numpy())
        assert p["agree_frac"] >= 0.999 and p["hitmask_match"] >= 0.999, p
    assert t_mx.parity(ref_m.cpu().numpy(), t_1.cpu().numpy())["hitmask_match"] >= 0.99


def test_microkernel_launch_error_raises(cuda, monkeypatch):
    """A form the C entries do not build (S2 with 3 pointers, S3 with 5
    gathers, S4's form 3) is refused: the wrappers raise and count no
    launch."""
    from cuda_pt_torch.ops import extract_ab as t_ab
    from cuda_pt_torch.ops import lanegather as t_lg
    from cuda_pt_torch.ops import mxuleaf as t_mx

    real = t_tk.cuda_build.load()

    class Refused:
        def s2_extract_ab(self, variant, n_ptr, *args):
            return real.s2_extract_ab(variant, 3, *args)

        def s3_lanegather(self, kind, n_ops, *args):
            return real.s3_lanegather(kind, 5, *args)

        def s4_mxuleaf(self, form, *args):
            return real.s4_mxuleaf(3, *args)

        def s4_mxuleaf_scratch(self, nleaf):
            return real.s4_mxuleaf_scratch(nleaf)

    scene, _, _ = t_ts.cornell_box(8, 8)
    nodes = torch.as_tensor(t_tk.pack_nodes(scene.bvh), device=cuda)
    o, d = _s2_rays(256, 0, 0.0, 1.0, 0, cuda)
    x, row, idx = t_lg.make_inputs(0, 2, cuda)
    inp = t_mx.make_inputs(0, 1, 2, cuda)
    monkeypatch.setattr(t_tk.cuda_build, "load", Refused)
    t_mk.reset_launches()
    with pytest.raises(RuntimeError, match="cudaError"):
        t_ab.extract_ab("v0", nodes, o, d, 4, 256)
    with pytest.raises(RuntimeError, match="cudaError"):
        t_lg.lanegather("g1", x, row, idx, 4)
    with pytest.raises(RuntimeError, match="cudaError"):
        t_mx.leaf_min_t("mxu", inp["coef"], inp["o"], inp["d"])
    assert t_mk.LAUNCHES["extract_ab"] == t_mk.LAUNCHES["lanegather"] == 0
    assert t_mk.LAUNCHES["mxuleaf"] == 0
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert torch.equal(t_lg.lanegather("g1", x, row, idx, 4),
                       t_lg.lanegather_reference("g1", x, row, idx, 4))


# ---------------------------------------------------------------------------
# the persistent grid of K2 (csrc/persist.cuh): the work counter resets
# between launches; batches below a warp or not a multiple of 32; the STAGE
# build against the plain one. K1 alike (its per-ray form)
# ---------------------------------------------------------------------------


def _cornell_rays(cuda, seed: int):
    scene, cam, _ = t_ts.cornell_box(64, 64, tall_box_bsdf=SPECS["glass"], device=cuda)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    perm, _ = t_mk.tile_swizzle(64, 64, cuda)
    o, d, rng = t_cam.generate_rays(cam, perm, t_qmc.make_state("pcg", seed, perm, 0))
    return pack, o, d, rng


def test_k2_persistent_relaunch_bit_equal(cuda):
    """Two launches back to back, with and without the stats plane: L and
    stats bit-equal (the counter reset itself), L within the contract of
    the plain version."""
    pack, o, d, rng = _cornell_rays(cuda, 41)
    md = MaxDepthParams()
    L1, s1 = t_mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    L2, s2 = t_mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    L3 = t_mk.trace_megakernel(pack, md, o, d, rng)
    torch.cuda.synchronize()
    assert torch.equal(L1.view(torch.int32), L2.view(torch.int32)) and torch.equal(s1, s2)
    assert torch.equal(L1.view(torch.int32), L3.view(torch.int32))
    assert _lanes_differing(L1, t_mk.trace_megakernel_reference(pack, md, o, d, rng)) <= 0.02


@pytest.mark.parametrize("n", [1, 5, 31, 77, 1000])
def test_k2_persistent_small_batches(cuda, n):
    """A batch smaller than a warp or not a multiple of 32: each lane's L
    bit-equal to the same path in the full 4,096-path launch (paths are
    independent), and within the contract of the plain version (with one
    lane of slack: 2 % of a batch under 50 lanes is less than a lane)."""
    pack, o, d, rng = _cornell_rays(cuda, 43)
    md = MaxDepthParams()
    full = t_mk.trace_megakernel(pack, md, o, d, rng)
    part = t_mk.trace_megakernel(pack, md, o[:n].contiguous(), d[:n].contiguous(),
                                 rng[:n].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(part.view(torch.int32), full[:n].view(torch.int32))
    Lp = t_mk.trace_megakernel_reference(pack, md, o[:n], d[:n], rng[:n])
    assert _lanes_differing(part, Lp) <= 0.02 + 1.0 / n


def test_k2_stage_matches_unstaged(cuda, monkeypatch):
    """cornell's w8 pack (8.8 KB) runs the STAGE build, its tables in shared
    memory; the same launch with the table sizes withheld runs the plain
    build: L and walk work bit-equal, each instantiation reported."""
    pack, o, d, rng = _cornell_rays(cuda, 47)
    md = MaxDepthParams()
    assert t_mk.stages(pack)
    t_mk.reset_launches()
    L1, s1 = t_mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    real = t_mk._tables

    def unsized(p):
        t = real(p)
        for k in range(len(t) - len(t_mk.STAGE_KEYS), len(t)):
            t[k] = 0
        return t

    monkeypatch.setattr(t_mk, "_tables", unsized)
    L2, s2 = t_mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    assert t_mk.INSTANTIATION_LAUNCHES == {"K2+STAGE": 1, "K2": 1}
    assert torch.equal(L1.view(torch.int32), L2.view(torch.int32)) and torch.equal(s1, s2)


def test_k1_relaunch_bit_equal(cuda):
    """K1's per-ray form twice back to back, closest hit with the stats
    plane and any hit: every output bit-equal, the stats counted once per
    launch, prim ids equal to the plain version's."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64, device=cuda)
    o, d, t_far = _forest_rays(scene, 8192, 7, cuda)
    runs = []
    for _ in range(2):
        stats = torch.zeros((8192, 2), dtype=torch.int32, device=cuda)
        k = t_tk.traverse_forest(scene.forest, o, d, stats=stats)
        occ = t_tk.traverse_forest(scene.forest, o, d, t_far, occlusion=True)["occluded"]
        runs.append((k, stats, occ))
    torch.cuda.synchronize()
    (k1, st1, occ1), (k2, st2, occ2) = runs
    for key in ("prim", "t", "b1", "b2"):
        assert torch.equal(k1[key], k2[key]), key
    assert torch.equal(st1, st2) and torch.equal(occ1, occ2) and bool((st1[:, 0] > 0).all())
    assert torch.equal(k1["prim"], t_tk.traverse_forest_reference(scene.forest, o, d)["prim"])


@pytest.mark.parametrize("n", [1, 5, 31, 77, 1000])
def test_k1_small_batches(cuda, n):
    """K1 closest and any hit on a batch smaller than a warp or not a
    multiple of 32: prim ids, t and occlusion equal to the plain version's
    and to the same rays in a 4,096-ray launch."""
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64, device=cuda)
    o, d, t_far = _forest_rays(scene, 4096, 8, cuda)
    full = t_tk.traverse_forest(scene.forest, o, d)
    full_occ = t_tk.traverse_forest(scene.forest, o, d, t_far, occlusion=True)["occluded"]
    on, dn, tn = (x[:n].contiguous() for x in (o, d, t_far))
    k = t_tk.traverse_forest(scene.forest, on, dn)
    occ = t_tk.traverse_forest(scene.forest, on, dn, tn, occlusion=True)["occluded"]
    p = t_tk.traverse_forest_reference(scene.forest, on, dn)
    p_occ = t_tk.traverse_forest_reference(scene.forest, on, dn, tn, occlusion=True)["occluded"]
    for key in ("prim", "t"):
        assert torch.equal(k[key], p[key]) and torch.equal(k[key], full[key][:n]), key
    assert torch.equal(occ, p_occ) and torch.equal(occ, full_occ[:n])
