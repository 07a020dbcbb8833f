"""The volume path tracer of the port (models/volume_pt.py; the Renderer's
VOLUME_PT route through kernel K4's plain version) against the JAX
reference: the media scenes' arrays, the media pack, the composed
estimator against JAX volume_pt.trace_paths, the fused estimator and the
Renderer against JAX's fused kernel (trace_megakernel with has_media,
interpret mode), and the envelope and Renderer errors.

Contract per lane: allclose(rtol 1e-4, atol 1e-5) on >= 95 % of lanes,
image means within 1e-3 relative."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.core.config import RendererType, RenderingConfig
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec as TBSDFSpec
from cuda_pt_torch.scene.builder import MediumSpec as TMediumSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, MediumSpec, SceneBuilder
from test_round4_fixes import _medium_box_scene
from test_torch_bridge import (TABLES, concurrently, flatten_jax_camera, flatten_jax_scene,
                               numpy_bvh_builds)

RTOL, ATOL, MIN_LANES, MEAN_REL = 1e-4, 1e-5, 0.95, 1e-3
FOG = dict(sigma_a=(0.05, 0.08, 0.05), sigma_s=(0.6, 0.5, 0.4), scale=1.5)


# ---------------------------------------------------------------------------
# JAX twins of the port's media scenes
# ---------------------------------------------------------------------------


def _box_faces(lo, hi):
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return [j_ts.quad(*f) for f in (
        ([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        ([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1]),
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        ([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]))]


def j_cornell_vpt(w=8):
    """tests/test_round4_fixes.py::test_fused_vpt_camera_in_medium's scene."""
    _, cam, b = j_ts.cornell_box(width=w, height=w)
    b.add_medium(MediumSpec(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.25, 0.25, 0.25)))
    return b.compile().replace(cam_medium=jnp.int32(0)), cam


def j_nested_media(w=8, outer=None, inner=None, inner_null=False):
    """The port's nested_media; outer / inner replace the two media's phase
    fields (phase_type, phase_g, phase_w), inner_null gives the inner box
    null (forward) faces in place of glass."""
    q = j_ts.quad
    b = SceneBuilder()
    hg = b.add_medium(MediumSpec(**FOG, **(outer or dict(phase_type=JT.PHASE_HG,
                                                           phase_g=(0.3, 0.0)))))
    iso = b.add_medium(MediumSpec(sigma_a=(0.02, 0.02, 0.02), sigma_s=(2.0, 2.0, 2.0),
                                  **(inner or {})))
    fog = b.add_bsdf(BSDFSpec(btype=JT.BSDF_FORWARD))
    glass = b.add_bsdf(BSDFSpec(btype=JT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5))
    grey = b.add_bsdf(BSDFSpec(k_d=(0.6, 0.55, 0.5)))
    dark = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    panel = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1, 1, 1), scaler=25.0))
    b.add_mesh(q([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]), grey)
    b.add_mesh(q([-2, 0, 2], [2, 0, 2], [2, 2, 2], [-2, 2, 2]), grey)
    b.add_mesh(q([-0.4, 1.9, -0.4], [0.4, 1.9, -0.4], [0.4, 1.9, 0.4], [-0.4, 1.9, 0.4]), dark,
               emitter_id=panel)
    for f in _box_faces((-0.8, 0.15, -0.8), (0.8, 1.1, 0.8)):
        b.add_mesh(f, fog, medium_in=hg)
    for f in _box_faces((-0.35, 0.35, -0.35), (0.35, 0.8, 0.35)):
        b.add_mesh(f, fog if inner_null else glass, medium_in=iso)
    cam = j_cam.make_camera(origin=(0, 1.1, -2.8), target=(0, 0.5, 0), fov=50.0, width=w,
                            height=w)
    return b.compile(), cam


def j_medium_cbox(w=8, ns=192, nt=96):
    q = j_ts.quad
    b = SceneBuilder()
    white = b.add_bsdf(BSDFSpec(k_d=(0.73, 0.73, 0.73)))
    red = b.add_bsdf(BSDFSpec(k_d=(0.65, 0.05, 0.05)))
    green = b.add_bsdf(BSDFSpec(k_d=(0.12, 0.45, 0.15)))
    light_m = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    em = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1.0, 1.0, 1.0), scaler=12.0))
    b.add_mesh(q([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), white)
    b.add_mesh(q([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]), white)
    b.add_mesh(q([0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]), white)
    b.add_mesh(q([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]), red)
    b.add_mesh(q([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]), green)
    b.add_mesh(q([0.35, 0.998, 0.35], [0.65, 0.998, 0.35], [0.65, 0.998, 0.65],
                 [0.35, 0.998, 0.65]), light_m, emitter_id=em)
    hg = b.add_medium(MediumSpec(**FOG, phase_type=JT.PHASE_HG, phase_g=(0.3, 0.0)))
    iso = b.add_medium(MediumSpec(sigma_a=(0.02, 0.02, 0.02), sigma_s=(2.0, 2.0, 2.0)))
    fog = b.add_bsdf(BSDFSpec(btype=JT.BSDF_FORWARD))
    glass = b.add_bsdf(BSDFSpec(btype=JT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5))
    for f in _box_faces((0.1, 0.002, 0.1), (0.9, 0.75, 0.9)):
        b.add_mesh(f, fog, medium_in=hg)
    p, n, uv = j_ts._torus_mesh((0.5, 0.35, 0.5), R=0.22, r=0.09, ns=ns, nt=nt)
    b.add_mesh(p, glass, n=n, uv=uv, medium_in=iso)
    cam = j_cam.make_camera(origin=(0.5, 0.5, -1.35), target=(0.5, 0.5, 0.5), fov=40.0,
                            width=w, height=w)
    return b.compile(), cam


SCENE_PAIRS = {
    "medium_box": (lambda: t_ts.medium_box(8, 8), lambda: _medium_box_scene(8)),
    "cornell_vpt": (lambda: t_ts.cornell_vpt(8, 8), lambda: j_cornell_vpt(8)),
    "nested_media": (lambda: t_ts.nested_media(8, 8), lambda: j_nested_media(8)),
    # medium_cbox at a coarser torus (the full 36,888-triangle scene is
    # checked below without its JAX twin)
    "medium_cbox": (lambda: t_ts.medium_cbox(8, 8, ns=24, nt=12),
                    lambda: j_medium_cbox(8, ns=24, nt=12)),
}


@pytest.fixture
def numpy_bvh_reference(monkeypatch):
    """Make both builders take their NumPy BVH paths (use_native=False)."""
    numpy_bvh_builds(monkeypatch)


@pytest.mark.parametrize("kind", list(SCENE_PAIRS))
def test_media_scene_arrays_equal(numpy_bvh_reference, kind):
    make_t, make_j = SCENE_PAIRS[kind]
    st, ct, _ = make_t()
    sj, cj = make_j()
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        for f in dataclasses.fields(table):
            got = getattr(table, f.name)
            got = got.numpy() if torch.is_tensor(got) else got
            np.testing.assert_array_equal(got, flat[f"{name}.{f.name}"], err_msg=f"{name}.{f.name}")
    assert (st.env_emitter, st.cam_medium, st.num_emitters) == (
        flat["env_emitter"], flat["cam_medium"], flat["num_emitters"])
    assert st.present_bsdfs == flat["present_bsdfs"]
    for f in ("R", "t", "focal", "aperture", "focal_dist", "hsign"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), f)


def test_medium_cbox_full_size():
    """The full-size scene: 36,888 triangles, media nested two deep (a glass
    torus with an isotropic medium inside an HG fog box), in the envelope of
    kernel K4 and not in the surface kernel's."""
    st, _, _ = t_ts.medium_cbox(8, 8)
    assert st.geom.num_prims == 36888
    assert st.media.phase_type.tolist() == [TT.PHASE_HG, TT.PHASE_ISOTROPIC]
    assert sorted(set(st.objects.medium_in.tolist())) == [-1, 0, 1]
    assert t_mk.megakernel_ok(st, TMD(), renderer="vpt") and not t_mk.megakernel_ok(st, TMD())


@pytest.mark.parametrize("kind", ["medium_box", "cornell_vpt"])
def test_bridge_carries_media(kind):
    """scene_from_numpy carries the media table, the objects' medium_in and
    cullable flags and the camera's medium from a JAX scene."""
    sj, _ = SCENE_PAIRS[kind][1]()
    flat = flatten_jax_scene(sj)
    st = bridge.scene_from_numpy(flat)
    for f in dataclasses.fields(st.media):
        np.testing.assert_array_equal(getattr(st.media, f.name).numpy(), flat[f"media.{f.name}"])
    for f in ("medium_in", "cullable"):
        np.testing.assert_array_equal(getattr(st.objects, f).numpy(), flat[f"objects.{f}"])
    assert st.cam_medium == int(np.asarray(sj.cam_medium)) == (0 if kind == "cornell_vpt" else -1)
    assert int(st.objects.medium_in.max()) == (-1 if kind == "cornell_vpt" else 0)


@pytest.mark.parametrize("kind", ["medium_box", "cornell_vpt", "nested_media"])
def test_vpt_pack_equals_reference(kind):
    """make_pack(vpt=True): the TPU pack's tables bit-equal, the media row
    equal to its pack_media, has_media and the ambient medium as there."""
    sj, _ = SCENE_PAIRS[kind][1]()
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pj = j_mk.make_pack(sj, node_fmt="w8", vpt=True)
    pt = t_mk.make_pack(st, node_fmt="w8", vpt=True)
    for k in t_mk.PACK_KEYS + t_mk.MED_KEYS:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]), err_msg=k)
    assert pt.has_media and pj.has_media
    assert pt.ambient_med == int(pj.ambient_med) == (0 if kind == "cornell_vpt" else -1)
    with pytest.raises(ValueError, match="vpt=True"):  # the pack decides the estimator
        t_mk.make_pack(st, node_fmt="w8")


# ---------------------------------------------------------------------------
# the composed estimator against JAX volume_pt
# ---------------------------------------------------------------------------


def _jax_rays(cj, seed, lanes, sample=0):
    rng = j_qmc.make_state("pcg", seed, lanes, sample)
    return j_cam.generate_rays(cj, lanes, rng)


def _torch(*xs):
    return [torch.tensor(np.asarray(x).astype(np.int64 if np.asarray(x).dtype == np.uint32
                                               else np.asarray(x).dtype)) for x in xs]


def _hold(Lt, Lj):
    close = np.isclose(Lt, Lj, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    assert close.mean() >= MIN_LANES, (close.mean(), np.abs(Lt - Lj).max())
    assert abs(Lt.mean() - Lj.mean()) <= MEAN_REL * abs(Lj.mean()), (Lt.mean(), Lj.mean())


@pytest.mark.parametrize("kind", ["medium_box", "cornell_vpt"])
def test_composed_vpt_matches_jax(kind):
    """models/volume_pt.trace_paths (composed) against JAX's per lane, 8x8,
    max_depth 4: the HG slab behind null faces, and the camera inside a
    medium."""
    sj, cj = SCENE_PAIRS[kind][1]()
    lane = jnp.arange(64, dtype=jnp.int32)
    o, d, rng = _jax_rays(cj, 5, lane, 1)
    Lj = np.asarray(j_vpt.trace_paths(sj, JMD(max_depth=4), o, d, rng, use_bvh=False))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    Lt = t_vpt.trace_paths(st, TMD(max_depth=4), *_torch(o, d, rng)).numpy()
    _hold(Lt, Lj)


# ---------------------------------------------------------------------------
# the fused estimator (K4's plain version) and the Renderer against JAX's kernel
# ---------------------------------------------------------------------------

SEED, MD_FUSED = 3, 4


def _jax_kernel_image():
    """JAX render_pack of the nested-media scene through the fused kernel
    (interpret mode), 8x8, one spp."""
    sj, cj = j_nested_media(8)
    pack = j_mk.make_pack(sj, node_fmt="w8", vpt=True)
    assert pack.has_media
    img = np.asarray(j_mk.render_pack(pack, cj, JMD(max_depth=MD_FUSED), 1, SEED, interpret=True))
    return sj, cj, img


# the two phase functions of the fused kernel that nested_media leaves out
DUAL_HG = dict(phase_type=JT.PHASE_DUAL_HG, phase_g=(0.7, -0.4), phase_w=0.6)
RAYLEIGH = dict(phase_type=JT.PHASE_RAYLEIGH)
DUAL_MD = 6


def _jax_kernel_dual_hg_rayleigh():
    """JAX trace_megakernel (interpret mode) on the 64 lanes of nested_media
    with a Rayleigh fog around a dual-HG medium behind null faces."""
    sj, cj = j_nested_media(8, outer=RAYLEIGH, inner=DUAL_HG, inner_null=True)
    perm, _ = j_mk.tile_swizzle(8, 8)
    o, d, rng = _jax_rays(cj, SEED + 1, perm)
    Lj = np.asarray(j_mk.trace_megakernel(j_mk.make_pack(sj, node_fmt="w8", vpt=True),
                                          JMD(max_depth=DUAL_MD), o, d, rng, interpret=True))
    return sj, o, d, rng, Lj


@pytest.fixture(scope="module")
def jax_kernels():
    """The file's two interpret calls, run at once (concurrently)."""
    return concurrently(image=_jax_kernel_image, dual=_jax_kernel_dual_hg_rayleigh)


@pytest.fixture(scope="module")
def jax_kernel_image(jax_kernels):
    return jax_kernels["image"]


def test_fused_vpt_matches_jax_kernel(jax_kernel_image):
    """volume_pt.trace_paths(fused=True) through trace_megakernel on the CPU,
    on JAX's own rays and streams, against the kernel's image per pixel."""
    sj, cj, img = jax_kernel_image
    perm, inv = j_mk.tile_swizzle(8, 8)
    o, d, rng = _jax_rays(cj, SEED, perm)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pack = t_mk.make_pack(st, node_fmt="w8", vpt=True)
    Lt = t_mk.trace_megakernel(pack, TMD(max_depth=MD_FUSED), *_torch(o, d, rng)).numpy()
    _hold(Lt[np.asarray(inv)], img.reshape(-1, 3))


def test_fused_vpt_matches_jax_kernel_dual_hg_rayleigh(jax_kernels):
    """The same hold on nested_media with a Rayleigh fog around a dual-HG
    medium behind null faces (so light reaches both by NEE): the kernel's
    exp(log(x)/3) cube root in the Rayleigh sample (megakernel.py:2057-2059)
    and its dual lobe, the file's second and last interpret call
    (trace_megakernel on the 64 lanes, max_depth 6). On these lanes a
    mirrored Rayleigh sample moves 16 % of them and swapped dual-HG
    weights 8 %, both past the 5 % the contract allows."""
    sj, o, d, rng, Lj = jax_kernels["dual"]
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    assert st.media.phase_type.tolist() == [TT.PHASE_RAYLEIGH, TT.PHASE_DUAL_HG]
    pack = t_mk.make_pack(st, node_fmt="w8", vpt=True)
    _hold(t_mk.trace_megakernel(pack, TMD(max_depth=DUAL_MD), *_torch(o, d, rng)).numpy(), Lj)


def test_vpt_renderer_cpu_matches_jax_kernel(jax_kernel_image):
    """The slice end to end: Renderer(VOLUME_PT, device="cpu"), one spp,
    against JAX render_pack with the same seed and sample index."""
    sj, cj, img = jax_kernel_image
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    parsed = ParsedScene(st, ct, RenderingConfig(width=8, height=8, md=TMD(max_depth=MD_FUSED),
                                                 seed=SEED))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, device="cpu")
    out = r.render(1)
    assert r.info()["has_media"] and r.info()["renderer"] == "vpt"
    _hold(out.reshape(-1, 3), img.reshape(-1, 3))


def test_fused_and_composed_agree_in_the_mean_isotropic():
    """On an isotropic medium the kernel's estimator and the composed one
    agree in the mean (the reference's 8 %, test_round4_fixes.py:501)."""
    scene, cam, _ = t_ts.cornell_vpt(16, 16)
    md = TMD(max_depth=5)
    perm, _ = t_mk.tile_swizzle(16, 16)
    means = {False: [], True: []}
    from cuda_pt_torch.core import camera as t_cam
    from cuda_pt_torch.core import qmc as t_qmc

    for i in range(8):
        rng = t_qmc.make_state("pcg", 2, perm, i)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        for fused in (False, True):
            means[fused].append(float(t_vpt.trace_paths(scene, md, o, d, rng, fused=fused).mean()))
    a, b = np.mean(means[True]), np.mean(means[False])
    assert b > 0.01 and abs(a - b) / b < 0.08, (a, b)


# ---------------------------------------------------------------------------
# envelope and Renderer errors
# ---------------------------------------------------------------------------


def _parsed(scene, cam, md=None, seed=0):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height,
                                                   md=md or TMD(max_depth=3), seed=seed))


def _grid_scene():
    scene, cam, b = t_ts.cornell_box(8, 8)
    gid = b.add_grid(np.ones((2, 2, 2), np.float32), (0, 0, 0), (1, 1, 1))
    b.add_medium(TMediumSpec(mtype=TT.MEDIUM_GRID, grid_id=gid))
    b.cam_medium = 0
    return b.compile(), cam


def test_grid_media_raise_naming_k6():
    """A grid medium rides the split sorted-wavefront driver (kernels K6 and
    K5's shade phase): the whole-path kernel and the fused whole-path loop
    raise naming K6, and the Renderer takes the driver."""
    scene, cam = _grid_scene()
    assert t_mk.megakernel_ok(scene, TMD(), renderer="vpt")
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=True)
    assert pack.has_grid
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    rng = torch.zeros((4, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="K6"):
        t_mk.trace_megakernel(pack, TMD(), o, d, rng)
    with pytest.raises(NotImplementedError, match="K6"):
        t_vpt.trace_paths(scene, TMD(), o, d, rng, fused=True)
    r = Renderer(_parsed(scene, cam), renderer=RendererType.VOLUME_PT, device="cpu")
    assert r.info()["driver"] == "swf_split"


def test_vpt_renderer_errors():
    """The fused route of the volume path tracer takes nee_candidates=1:
    traversal="fused" raises with M = 2, the default route takes the
    composed volume path tracer and reports M (the reference's routing)."""
    scene, cam, _ = t_ts.medium_box(8, 8)
    with pytest.raises(ValueError, match="nee_candidates=1"):
        Renderer(_parsed(scene, cam), renderer=RendererType.VOLUME_PT, nee_candidates=2,
                 device="cpu", traversal="fused")
    info = Renderer(_parsed(scene, cam), renderer=RendererType.VOLUME_PT, nee_candidates=2,
                    device="cpu").info()
    assert (info["driver"], info["nee_candidates"]) == ("composed", 2)
    with pytest.raises(ValueError, match="VOLUME_PT"):
        Renderer(_parsed(scene, cam), device="cpu")
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=True)
    with pytest.raises(ValueError, match="nee_candidates=1"):
        t_mk.trace_megakernel(pack, TMD(), torch.zeros((1, 3)), torch.ones((1, 3)),
                              torch.zeros((1, 2), dtype=torch.int64), nee_candidates=2)
    o, d = torch.zeros((1, 3)), torch.ones((1, 3))
    rng = torch.zeros((1, 2), dtype=torch.int64)
    # compaction is ported: (L, lane permutation); tests/test_torch_vpt_compact.py holds it
    L, pix = t_vpt.trace_paths(scene, TMD(), o, d, rng, compact=True)
    assert L.shape == (1, 3) and pix.tolist() == [0]
    # the differentiable mode renders (tests/test_torch_diff.py holds its gradients)
    L = t_vpt.trace_paths(scene, TMD(), o, d, rng, differentiable=True)
    assert L.shape == (1, 3) and bool(torch.isfinite(L).all())


def test_vpt_composed_route_ignores_nee_candidates():
    """VOLUME_PT with nee_candidates=2 renders the composed volume path
    tracer, which ignores M: the same image as the composed route with
    M = 1, bit for bit."""
    scene, cam, _ = t_ts.medium_box(8, 8)
    parsed = _parsed(scene, cam)
    m2 = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=2, device="cpu")
    m1 = Renderer(parsed, renderer=RendererType.VOLUME_PT, traversal="xla", device="cpu")
    assert m2.info()["traversal"] == m1.info()["traversal"] == "xla"
    img = m2.render(1)
    np.testing.assert_array_equal(img, m1.render(1))
    assert img.mean() > 0.01


def test_vpt_envelope_rules():
    """Media only under renderer="vpt"; at most MAX_MEDIA media; no textures
    together with media (the reference's rules, megakernel.py:188-216)."""
    scene, _, b = t_ts.medium_box(8, 8)
    assert t_mk.megakernel_ok(scene, TMD(), renderer="vpt")
    assert not t_mk.megakernel_ok(scene, TMD(), renderer="pt")
    for _ in range(t_mk.MAX_MEDIA):
        b.add_medium(TMediumSpec(sigma_s=(0.1, 0.1, 0.1)))
    assert not t_mk.megakernel_ok(b.compile(), TMD(), renderer="vpt")
    _, _, b = t_ts.medium_box(8, 8)
    b.add_mesh(t_ts.quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]),
               b.add_bsdf(TBSDFSpec(tex_ids=(b.add_texture(np.ones((2, 2, 3))), -1, -1, -1, -1))))
    assert not t_mk.megakernel_ok(b.compile(), TMD(), renderer="vpt")


def test_vpt_banded_render_bit_identical():
    scene, cam, _ = t_ts.nested_media(12, 8)
    parsed = _parsed(scene, cam)
    whole = Renderer(parsed, renderer=RendererType.VOLUME_PT, device="cpu").render(2)
    banded = Renderer(parsed, renderer=RendererType.VOLUME_PT, max_lanes_per_call=36,
                      device="cpu")
    np.testing.assert_array_equal(banded.render(2), whole)
    assert whole.mean() > 0.01
