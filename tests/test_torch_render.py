"""The port's main path end to end: api.Renderer on the CPU against the
committed JAX golden and against JAX renders with delta lobes, plus the
Renderer's behaviour (banding, device choice, envelope)."""

import os

import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec, MediumSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.scene import builder as j_builder
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_megakernel_24_s1234.npz")


def _parsed(scene, cam, md, seed=0):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                   seed=seed))


def test_renderer_matches_golden_cornell_24():
    """Renderer on the CPU: cornell 24x24, max_depth 4, 16 spp, seed 1234,
    against the JAX golden, at test_golden.py's tolerance."""
    scene, cam, _ = t_ts.cornell_box(24, 24)
    r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=4), seed=1234), device="cpu")
    img = r.render(16)
    ref = np.load(GOLDEN)["img"].astype(np.float32)
    assert r.counter() == 16 and img.shape == ref.shape
    match = np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean()
    assert match > 0.995, match
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4


@pytest.mark.parametrize("kind", ["specular", "translucent"])
def test_renderer_delta_lobes_match_jax(kind):
    """cornell with a mirror / glass tall box, 12x12, 4 spp: the port's
    Renderer against JAX pt.render on the same scene arrays."""
    spec = {"specular": j_builder.BSDFSpec(btype=JT.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95)),
            "translucent": j_builder.BSDFSpec(btype=JT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98),
                                              ior=1.5)}[kind]
    sj, cj, _ = j_ts.cornell_box(12, 12, tall_box_bsdf=spec)
    img_j = np.asarray(j_pt.render(sj, cj, JMD(max_depth=4), spp=4, seed=3))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    img_t = Renderer(_parsed(st, ct, MaxDepthParams(max_depth=4), seed=3), device="cpu").render(4)
    assert np.isfinite(img_t).all()
    match = np.isclose(img_t, img_j, atol=2e-2, rtol=1e-3).mean()
    assert match > 0.95, match
    assert abs(img_t.mean() - img_j.mean()) < 5e-3


def test_banded_render_bit_identical():
    scene, cam, _ = t_ts.cornell_box(16, 16)
    parsed = _parsed(scene, cam, MaxDepthParams(max_depth=3))
    whole = Renderer(parsed, max_lanes_per_call=0, device="cpu").render(2)
    r_band = Renderer(parsed, max_lanes_per_call=48, device="cpu")  # 3 rows per band
    np.testing.assert_array_equal(r_band.render(2), whole)
    assert r_band.counter() == 2


def test_render_pack_matches_renderer():
    """megakernel.render_pack, the pack-level render loop, gives the
    Renderer's image: same pcg streams, same lane order, same estimator."""
    scene, cam, _ = t_ts.cornell_box(12, 8)
    md = MaxDepthParams(max_depth=3)
    img_r = Renderer(_parsed(scene, cam, md, seed=7), device="cpu").render(2)
    img_p = t_mk.render_pack(t_mk.make_pack(scene, node_fmt="w8"), cam, md, spp=2, seed=7).numpy()
    assert img_p.shape == img_r.shape == (8, 12, 3) and img_r.mean() > 0.01
    # Welford mean (film) vs sum / spp: one rounding apart
    np.testing.assert_allclose(img_p, img_r, rtol=1e-6, atol=1e-7)


def test_renderer_surface(tmp_path):
    scene, cam, _ = t_ts.cornell_box(8, 6)
    r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), device="cpu")
    r.render(2)
    assert r.variance().shape == (6, 8) and r.avg_frame_time() > 0.0
    info = r.info()
    assert info["spp_accumulated"] == 2 and info["device"] == "cpu"
    buf = r.get_image_buffer()
    assert buf.dtype == np.uint8 and buf.shape == (6, 8, 3)
    path = tmp_path / "out.png"
    r.save(str(path))
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    r.update_camera(t_cam.make_camera((0.5, 0.5, -1.0), (0.5, 0.5, 0.5), width=4, height=4))
    assert r.counter() == 0 and r.render(1).shape == (4, 4, 3)


def test_renderer_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the default device is valid")
    scene, cam, _ = t_ts.cornell_box(8, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)))


def test_renderer_rejects_scene_outside_envelope_on_cuda():
    """Plastic-forward is outside the fused kernel, as in the reference:
    traversal="fused" raises and names the composed route, on any device;
    the default route takes the composed path instead."""
    pfw = BSDFSpec(btype=TT.BSDF_PLASTIC_FORWARD, k_d=(0.5, 0.5, 0.5))
    scene, cam, _ = t_ts.cornell_box(8, 8, tall_box_bsdf=pfw)
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="envelope.*composed path"):
            Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), device=device,
                     traversal="fused")
    r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), device="cpu")
    assert r.info()["driver"] == "composed" and r.info()["traversal"] == "xla"


def test_renderer_kitchen_flags_cpu():
    """kitchen_stress renders through the Renderer (the plain version on
    the CPU) with all three K3 flags reported."""
    scene, cam, _ = t_ts.kitchen_stress(6, 4, grid=2, ns=6, nt=4)
    r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=3), seed=2), device="cpu")
    img = r.render(1)
    info = r.info()
    assert (info["has_env"], info["textured"], info["has_disp"]) == (True, True, True)
    assert img.shape == (4, 6, 3) and np.isfinite(img).all() and img.mean() > 0.01


def test_composed_path_kitchen_matches_jax():
    """models/path_tracer.trace_paths (the composed estimator: envmap NEE
    with importance tables and MIS, textured make_ctx, the skip walk above
    64 prims) against JAX pt.trace_paths per lane on kitchen_stress 8x8."""
    import jax.numpy as jnp

    from cuda_pt_torch.models import path_tracer as t_pt
    from cuda_pt_tpu.core import camera as j_cam
    from cuda_pt_tpu.core import qmc as j_qmc

    sj, cj, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    lane = jnp.arange(64, dtype=jnp.int32)
    o, d, rng = j_cam.generate_rays(cj, lane, j_qmc.make_state("pcg", 5, lane, 1))
    Lj = np.asarray(j_pt.trace_paths(sj, JMD(max_depth=3), o, d, rng, use_bvh=True))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    Lt = t_pt.trace_paths(st, MaxDepthParams(max_depth=3), torch.tensor(np.asarray(o)),
                          torch.tensor(np.asarray(d)),
                          torch.tensor(np.asarray(rng).astype(np.int64))).numpy()
    assert Lj.mean() > 0.05
    assert np.isclose(Lt, Lj, rtol=1e-4, atol=1e-5).all(axis=-1).mean() >= 0.95
    assert abs(Lt.mean() - Lj.mean()) <= 1e-3 * Lj.mean()


def _golden_furnace():
    scene, cam, _ = t_ts.furnace(16, 16, albedo=0.75)
    return scene, cam, MaxDepthParams(max_depth=12, max_diffuse=12), 16, 9


def _golden_rough_pane():
    from cuda_pt_torch.scene.builder import EmitterSpec, SceneBuilder

    b = SceneBuilder()
    q = t_ts.quad
    glass = b.add_bsdf(BSDFSpec(btype=TT.BSDF_GGX_DIELECTRIC, k_s=(1, 1, 1), ior=1.5,
                                roughness_x=0.2, roughness_y=0.2))
    white = b.add_bsdf(BSDFSpec(k_d=(0.7, 0.7, 0.7)))
    dark = b.add_bsdf(BSDFSpec(k_d=(0, 0, 0)))
    em = b.add_emitter(EmitterSpec(emission=(1, 1, 1), scaler=10.0))
    b.add_mesh(q([-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2]), white)
    b.add_mesh(q([-0.5, 1.5, -0.5], [0.5, 1.5, -0.5], [0.5, 1.5, 0.5], [-0.5, 1.5, 0.5]), dark,
               emitter_id=em)
    b.add_mesh(q([-1, 0.6, -1], [1, 0.6, -1], [1, 0.6, 1], [-1, 0.6, 1]), glass)
    cam = t_cam.make_camera((0, 1.1, -2.5), (0, 0.3, 0), fov=45, width=24, height=24)
    return b.compile(), cam, MaxDepthParams(max_depth=5, max_transmit=6), 16, 31


def _golden_cornell_on():
    scene, cam, _ = t_ts.cornell_box(24, 24, tall_box_bsdf=BSDFSpec(
        btype=TT.BSDF_OREN_NAYAR, k_d=(0.6, 0.5, 0.4), roughness_x=0.6, roughness_y=0.6))
    return scene, cam, MaxDepthParams(max_depth=4), 16, 8


@pytest.mark.parametrize("name,make", [("furnace_a075_16_s9", _golden_furnace),
                                       ("rough_dielectric_pane_24_s31", _golden_rough_pane),
                                       ("cornell_on_24_s8", _golden_cornell_on)])
def test_composed_render_matches_golden(name, make):
    """models/path_tracer.render against the committed JAX goldens at
    test_golden._check's tolerances (the goldens are only read)."""
    from cuda_pt_torch.models import path_tracer as t_pt

    scene, cam, md, spp, seed = make()
    img = t_pt.render(scene, cam, md, spp=spp, seed=seed).numpy()
    ref = np.load(os.path.join(os.path.dirname(GOLDEN), f"{name}.npz"))["img"].astype(np.float32)
    assert img.shape == ref.shape
    match = np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean()
    assert match > 0.995, f"{name}: {match:.4f} of pixels match"
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4


@pytest.mark.parametrize("rtype", [RendererType.VOLUME_PT])
def test_unported_renderers_raise(rtype):
    scene, cam, b = t_ts.cornell_box(8, 8)
    if rtype == RendererType.VOLUME_PT:
        # the volume path tracer renders homogeneous and grid media; an
        # emissive grid waits for the composed route
        gid = b.add_grid(np.ones((2, 2, 2), np.float32), (0, 0, 0), (1, 1, 1),
                         emission=np.ones((2, 2, 2), np.float32))
        b.add_medium(MediumSpec(mtype=TT.MEDIUM_GRID, grid_id=gid, emission_scale=1.0))
        b.cam_medium = 0
        scene = b.compile()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(_parsed(scene, cam, MaxDepthParams()), renderer=rtype, device="cpu")
    with pytest.raises(NotImplementedError):
        Renderer("scene.xml", device="cpu")
