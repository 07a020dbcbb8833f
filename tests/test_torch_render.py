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
from cuda_pt_torch.scene.builder import BSDFSpec
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
    img_p = t_mk.render_pack(t_mk.make_pack(scene), cam, md, spp=2, seed=7).numpy()
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
    plastic = BSDFSpec(btype=TT.BSDF_PLASTIC, k_d=(0.5, 0.5, 0.5))
    scene, cam, _ = t_ts.cornell_box(8, 8, tall_box_bsdf=plastic)
    with pytest.raises(ValueError, match="envelope"):
        Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), device="cuda")


@pytest.mark.parametrize("rtype", [RendererType.WAVEFRONT_PT, RendererType.VOLUME_PT,
                                   RendererType.MEGAKERNEL_LT, RendererType.DEPTH])
def test_unported_renderers_raise(rtype):
    scene, cam, _ = t_ts.cornell_box(8, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(_parsed(scene, cam, MaxDepthParams()), renderer=rtype, device="cpu")
    with pytest.raises(NotImplementedError):
        Renderer("scene.xml", device="cpu")
