"""The port's light tracer (models/light_tracer.py, core/camera.splat_pixel)
and the Renderer's MEGAKERNEL_LT route against the JAX reference and the
committed golden, and RenderingConfig's fields against the reference's.
Scenes are built with the reference's builder and carried across by the
bridge; the JAX references run jitted at 12x12, with no Pallas call."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.models import light_tracer as t_lt
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import config as j_config
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import light_tracer as j_lt
from cuda_pt_tpu.scene import builder as j_builder
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_lt_24_s5.npz")


def _port(sj, cj):
    return (bridge.scene_from_numpy(flatten_jax_scene(sj)),
            bridge.camera_from_numpy(flatten_jax_camera(cj)))


def _parsed(scene, cam, md, **cfg):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                   **cfg))


@pytest.fixture(scope="module")
def cornell8():
    return _port(*j_ts.cornell_box(8, 8)[:2])


def test_splat_pixel_matches_jax():
    """4,096 points around the cornell camera, some behind it and some
    outside the film: valid equal, px / py within 1e-4 where valid."""
    _, cj, _ = j_ts.cornell_box(24, 16)
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    rs = np.random.default_rng(11)
    z = rs.uniform(-1.0, 5.0, 4096)
    xy = rs.uniform(-0.6, 0.6, (4096, 2)) * (np.abs(z)[:, None] + 0.1)
    cam_p = np.concatenate([xy, z[:, None]], axis=1)  # right, up, forward
    p = (np.asarray(cj.t) + cam_p @ np.asarray(cj.R).T).astype(np.float32)
    pxj, pyj, vj = (np.asarray(a) for a in j_cam.splat_pixel(cj, jnp.asarray(p)))
    pxt, pyt, vt = (a.numpy() for a in t_cam.splat_pixel(ct, torch.as_tensor(p)))
    np.testing.assert_array_equal(vt, vj)
    assert 0.1 < vj.mean() < 0.9  # both sides of the film's edges and the camera plane
    np.testing.assert_allclose(pxt[vj], pxj[vj], atol=1e-4)
    np.testing.assert_allclose(pyt[vj], pyj[vj], atol=1e-4)


def test_light_tracer_matches_golden():
    """cornell 24x24, max_depth 4, 16 passes, seed 5, the tree walked:
    test_golden._check's f32 tolerance against the committed golden."""
    st, ct = _port(*j_ts.cornell_box(width=24, height=24)[:2])
    img = t_lt.render(st, ct, MaxDepthParams(max_depth=4), spp=16, seed=5, use_bvh=True).numpy()
    ref = np.load(GOLDEN)["img"].astype(np.float32)
    assert img.shape == ref.shape
    assert np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean() > 0.995
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4


def test_render_pass_mirror_caustics_match_jax():
    """One pass at 12x12 on cornell with a mirror tall box, specular
    constraint 1 and caustic scale 2, the tree walked: per pixel
    allclose(rtol 1e-4, atol 1e-6) on >= 99 % of pixels, sums within 1e-4."""
    spec = j_builder.BSDFSpec(btype=JT.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95))
    sj, cj, _ = j_ts.cornell_box(12, 12, tall_box_bsdf=spec)
    run = jax.jit(lambda s, c: j_lt.render_pass(s, c, JMD(max_depth=4), 9, 0, True, 1, 2.0))
    img_j = np.asarray(run(sj, cj))
    st, ct = _port(sj, cj)
    img_t = t_lt.render_pass(st, ct, MaxDepthParams(max_depth=4), 9, 0, True, 1, 2.0).numpy()
    assert img_t.shape == img_j.shape and np.isfinite(img_t).all()
    assert img_j.sum() > 0
    close = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img_t.sum() / img_j.sum() - 1.0) < 1e-4


def test_sobol_raises_naming_the_roadmap(cornell8):
    st, ct = cornell8
    with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
        t_lt.render_pass(st, ct, MaxDepthParams(max_depth=2), 0, 0, False, sampler="sobol")


def test_render_bidirectional_is_pt_plus_lt(cornell8):
    st, ct = cornell8
    md = MaxDepthParams(max_depth=3)
    got = t_lt.render_bidirectional(st, ct, md, 2, seed=4)
    want = (t_pt.render(st, ct, md, 2, seed=4)
            + t_lt.render(st, ct, md, 2, seed=5, specular_constraint=1))
    assert torch.equal(got, want)


def test_renderer_lt_route(cornell8):
    """A pass is render_pass bit for bit with the config's knobs (a negative
    specular constraint clipped to 0, the caustic scaling applied), and
    max_lanes_per_call does not band it."""
    st, ct = cornell8
    md = MaxDepthParams(max_depth=3)
    parsed = _parsed(st, ct, md, seed=6, specular_constraint=-2, caustic_scaling=1.5)
    r = Renderer(parsed, renderer=RendererType.MEGAKERNEL_LT, device="cpu")
    img = r.render_raw()
    want = t_lt.render_pass(st, ct, md, 6, 0, False, 0, 1.5).reshape(8, 8, 3)
    assert torch.equal(img, want)
    plain = t_lt.render_pass(st, ct, md, 6, 0, False, 0, 1.0).reshape(8, 8, 3)
    assert not torch.equal(img, plain)  # the scaling reaches the pass
    assert (r.info()["driver"], r.info()["traversal"]) == ("composed", "xla")
    banded = Renderer(parsed, renderer=RendererType.MEGAKERNEL_LT, max_lanes_per_call=16,
                      device="cpu")
    np.testing.assert_array_equal(banded.render(2), r.render(1))


@pytest.mark.parametrize("rtype", [RendererType.MEGAKERNEL_LT, RendererType.DEPTH,
                                   RendererType.BVH_COST])
def test_fused_raises_outside_pt_and_vpt(cornell8, rtype):
    st, ct = cornell8
    with pytest.raises(ValueError, match="requires the megakernel PT or volume PT"):
        Renderer(_parsed(st, ct, MaxDepthParams()), renderer=rtype, traversal="fused",
                 device="cpu")


def test_rendering_config_fields_match_reference():
    assert ([f.name for f in dataclasses.fields(RenderingConfig)]
            == [f.name for f in dataclasses.fields(j_config.RenderingConfig)])
    assert RenderingConfig().specular_constraint == 0
    assert RenderingConfig().caustic_scaling == 1.0 and not RenderingConfig().bidirectional
