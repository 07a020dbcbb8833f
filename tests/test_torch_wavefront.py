"""The port's wavefront path tracer (cuda_pt_torch/models/wavefront.py) and
the Renderer's traversal routes, against the JAX reference.

Contracts: wavefront.render matches the golden cornell_wavefront_24_s77 at
test_golden._check's tolerance; the sort key equals the reference's bit
for bit; every lane of the wavefront loop (sorted, with and without
compaction) equals the composed path_tracer.trace_paths on the same ray
and stream at rtol 1e-5 / atol 1e-7 (lanes are independent: sorting only
moves them); the Renderer's composed route on a Plastic-forward scene
matches JAX pt.render_sample per pixel at rtol 1e-5 / atol 1e-7; the walk
backends ("xla", "pallas" = K1's plain version here, "wide") give the
same image lane for lane."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import wavefront as t_wf
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.models import wavefront as j_wf
from cuda_pt_tpu.scene import builder as j_builder
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

EXACT_RTOL, EXACT_ATOL = 1e-5, 1e-7
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_wavefront_24_s77.npz")


def _parsed(scene, cam, md, seed=0):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                   seed=seed))


def test_wavefront_matches_golden():
    """cornell 24x24, max_depth 4, 8 spp, seed 77 (the golden's settings)."""
    scene, cam, _ = t_ts.cornell_box(24, 24)
    img = t_wf.render(scene, cam, MaxDepthParams(max_depth=4), spp=8, seed=77).numpy()
    ref = np.load(GOLDEN)["img"].astype(np.float32)
    assert img.shape == ref.shape
    match = np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean()
    assert match > 0.995, match
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4


def test_sort_key_matches_reference():
    """_sort_key on kitchen_stress(grid=2) with the reference's own hits and
    a third of the lanes dead, bit for bit."""
    sj, cj, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    lane = jnp.arange(64, dtype=jnp.int32)
    o, d, rng = j_cam.generate_rays(cj, lane, j_qmc.make_state("pcg", 1, lane, 0))
    hj = j_pt.closest_hit(sj, o, d, True)
    sj_state = j_pt.init_state(o, d, rng)
    active = np.arange(64) % 3 != 0
    sj_state = sj_state.replace(active=jnp.asarray(active))
    kj = np.asarray(j_wf._sort_key(sj, sj_state, hj))
    s_t = t_pt.init_state(torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                          torch.tensor(np.asarray(rng).astype(np.int64)))
    s_t.active = torch.as_tensor(active)
    ht = {k: torch.tensor(np.asarray(v)) for k, v in hj.items()}
    ht["prim"] = ht["prim"].long()
    kt = t_wf._sort_key(st, s_t, ht)
    np.testing.assert_array_equal(kt.numpy(), kj.astype(np.int64))
    assert (kj == 0xFFFFFFFF).sum() >= (~active).sum() and len(np.unique(kj)) > 20


@pytest.mark.parametrize("compact", [False, True])
def test_wavefront_lanes_equal_composed(compact):
    """trace_paths_wavefront (K1's plain walk: traversal "pallas") against
    path_tracer.trace_paths on kitchen_stress(grid=2) 16x16, max_depth 6:
    the lanes come back permuted (pix), each equal to its composed value."""
    scene, cam, _ = t_ts.kitchen_stress(16, 16, grid=2, ns=6, nt=4)
    scene.traversal = "pallas"
    md = MaxDepthParams(max_depth=6)
    lane = torch.arange(256)
    o, d, rng = t_cam.generate_rays(cam, lane, t_qmc.make_state("pcg", 3, lane, 1))
    wl = t_pt.wl_stratum_u(3, 1, lane)
    L0 = t_pt.trace_paths(scene, md, o, d, rng, wl_u=wl)
    L, pix = t_wf.trace_paths_wavefront(scene, md, o, d, rng, compact=compact, wl_u=wl)
    assert sorted(pix.tolist()) == list(range(256)) and not torch.equal(pix, lane)
    out = torch.zeros_like(L).index_add_(0, pix, L)
    assert float(L0.mean()) > 0.05
    np.testing.assert_allclose(out.numpy(), L0.numpy(), rtol=EXACT_RTOL, atol=EXACT_ATOL)


def test_compact_ladder_matches_reference():
    assert t_wf.compact_sizes(4096) == [4096, 2048, 1024, 512, 256, 128]
    assert t_wf.compact_sizes(100) == [100]
    assert t_wf.compact_sizes(1 << 20, 7)[-1] == 1 << 14


def test_plastic_forward_renders_composed_and_matches_jax():
    """A Plastic-forward tall box lies outside the fused kernel: the
    Renderer's default route takes the composed path (pt.render_band), per
    pixel equal to JAX pt.render_sample, 8x8, max_depth 4, seed 6."""
    pfw = j_builder.BSDFSpec(btype=JT.BSDF_PLASTIC_FORWARD, k_d=(0.5, 0.4, 0.3))
    sj, cj, _ = j_ts.cornell_box(8, 8, tall_box_bsdf=pfw)
    img_j = np.asarray(j_pt.render_sample(sj, cj, JMD(max_depth=4), 6, 0, False))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    r = Renderer(_parsed(st, ct, MaxDepthParams(max_depth=4), seed=6), device="cpu")
    info = r.info()
    assert info["driver"] == "composed" and info["traversal"] == "xla"
    img = r.render(1)
    assert img_j.mean() > 0.01
    np.testing.assert_allclose(img, img_j, rtol=EXACT_RTOL, atol=EXACT_ATOL)


ROUTES = {
    # traversal: (renderer, expected info traversal, expected driver)
    "default": (None, RendererType.MEGAKERNEL_PT, "fused", "whole_path"),
    "fused": ("fused", RendererType.MEGAKERNEL_PT, "fused", "whole_path"),
    "xla": ("xla", RendererType.MEGAKERNEL_PT, "xla", "composed"),
    "pallas": ("pallas", RendererType.MEGAKERNEL_PT, "pallas", "composed"),
    "wide": ("wide", RendererType.MEGAKERNEL_PT, "wide", "composed"),
    "wavefront": (None, RendererType.WAVEFRONT_PT, "xla", "composed"),
    "wavefront_pallas": ("pallas", RendererType.WAVEFRONT_PT, "pallas", "composed"),
    "vpt_pallas": ("pallas", RendererType.VOLUME_PT, "pallas", "composed"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_renderer_routes_and_info(route):
    traversal, rtype, want_trav, want_driver = ROUTES[route]
    make = t_ts.medium_box if rtype == RendererType.VOLUME_PT else t_ts.cornell_box
    scene, cam, _ = make(6, 4)
    r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), renderer=rtype,
                 device="cpu", traversal=traversal)
    info = r.info()
    assert (info["traversal"], info["driver"], info["renderer"]) == (want_trav, want_driver,
                                                                    rtype.value)
    assert (r._pack is not None) == (want_driver != "composed")
    img = r.render(1)
    assert img.shape == (4, 6, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("traversal,err,match", [
    ("auto", NotImplementedError, "item 6"), ("mxu", NotImplementedError, "item 13"),
    ("bvh", ValueError, "unknown traversal"), ("fused_wavefront", ValueError, "megakernel PT")])
def test_renderer_traversal_errors(traversal, err, match):
    """Unknown and unported traversals raise; "auto" (item 6) is ported: it
    pins a tuned walk instead (accel/autotune.py)."""
    scene, cam, _ = t_ts.cornell_box(4, 4)
    rtype = RendererType.MEGAKERNEL_PT
    if traversal == "fused_wavefront":
        traversal, rtype = "fused", RendererType.WAVEFRONT_PT
    if traversal == "auto":
        r = Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), renderer=rtype,
                     device="cpu", traversal=traversal)
        assert r.info()["traversal"] in ("xla", "wide", "pallas")
        return
    with pytest.raises(err, match=match):
        Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=2)), renderer=rtype,
                 device="cpu", traversal=traversal)


SCENES = {
    "kitchen_pt": (lambda: t_ts.kitchen_stress(12, 8, grid=2, ns=6, nt=4),
                   RendererType.MEGAKERNEL_PT, ("xla", "pallas", "wide")),
    "kitchen_wavefront": (lambda: t_ts.kitchen_stress(12, 8, grid=2, ns=6, nt=4, forest_chunk=64),
                          RendererType.WAVEFRONT_PT, ("xla", "pallas", "wide")),
    "medium_box_vpt": (lambda: t_ts.medium_box(12, 8), RendererType.VOLUME_PT,
                       ("xla", "pallas")),
    "medium_cbox_vpt": (lambda: t_ts.medium_cbox(12, 8, ns=12, nt=6), RendererType.VOLUME_PT,
                        ("xla", "pallas")),
}


@pytest.mark.parametrize("kind", list(SCENES))
def test_walk_backends_render_the_same_lanes(kind):
    """The composed routes on the CPU under each walk backend, max_depth 5,
    one spp: every pixel at rtol 1e-5 / atol 1e-7. kitchen_wavefront walks
    its four-chunk forest under "pallas"; medium_cbox (240 triangles) walks
    its BVH as one chunk, medium_box (18) takes the brute force on all."""
    make, rtype, backends = SCENES[kind]
    scene, cam, _ = make()
    imgs = [Renderer(_parsed(scene, cam, MaxDepthParams(max_depth=5), seed=4), renderer=rtype,
                     device="cpu", traversal=trav).render(1) for trav in backends]
    assert imgs[0].mean() > 0.01
    for img in imgs[1:]:
        np.testing.assert_allclose(img, imgs[0], rtol=EXACT_RTOL, atol=EXACT_ATOL)


def test_wavefront_renderer_equals_render_sample():
    """Renderer(WAVEFRONT_PT) = wavefront.render_sample(compact=True) =
    path_tracer.render_sample, pixel for pixel (kitchen 8x8, two passes)."""
    scene, cam, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    md = MaxDepthParams(max_depth=4)
    r = Renderer(_parsed(scene, cam, md, seed=9), renderer=RendererType.WAVEFRONT_PT,
                 device="cpu", max_lanes_per_call=16)  # the wavefront is never banded
    passes = [r.render_raw() for _ in range(2)]
    for i, img in enumerate(passes):
        assert torch.equal(img, t_wf.render_sample(scene, cam, md, 9, i, compact=True))
        np.testing.assert_allclose(img.numpy(), t_pt.render_sample(scene, cam, md, 9, i).numpy(),
                                   rtol=EXACT_RTOL, atol=EXACT_ATOL)
    assert r.counter() == 2


def test_composed_routes_need_supported_scenes():
    """A media scene under the surface renderers raises naming VOLUME_PT on
    every route; Plastic-forward under traversal="fused" raises."""
    scene, cam, _ = t_ts.medium_box(4, 4)
    for rtype in (RendererType.MEGAKERNEL_PT, RendererType.WAVEFRONT_PT):
        with pytest.raises(ValueError, match="VOLUME_PT"):
            Renderer(_parsed(scene, cam, MaxDepthParams()), renderer=rtype, device="cpu",
                     traversal="pallas")
    pfw = BSDFSpec(btype=TT.BSDF_PLASTIC_FORWARD, k_d=(0.5, 0.5, 0.5))
    scene, cam, _ = t_ts.cornell_box(4, 4, tall_box_bsdf=pfw)
    with pytest.raises(ValueError, match="envelope"):
        Renderer(_parsed(scene, cam, MaxDepthParams()), device="cpu", traversal="fused")
