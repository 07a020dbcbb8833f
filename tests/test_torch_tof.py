"""ToF gating, batched passes and tiled renders of the port against the JAX
reference and against the port's own render: ToF windows partition the
energy, gated path-traced and volume path-traced renders match JAX's, the
Renderer renders a gated config on the composed route (and "fused" refuses
it), render(samples_per_pass=k) and render_tiled match JAX's render and
the port's.

Contract against JAX: the composed holds' per-lane allclose(rtol 1e-4,
atol 1e-5) on >= 95 % of lanes, image means within 1e-3 relative."""

import jax
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.core.config import RendererType, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_diff import _bridge, _lanes_hold, medium_cube

WINDOW = dict(min_time=0.0, max_time=3.4)  # camera-to-wall path lengths are ~1.3-3


def test_tof_gating_partitions_energy():
    """tests/test_tof_checkpoint.py::test_tof_gating_partitions_energy on
    the port (12x12, 8 spp): two adjacent windows sum to the ungated
    image."""
    scene, cam, _ = t_ts.cornell_box(12, 12)
    kw = dict(max_depth=4)
    img = t_pt.render(scene, cam, TMD(**kw), 8, seed=7, use_bvh=False).numpy()
    a = t_pt.render(scene, cam, TMD(**kw, **WINDOW), 8, seed=7, use_bvh=False).numpy()
    b = t_pt.render(scene, cam, TMD(**kw, min_time=3.4, max_time=1e6), 8, seed=7,
                    use_bvh=False).numpy()
    assert a.mean() > 0.0 and b.mean() > 0.0
    assert a.mean() < img.mean()  # gating removes energy
    np.testing.assert_allclose(a + b, img, atol=1e-3)  # the windows partition it


@pytest.mark.parametrize("tracer", ["pt", "vpt"])
def test_tof_render_matches_jax(tracer):
    """A gated render (the path tracer on cornell 12x12, max_depth 4,
    window [0, 3.4]; the volume path tracer on the medium cube 10x10,
    window [1.5, 4]) against JAX's, 2 spp."""
    if tracer == "pt":
        sj, cj, _ = j_ts.cornell_box(width=12, height=12)
        kw, window, render_j, render_t = dict(max_depth=4), WINDOW, j_pt.render, t_pt.render
    else:
        sj, cj = medium_cube(10)
        kw = dict(max_depth=4, max_volume=3)
        window, render_j, render_t = dict(min_time=1.5, max_time=4.0), j_vpt.render, t_vpt.render
    st, ct = _bridge(sj, cj)
    img_j = jax.jit(lambda s: render_j(s, cj, JMD(**kw, **window), spp=2, seed=7,
                                       use_bvh=False))(sj)
    img_t = render_t(st, ct, TMD(**kw, **window), 2, seed=7, use_bvh=False)
    ungated = render_t(st, ct, TMD(**kw), 2, seed=7, use_bvh=False)
    assert 0.0 < float(img_t.mean()) < float(ungated.mean())
    _lanes_hold(img_t.numpy(), img_j)


def _parsed(scene, cam, md, seed=0):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                   seed=seed))


@pytest.mark.parametrize("route", ["cornell", "kitchen_pallas", "vpt"])
def test_gated_renderer_takes_composed_route(route):
    """A Renderer whose config gates ToF renders on the composed route (the
    brute force on cornell, K1's plain version under "pallas" on a small
    kitchen, the composed volume path tracer on medium_box): each pass
    equals the gated composed render's, and traversal="fused" raises the
    envelope's ValueError."""
    md = TMD(max_depth=3, min_time=0.5, max_time=4.0)
    rtype, traversal = RendererType.MEGAKERNEL_PT, None
    if route == "cornell":
        scene, cam, _ = t_ts.cornell_box(8, 8)
    elif route == "kitchen_pallas":
        scene, cam, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
        traversal = "pallas"
    else:
        scene, cam, _ = t_ts.medium_box(8, 8)
        rtype = RendererType.VOLUME_PT
    parsed = _parsed(scene, cam, md, seed=5)
    with pytest.raises(ValueError, match="ToF"):
        Renderer(parsed, renderer=rtype, traversal="fused", device="cpu")
    r = Renderer(parsed, renderer=rtype, traversal=traversal, device="cpu")
    assert r.info()["driver"] == "composed"
    got = torch.stack([r.render_raw() for _ in range(2)])
    if rtype == RendererType.VOLUME_PT:
        want = t_vpt.render(r.scene, cam, md, 1, seed=5)[None]
        got = got[:1]
    else:
        want = torch.stack([t_pt.render_sample(r.scene, cam, md, 5, i) for i in range(2)])
    assert torch.equal(got, want)
    ungated = Renderer(_parsed(scene, cam, TMD(max_depth=3), seed=5), renderer=rtype,
                       traversal=traversal, device="cpu").render_raw()
    assert 0.0 < float(got[0].mean()) < float(ungated.mean())


@pytest.fixture(scope="module")
def cbox16():
    """cornell 16x16, max_depth 3, 4 spp, seed 6: the port's render and
    JAX's (the reference's own tests hold its batched and tiled renders
    to it: tests/test_pt_firstlight.py:86-107)."""
    sj, cj, _ = j_ts.cornell_box(width=16, height=16)
    st, ct = _bridge(sj, cj)
    md_t = TMD(max_depth=3)
    plain = t_pt.render(st, ct, md_t, 4, seed=6, use_bvh=False).numpy()
    img_j = jax.jit(lambda s: j_pt.render(s, cj, JMD(max_depth=3), spp=4, seed=6,
                                          use_bvh=False))(sj)
    return st, ct, md_t, plain, np.asarray(img_j)


def test_batched_passes_match(cbox16):
    """render(samples_per_pass=4): lane l is pixel l // 4, sample l % 4 on
    render_sample's streams; against JAX's render and, as
    tests/test_pt_firstlight.py::test_batched_passes_match_sequential holds
    the reference, against the port's sequential render."""
    st, ct, md_t, plain, img_j = cbox16
    img_t = t_pt.render(st, ct, md_t, 4, seed=6, use_bvh=False, samples_per_pass=4).numpy()
    _lanes_hold(img_t, img_j)
    assert np.isclose(plain, img_t, atol=1e-4).mean() > 0.95
    assert abs(plain.mean() - img_t.mean()) < 0.01
    with pytest.raises(AssertionError):
        t_pt.render(st, ct, md_t, 4, samples_per_pass=3)


def test_tiled_render_matches(cbox16):
    """render_tiled in bands of 5 rows (the last cut to the image): the
    port's render bit for bit, and JAX's render at the contract."""
    st, ct, md_t, plain, img_j = cbox16
    img_t = t_pt.render_tiled(st, ct, md_t, 4, seed=6, use_bvh=False, rows_per_tile=5)
    assert isinstance(img_t, np.ndarray) and img_t.shape == (16, 16, 3)
    np.testing.assert_array_equal(img_t, plain)
    _lanes_hold(img_t, img_j)
