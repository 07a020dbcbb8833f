"""Adaptive sampling (cuda_pt_torch/models/adaptive.py) and
Renderer.render_adaptive against the JAX reference at 16x16 (cornell,
max_depth 3, budget 4, base 2), with pcg and with Sobol: per-pixel counts
equal exactly, image and variance per pixel allclose(rtol 1e-4, atol
1e-5) on >= 95 % of pixels with means within 1e-3 relative. The
reference's Renderer never takes its kernel route on the CPU, so both
Renderers pin traversal="xla"; one JAX compile per sampler, shared by the
module's tests. No Pallas call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import film as t_film
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.core.config import RenderingConfig as TRC
from cuda_pt_torch.models import adaptive as t_ad
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene.xml_parser import ParsedScene as TParsed
from cuda_pt_tpu import api as j_api
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.core.config import RenderingConfig as JRC
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene.xml_parser import ParsedScene as JParsed
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

SIZE, DEPTH, BUDGET, BASE, SEED = 16, 3, 4, 2, 3


def _hold(t: np.ndarray, j: np.ndarray):
    close = np.isclose(t, j, rtol=1e-4, atol=1e-5)
    close = close.all(axis=-1) if close.ndim == 3 else close
    assert np.isfinite(t).all() and j.mean() > 0.0
    assert close.mean() >= 0.95, (close.mean(), np.abs(t - j).max())
    assert abs(t.mean() - j.mean()) <= 1e-3 * abs(j.mean()), (t.mean(), j.mean())


@pytest.fixture(scope="module")
def cornell():
    sj, cj, _ = j_ts.cornell_box(SIZE, SIZE)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    return sj, cj, st, ct


@pytest.fixture(scope="module", params=["pcg", "sobol"])
def jax_adaptive(request, cornell):
    """JAX's Renderer.render_adaptive(BUDGET) on the composed route: its
    film (mean, weight = n, m2, count)."""
    sj, cj, _, _ = cornell
    cfg = JRC(width=SIZE, height=SIZE, md=JMD(max_depth=DEPTH), seed=SEED)
    r = j_api.Renderer(JParsed(sj, cj, cfg, None), traversal="xla", sampler=request.param)
    img = np.asarray(r.render_adaptive(BUDGET))
    f = r.film
    return {"sampler": request.param, "img": img, "n": np.asarray(f.weight),
            "m2": np.asarray(f.m2), "count": int(f.count)}


@pytest.fixture(scope="module")
def port_adaptive(cornell, jax_adaptive):
    """The port's adaptive.render_adaptive on the same inputs: (image, n,
    variance of the mean)."""
    _, _, st, ct = cornell
    return t_ad.render_adaptive(st, ct, TMD(max_depth=DEPTH), BUDGET, base_spp=BASE, seed=SEED,
                                use_bvh=False, sampler=jax_adaptive["sampler"],
                                return_variance=True)


def _port_renderer(cornell, sampler: str) -> Renderer:
    _, _, st, ct = cornell
    cfg = TRC(width=SIZE, height=SIZE, md=TMD(max_depth=DEPTH), seed=SEED)
    return Renderer(TParsed(st, ct, cfg), traversal="xla", sampler=sampler, device="cpu")


def test_composed_adaptive_matches_jax(jax_adaptive, port_adaptive):
    """adaptive.render_adaptive (composed PT, base 2): counts exact, image
    and variance of the mean at the contract (JAX's variance read back
    from its film's m2)."""
    img, n, var = port_adaptive
    assert img.shape == (SIZE, SIZE, 3) and n.shape == var.shape == (SIZE, SIZE)
    np.testing.assert_array_equal(n.numpy(), jax_adaptive["n"])
    assert n.max() > BUDGET and n.min() == BASE  # the rounds concentrated somewhere
    _hold(img.numpy(), jax_adaptive["img"])
    cnt = jax_adaptive["count"]
    _hold(var.numpy(), jax_adaptive["m2"] / (cnt * (cnt - 1)))


def test_renderer_render_adaptive_matches_jax(cornell, jax_adaptive, port_adaptive):
    """The film rule: mean the image, weight the counts, count the largest
    count (at least 2), m2 = var * cnt * (cnt - 1); a later render(2)
    folds the passes at sample indices cnt and cnt + 1 into that film, as
    the reference's render_raw does, bit for bit."""
    sampler = jax_adaptive["sampler"]
    r = _port_renderer(cornell, sampler)
    img = r.render_adaptive(BUDGET)
    assert isinstance(img, np.ndarray) and img.shape == (SIZE, SIZE, 3)
    cnt = jax_adaptive["count"]
    assert r.counter() == cnt == max(int(np.ceil(jax_adaptive["n"].max())), 2)
    np.testing.assert_array_equal(r.film.weight.numpy(), jax_adaptive["n"])
    np.testing.assert_array_equal(r.film.mean.numpy(), img)
    _hold(r.film.m2.numpy(), jax_adaptive["m2"])
    assert torch.equal(r.film.m2, port_adaptive[2] * cnt * (cnt - 1))
    film = r.film
    for idx in (cnt, cnt + 1):
        film = t_film.accumulate(film, t_pt.render_sample(r.scene, r.camera, r.md, SEED, idx,
                                                          sampler=sampler))
    r.render(2)
    assert r.counter() == film.count == cnt + 2
    for k in ("mean", "m2", "weight"):
        assert torch.equal(getattr(r.film, k), getattr(film, k)), k


def test_tile_pick_ties_like_top_k():
    """Equal tile errors (zero-variance tiles: emitters, background) pick
    lower index first, as jax.lax.top_k does."""
    rs = np.random.default_rng(8)
    err = rs.choice(np.array([0.0, 0.25, 0.5, 1.0], np.float32), 64)
    err[rs.choice(64, 9, replace=False)] = 0.0
    for k in (1, 5, 16, 40, 64):
        want = np.asarray(jax.lax.top_k(jnp.asarray(err), k)[1])
        np.testing.assert_array_equal(t_ad.pick_tiles(torch.as_tensor(err), k).numpy(), want)


def test_fused_pack_adaptive_matches_composed():
    """fused_pack drives auto_trace (K2's plain version on the CPU): the
    same counts as the composed adaptive render, means within 5 % (the
    reference's test_adaptive.py); the pack takes pcg only."""
    scene, cam, _ = t_ts.cornell_box(SIZE, SIZE)
    md = TMD(max_depth=DEPTH)
    pack = t_mk.make_pack(scene)
    img_f, n_f = t_ad.render_adaptive(scene, cam, md, spp_budget=4, seed=3, use_bvh=True,
                                      fused_pack=pack)
    img_c, n_c = t_ad.render_adaptive(scene, cam, md, spp_budget=4, seed=3, use_bvh=True)
    assert bool(torch.isfinite(img_f).all())
    np.testing.assert_array_equal(n_f.numpy(), n_c.numpy())
    assert abs(float(img_f.mean()) / float(img_c.mean()) - 1.0) < 0.05
    with pytest.raises(ValueError, match="pcg"):
        t_ad.render_adaptive(scene, cam, md, 4, sampler="sobol", fused_pack=pack)


def test_tiny_budget_and_tile_fallback():
    """Budget 2 takes base 1 (the reference's fall-back); a 12x10 frame
    takes 2x2 tiles; the samples add up to base passes plus rounds."""
    scene, cam, _ = t_ts.cornell_box(SIZE, SIZE)
    img, n = t_ad.render_adaptive(scene, cam, TMD(max_depth=DEPTH), 2, seed=1, use_bvh=False)
    assert bool(torch.isfinite(img).all()) and float(n.mean()) >= 1.9
    scene, cam, _ = t_ts.cornell_box(12, 10)
    img, n = t_ad.render_adaptive(scene, cam, TMD(max_depth=DEPTH), 3, seed=1, use_bvh=False)
    K = int(30 * 0.25)  # 6 x 5 tiles of 2x2
    rounds = ((3 - 1) * 120) // (K * 4)
    assert float(n.sum()) == 120 + rounds * K * 4 and bool(torch.isfinite(img).all())
    with pytest.raises(ValueError, match="exceed"):
        t_ad.render_adaptive(scene, cam, TMD(max_depth=DEPTH), 2, base_spp=2)


def test_adaptive_vpt_tracer():
    """tracer="vpt" renders a medium scene through volume_pt.trace_paths:
    finite, with every warm-up and round sample counted."""
    scene, cam, _ = t_ts.cornell_vpt(8, 8)
    img, n, var = t_ad.render_adaptive(scene, cam, TMD(max_depth=3), 3, seed=2, use_bvh=False,
                                       tracer="vpt", return_variance=True)
    K = int(4 * 0.25)  # 2 x 2 tiles of 4x4
    assert float(n.sum()) == 64 + ((3 - 1) * 64 // (K * 16)) * K * 16
    assert bool(torch.isfinite(img).all()) and bool((var >= 0).all()) and float(img.mean()) > 0
