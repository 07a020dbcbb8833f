"""The port's debug renderers, AOVs and denoiser (models/debug_renderers.py,
models/denoise.py, utils/colormap.py, accel/traverse.closest_hit_bvh's
cost counts) against the JAX reference, and the Renderer's DEPTH and
BVH_COST routes, render_aovs and denoise on the CPU. Scenes are built
with the reference's builder and carried across by the bridge; the JAX
references run at 16x16, the denoiser jitted, with no Pallas call."""

import ast

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.accel import traverse as t_tr
from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import rng as t_rng
from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
from cuda_pt_torch.models import debug_renderers as t_dbg
from cuda_pt_torch.models import denoise as t_dn
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_torch.utils import colormap as t_cmap
from cuda_pt_tpu.accel import traverse as j_tr
from cuda_pt_tpu.models import debug_renderers as j_dbg
from cuda_pt_tpu.models import denoise as j_dn
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.utils import colormap as j_cmap
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene
from test_torch_swf_records import _j_textured_floor

RTOL, ATOL = 1e-5, 1e-6
SCENES = {
    "cornell": lambda: j_ts.cornell_box(16, 16)[:2],
    "kitchen": lambda: j_ts.kitchen_stress(16, 16, grid=2)[:2],
}


def _port(sj, cj):
    return (bridge.scene_from_numpy(flatten_jax_scene(sj)),
            bridge.camera_from_numpy(flatten_jax_camera(cj)))


@pytest.fixture(scope="module")
def cornell():
    sj, cj = SCENES["cornell"]()
    return sj, cj, *_port(sj, cj)


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=what)


@pytest.mark.parametrize("name", list(SCENES))
def test_closest_hit_bvh_cost_counts_match(name):
    """count_cost on 16x16 camera rays: node and prim counts equal on >= 99 %
    of rays (a slab test on a t one ulp apart may add a visit) and in their
    sums within 1e-3; prim ids equal."""
    sj, cj = SCENES[name]()
    st, ct = _port(sj, cj)
    o, d = t_dbg._primary_rays(ct, 0)
    hj = j_tr.closest_hit_bvh(sj.geom, sj.bvh, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                              count_cost=True, max_leaf=sj.bvh.max_leaf)
    ht = t_tr.closest_hit_bvh(st.geom, st.bvh, o, d, count_cost=True)
    np.testing.assert_array_equal(ht["prim"].numpy(), np.asarray(hj["prim"]))
    assert ht["prim"].ge(0).any()
    for k in ("node_cnt", "prim_cnt"):
        got, want = ht[k].numpy(), np.asarray(hj[k])
        assert got.dtype == np.int32
        assert (got == want).mean() >= 0.99, k
        assert abs(int(got.sum()) - int(want.sum())) <= 1e-3 * int(want.sum()), k
    plain = t_tr.closest_hit_bvh(st.geom, st.bvh, o, d)
    assert "node_cnt" not in plain and torch.equal(plain["t"], ht["t"])


def test_colormap_tables_equal_reference():
    np.testing.assert_array_equal(t_cmap.COLOR_MAPS.numpy(), np.asarray(j_cmap.COLOR_MAPS))
    x = np.linspace(-0.1, 1.1, 301, dtype=np.float32)
    for m in range(t_cmap.NUM_MAPS):
        np.testing.assert_array_equal(t_cmap.apply_colormap(torch.as_tensor(x), m).numpy(),
                                      np.asarray(j_cmap.apply_colormap(jnp.asarray(x), m)))
    with open(t_cmap.__file__) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not any((m or "").split(".")[0] == "matplotlib" for m in names), names


@pytest.mark.parametrize("log_scale", [False, True])
def test_render_depth_matches(cornell, log_scale):
    """depth, t_min and t_max within 4e-6 relative (the skip walk's rounding
    against XLA's), the colour image equal on >= 99 % of pixels."""
    sj, cj, st, ct = cornell
    img_j, aux_j = j_dbg.render_depth(sj, cj, log_scale=log_scale)
    img_t, aux_t = t_dbg.render_depth(st, ct, log_scale=log_scale)
    for k in ("depth", "t_min", "t_max"):
        np.testing.assert_allclose(aux_t[k].numpy(), np.asarray(aux_j[k]), rtol=4e-6, err_msg=k)
    assert (np.asarray(img_j) == img_t.numpy()).all(axis=-1).mean() >= 0.99
    brute, aux_b = t_dbg.render_depth(st, ct, log_scale=log_scale, use_bvh=False)
    np.testing.assert_allclose(aux_b["depth"].numpy(), aux_t["depth"].numpy(), rtol=4e-6)


@pytest.mark.parametrize("mode", ["node", "prim", "total"])
def test_render_bvh_cost_matches(cornell, mode, monkeypatch):
    """The counts equal on >= 99 % of rays, so the heatmap on >= 99 % of
    pixels; mean_cost within 1e-3 relative, max_cost within a visit. Both
    sides trace the reference's camera rays: the port's differ from them
    by an ulp in a third of the components (test_torch_core's camera-ray
    note), which moves 7 of cornell's 256 rays by two node visits at box
    edges; test_primary_rays_are_the_camera_streams holds the port's own."""
    sj, cj, st, ct = cornell
    o, d = (torch.as_tensor(np.array(a)) for a in j_dbg._primary_rays(cj, 0))
    monkeypatch.setattr(t_dbg, "_primary_rays", lambda cam, seed=0: (o, d))
    img_j, aux_j = j_dbg.render_bvh_cost(sj, cj, mode=mode)
    img_t, aux_t = t_dbg.render_bvh_cost(st, ct, mode=mode)
    assert (np.asarray(img_j) == img_t.numpy()).all(axis=-1).mean() >= 0.99
    np.testing.assert_allclose(float(aux_t["mean_cost"]), float(aux_j["mean_cost"]), rtol=1e-3)
    assert abs(float(aux_t["max_cost"]) - float(aux_j["max_cost"])) <= 1.0
    fixed, _ = t_dbg.render_bvh_cost(st, ct, mode=mode, max_cost=1.0)
    assert torch.equal(fixed, t_cmap.apply_colormap(torch.ones(16 * 16), 2).reshape(16, 16, 3))


@pytest.mark.parametrize("name", ["cornell", "textured_floor"])
def test_render_aovs_matches(name):
    if name == "cornell":
        sj, cj = SCENES["cornell"]()
    else:
        sj, cj = _j_textured_floor()
        cj = cj.replace(width=16, height=16, focal=cj.focal * 2.0)
    aj = j_dbg.render_aovs(sj, cj, spp=2, seed=3, use_bvh=True)
    st, ct = _port(sj, cj)
    at = t_dbg.render_aovs(st, ct, spp=2, seed=3, use_bvh=True)
    for k in ("albedo", "normal", "emission", "depth", "coverage"):
        _close(at[k], aj[k], k)
    if name == "textured_floor":  # some rays miss: the env branch runs
        assert 0.0 < float(at["coverage"].mean()) < 1.0


@pytest.fixture(scope="module")
def denoise_inputs():
    rs = np.random.default_rng(12)
    H = W = 16
    n = rs.normal(size=(H, W, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[:, : W // 2] = (0.0, 1.0, 0.0)  # a flat half, so the normal test passes taps
    return {
        "beauty": rs.gamma(2.0, 0.3, (H, W, 3)).astype(np.float32),
        "albedo": rs.uniform(0.0, 1.0, (H, W, 3)).astype(np.float32),
        "normal": n,
        "depth": rs.uniform(1.0, 3.0, (H, W)).astype(np.float32),
        "emission": np.where(rs.random((H, W, 1)) < 0.1, 2.0, 0.0).astype(np.float32)
        * np.ones((1, 1, 3), np.float32),
        "variance": rs.gamma(1.0, 0.05, (H, W)).astype(np.float32),
    }


@pytest.mark.parametrize("guided", [False, True])
def test_atrous_denoise_matches(denoise_inputs, guided):
    x = denoise_inputs
    keys = ("albedo", "normal", "depth", "emission")
    var = x["variance"] if guided else None
    run = jax.jit(lambda b, a, v: j_dn.atrous_denoise(b, a, variance=v))
    want = run(jnp.asarray(x["beauty"]), {k: jnp.asarray(x[k]) for k in keys},
               None if var is None else jnp.asarray(var))
    got = t_dn.atrous_denoise(torch.as_tensor(x["beauty"]),
                              {k: torch.as_tensor(x[k]) for k in keys},
                              variance=None if var is None else torch.as_tensor(var))
    _close(got, want, "denoised")
    assert not np.allclose(got.numpy(), x["beauty"], atol=1e-3)  # the filter moved pixels


def _renderer(st, ct, rtype, seed=0):
    cfg = RenderingConfig(width=ct.width, height=ct.height, md=MaxDepthParams(max_depth=3),
                          seed=seed)
    return Renderer(ParsedScene(st, ct, cfg), renderer=rtype, device="cpu")


def test_renderer_depth_and_bvh_cost_routes(cornell):
    """Each pass is the module's image; max_lanes_per_call does not band."""
    _, _, st, ct = cornell
    r = Renderer(ParsedScene(st, ct, RenderingConfig(width=16, height=16)),
                 renderer=RendererType.DEPTH, max_lanes_per_call=32, device="cpu")
    assert torch.equal(r.render_raw(), t_dbg.render_depth(st, ct, use_bvh=False)[0])
    r = _renderer(st, ct, RendererType.BVH_COST)
    np.testing.assert_array_equal(r.render(2), t_dbg.render_bvh_cost(st, ct)[0].numpy())
    assert r.info()["driver"] == "composed" and r.counter() == 2


def test_renderer_aovs_and_denoise(cornell):
    """render_aovs on the Renderer's seed, denoise's AOVs on seed + 7919; a
    film of one pass takes the plain filter, a film of two the variance of
    its mean."""
    _, _, st, ct = cornell
    r = _renderer(st, ct, RendererType.MEGAKERNEL_PT, seed=21)
    aovs = r.render_aovs(spp=2)
    want = t_dbg.render_aovs(st, ct, spp=2, seed=21, use_bvh=False)
    for k, v in want.items():
        np.testing.assert_array_equal(aovs[k], v.numpy(), err_msg=k)
    r.render(1)
    a2 = t_dbg.render_aovs(st, ct, spp=2, seed=21 + 7919, use_bvh=False)
    one = r.denoise(aov_spp=2)
    np.testing.assert_array_equal(one, r.denoise(aov_spp=2, variance_guided=False))
    np.testing.assert_array_equal(one, t_dn.atrous_denoise(r.film.mean, a2).numpy())
    r.render(1)
    var = torch.as_tensor(r.variance()) / 2
    np.testing.assert_array_equal(r.denoise(aov_spp=2),
                                  t_dn.atrous_denoise(r.film.mean, a2, variance=var).numpy())


def test_primary_rays_are_the_camera_streams(cornell):
    """_primary_rays: the pcg streams of seed over the pixel lanes, jittered
    by generate_rays."""
    _, _, _, ct = cornell
    lane = torch.arange(256)
    o, d, _ = t_cam.generate_rays(ct, lane, t_rng.seed(7, lane))
    o2, d2 = t_dbg._primary_rays(ct, 7)
    assert torch.equal(o, o2) and torch.equal(d, d2)
