"""The composed volume path tracer's grid route (models/volume_pt.py: delta
tracking, ratio and residual ratio tracking on the shadow segments, the
grid's blackbody emission) and the Renderer's VOLUME_PT route for grids
outside the fused envelope, against the JAX reference on the CPU.

grid_smoke at 8x8 with an 8^3 grid, max_depth 3: the port's lanes on the
reference's rays and pcg streams, held per lane (allclose rtol 1e-4, atol
1e-5 on >= 95 % of lanes, image means within 1e-3 relative); one gradient
w.r.t. media.scale at depth 2 (rtol 1e-3, atol 1e-6). The absorber and
null-slab cases of tests/test_fused_grid.py hold the composed route to
itself in the mean, at the reference's bounds (2 % and 12 %)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.core.config import RendererType, RenderingConfig
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec, EmitterSpec, MediumSpec, SceneBuilder
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import path_tracer as j_pt
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import EmitterSpec as JEmitterSpec
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

RTOL, ATOL, MIN_LANES, MEAN_REL = 1e-4, 1e-5, 0.95, 1e-3
W, SEED, DEPTH = 8, 3, 3
# (emission, envmap, GRID_TRANSMITTANCE) per case
CASES = {"emission_residual": (True, False, "residual"), "envmap_ratio": (False, True, "ratio")}


def _smoke(emission: bool, env: bool):
    """JAX grid_smoke (8^3 grid) with a temperature field and an emission
    scale, or with a constant envmap -> (JAX scene, JAX camera, port scene)."""
    _, cj, b = j_ts.grid_smoke(width=W, height=W, n=8)
    if emission:
        g = np.linspace(-1, 1, 8)
        zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
        b.grids[0]["emission"] = np.clip(1.0 - np.sqrt(xx ** 2 + yy ** 2 + zz ** 2), 0, 1
                                         ).astype(np.float32)
        b.media[0] = dataclasses.replace(b.media[0], emission_scale=2.0)
    if env:
        b.add_emitter(JEmitterSpec(etype=JT.EMITTER_ENVMAP, emission=(0.6, 0.7, 0.9),
                                   scaler=1.0, extra=(1.0, 0.0, 0.0, 0.0)))
    sj = b.compile()
    return sj, cj, bridge.scene_from_numpy(flatten_jax_scene(sj))


def _rays(cj, lanes):
    rng = j_qmc.make_state("pcg", SEED, lanes, 0)
    o, d, rng = j_cam.generate_rays(cj, lanes, rng)
    return o, d, rng, j_pt.wl_stratum_u(SEED, 0, lanes)


def _torch(*xs):
    return [torch.tensor(np.asarray(x).astype(np.int64 if np.asarray(x).dtype == np.uint32
                                               else np.asarray(x).dtype)) for x in xs]


def _hold(Lt, Lj):
    close = np.isclose(Lt, Lj, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    assert close.mean() >= MIN_LANES, (close.mean(), np.abs(Lt - Lj).max())
    assert abs(Lt.mean() - Lj.mean()) <= MEAN_REL * abs(Lj.mean()), (Lt.mean(), Lj.mean())


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One JAX composed render per case, computed once: the reference's
    trace_paths on the Renderer's first pass (lane = pixel, sample 0)."""
    emission, env, est = CASES[request.param]
    sj, cj, st = _smoke(emission, env)
    lanes = jnp.arange(W * W, dtype=jnp.int32)
    o, d, rng, wl_u = _rays(cj, lanes)
    old = j_vpt.GRID_TRANSMITTANCE
    j_vpt.GRID_TRANSMITTANCE = est
    try:
        Lj = np.asarray(j_vpt.trace_paths(sj, JMD(max_depth=DEPTH, max_volume=5), o, d, rng,
                                          use_bvh=False, wl_u=wl_u))
    finally:
        j_vpt.GRID_TRANSMITTANCE = old
    return {"st": st, "rays": _torch(o, d, rng, wl_u), "Lj": Lj, "est": est, "cam": cj,
            "emission": emission, "env": env}


def test_grid_route_matches_jax(case, monkeypatch):
    """trace_paths on the reference's rays and streams: per lane, with the
    grid's emission or under an envmap, either transmittance estimator."""
    monkeypatch.setattr(t_vpt, "GRID_TRANSMITTANCE", case["est"])
    o, d, rng, wl_u = case["rays"]
    Lt = t_vpt.trace_paths(case["st"], TMD(max_depth=DEPTH, max_volume=5), o, d, rng,
                           wl_u=wl_u).numpy()
    _hold(Lt, case["Lj"])


def test_renderer_takes_the_composed_grid_route(case, monkeypatch):
    """A grid with emission or under an envmap is outside the fused
    envelope: Renderer(VOLUME_PT, device="cpu") renders it on the composed
    route, its first pass held per lane to the reference's."""
    monkeypatch.setattr(t_vpt, "GRID_TRANSMITTANCE", case["est"])
    st = case["st"]
    assert not t_mk.megakernel_ok(st, TMD(), renderer="vpt")
    cam = bridge.camera_from_numpy(flatten_jax_camera(case["cam"]))
    parsed = ParsedScene(st, cam, RenderingConfig(width=W, height=W, seed=SEED,
                                                  md=TMD(max_depth=DEPTH, max_volume=5)))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, device="cpu")
    info = r.info()
    assert (info["driver"], info["has_grid"]) == ("composed", True)
    _hold(r.render_raw().reshape(-1, 3).numpy(), case["Lj"])


def test_grid_gradient_matches_jax():
    """d(sum L)/d(media.scale) of the differentiable composed render at
    depth 2 (the fixed roulette schedule, the reference's detach sites in
    the tracking loops), against jax.grad of the reference's."""
    sj, cj, st = _smoke(emission=True, env=False)
    lanes = jnp.arange(W * W, dtype=jnp.int32)
    o, d, rng, wl_u = _rays(cj, lanes)

    def loss(scale):
        s = sj.replace(media=sj.media.replace(scale=scale))
        return j_vpt.trace_paths(s, JMD(max_depth=2, max_volume=5), o, d, rng, use_bvh=False,
                                 differentiable=True, wl_u=wl_u).sum()

    gj = np.asarray(jax.grad(loss)(sj.media.scale))
    scale = st.media.scale.clone().requires_grad_(True)
    s = dataclasses.replace(st, media=dataclasses.replace(st.media, scale=scale))
    L = t_vpt.trace_paths(s, TMD(max_depth=2, max_volume=5), *_torch(o, d, rng),
                          differentiable=True, wl_u=_torch(wl_u)[0])
    L.sum().backward()
    assert abs(float(gj[0])) > 1e-4
    np.testing.assert_allclose(scale.grad.numpy(), gj, rtol=1e-3, atol=1e-6)


def _absorber_scene(kind: str, sig: float = 2.0):
    """tests/test_fused_grid.py's slab between a floor and a ceiling light,
    out of the camera's frustum, in the port's builder: kind "grid" (a
    constant zero-albedo grid), "hom" (the equivalent homogeneous
    absorber), "vac" (null faces round a sigma = 0 medium) or "none" (no
    slab)."""
    b = SceneBuilder()
    white = b.add_bsdf(BSDFSpec(k_d=(0.7, 0.7, 0.7)))
    fwd = b.add_bsdf(BSDFSpec(btype=TT.BSDF_FORWARD))
    em = b.add_emitter(EmitterSpec(etype=TT.EMITTER_AREA, emission=(1, 1, 1), scaler=6.0))
    q = t_ts.quad
    b.add_mesh(q([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), white, emitter_id=em)
    y0, y1 = 0.2, 1.2
    if kind != "none":
        if kind == "grid":
            gid = b.add_grid(np.full((8, 8, 8), sig, np.float32), (-1, y0, -1), (1, y1, 1))
            med = b.add_medium(MediumSpec(mtype=TT.MEDIUM_GRID, grid_id=gid, scale=1.0))
        else:
            sa = sig if kind == "hom" else 0.0
            med = b.add_medium(MediumSpec(sigma_a=(sa, sa, sa), scale=1.0))
        cube = np.concatenate([
            q([-1, y0, -1], [1, y0, -1], [1, y1, -1], [-1, y1, -1]),
            q([1, y0, 1], [-1, y0, 1], [-1, y1, 1], [1, y1, 1]),
            q([-1, y0, 1], [-1, y0, -1], [-1, y1, -1], [-1, y1, 1]),
            q([1, y0, -1], [1, y0, 1], [1, y1, 1], [1, y1, -1]),
            q([-1, y1, -1], [1, y1, -1], [1, y1, 1], [-1, y1, 1]),
            q([-1, y0, 1], [1, y0, 1], [1, y0, -1], [-1, y0, -1])], axis=0)
        b.add_mesh(cube, fwd, medium_in=med, cullable=True)
    b.add_mesh(q([-3, -1.2, -3], [3, -1.2, -3], [3, -1.2, 3], [-3, -1.2, 3]), white)
    from cuda_pt_torch.core import camera as t_cam

    cam = t_cam.make_camera((0, -0.2, -4.0), (0, -1.2, -0.3), fov=22, width=12, height=12)
    return b.compile(), cam


def test_grid_absorber_matches_homogeneous_slab():
    """A constant zero-albedo grid against the equivalent homogeneous slab,
    the shadow segment its only medium interaction: residual ratio tracking
    is exact on a constant grid, so the two composed images agree in the
    mean within the reference's 2 % (they differ only by the light samples
    the extra tracking draws move)."""
    md = TMD(max_depth=1, max_volume=8)
    means = {k: float(t_vpt.render(*_absorber_scene(k), md, spp=16, seed=0).mean())
             for k in ("hom", "grid")}
    assert means["hom"] > 1e-4, means
    assert abs(means["hom"] - means["grid"]) / means["hom"] < 0.02, means


def test_nee_through_null_slab_matches_slab_free_render():
    """tests/test_fused_grid.py's regression on the composed route: a sigma =
    0 slab behind null faces is nothing, so NEE through it matches the
    slab-free surface render within the reference's 12 %."""
    md = TMD(max_depth=1, max_volume=8)
    comp = float(t_vpt.render(*_absorber_scene("vac"), md, spp=32, seed=0).mean())
    ref = float(t_pt.render(*_absorber_scene("none"), md, spp=32, seed=0).mean())
    assert ref > 1e-3
    assert abs(comp - ref) / ref < 0.12, (comp, ref)


def test_fused_whole_path_loop_still_refuses_grids():
    """The fused whole-path loop keeps refusing grid media, as the
    reference routes them to the split driver."""
    scene = t_ts.grid_smoke(4, 4)[0]
    o, d = torch.zeros((1, 3)), torch.ones((1, 3))
    with pytest.raises(NotImplementedError, match="K6"):
        t_vpt.trace_paths(scene, TMD(), o, d, torch.zeros((1, 2), dtype=torch.int64),
                          fused=True)
