"""Grid media in the port against the JAX reference: media/grid.py function
by function, the grid_smoke scene, and the split sorted-wavefront driver
(kernel K6, K5's shade phase, delta-tracked flight and ratio-tracked NEE
between launches; their plain versions on the CPU) against JAX's split
driver in interpret mode.

Contracts: each media/grid.py function equals the reference's at rtol 1e-5
on the same inputs and pcg states; the scene arrays are equal; the split
driver meets the per-lane contract allclose(rtol 1e-4, atol 1e-5) on
>= 98 % of lanes with the image means within 5e-3."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.api import Renderer
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.core.config import RendererType, RenderingConfig
from cuda_pt_torch.media import grid as t_grid
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import EmitterSpec, MediumSpec
from cuda_pt_torch.scene.xml_parser import ParsedScene
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.media import grid as j_grid
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from test_torch_bridge import TABLES, flatten_jax_scene, numpy_bvh_builds

RTOL, ATOL, MAX_LANE_FRAC, MEAN_TOL = 1e-4, 1e-5, 0.02, 5e-3
B = 512


def _inputs(seed=0):
    """Seeded grids (two of 9 x 7 x 5 voxels), media referencing them and
    per-lane positions, directions, distances and pcg states."""
    rs = np.random.default_rng(seed)
    dens = rs.uniform(0.0, 3.0, (2, 9, 7, 5)).astype(np.float32)
    emis = rs.uniform(0.0, 1.0, (2, 9, 7, 5)).astype(np.float32)
    g = dict(density=dens, emission=emis,
             bbox_min=np.array([[-1, -1, -1], [0, 0.5, -0.5]], np.float32),
             bbox_max=np.array([[1, 1, 1], [1.5, 2, 1]], np.float32),
             majorant=dens.max(axis=(1, 2, 3)), avg_density=dens.mean(axis=(1, 2, 3)))
    media = dict(grid_id=np.array([0, 1, 0], np.int32), scale=np.array([1.0, 0.7, 2.0], np.float32),
                 sigma_s=np.array([[0.9, 0.8, 0.7], [0.5, 0.5, 0.5], [1, 1, 1]], np.float32),
                 emission_scale=np.array([1.0, 0.0, 2.5], np.float32))
    d = rs.normal(size=(B, 3)).astype(np.float32)
    lanes = dict(
        mid=rs.integers(0, 3, B).astype(np.int32),
        o=rs.uniform(-1.2, 1.2, (B, 3)).astype(np.float32),
        d=(d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
        dist=rs.uniform(0.0, 3.0, B).astype(np.float32),
        rng=rs.integers(0, 2 ** 32, (B, 2), dtype=np.uint64).astype(np.uint32),
        active=rs.uniform(size=B) < 0.9,
        temp=rs.uniform(500.0, 9000.0, B).astype(np.float32))
    return g, media, lanes


def _sides(seed=0):
    g, media, lanes = _inputs(seed)
    jx = types.SimpleNamespace(grids=JT.GridMediumData(**{k: jnp.asarray(v) for k, v in g.items()}),
                               media=types.SimpleNamespace(**{k: jnp.asarray(v)
                                                              for k, v in media.items()}))
    tx = types.SimpleNamespace(grids=TT.GridMediumData(**{k: torch.as_tensor(v)
                                                          for k, v in g.items()}),
                               media=types.SimpleNamespace(**{k: torch.as_tensor(v)
                                                              for k, v in media.items()}))
    lj = {k: jnp.asarray(v) for k, v in lanes.items()}
    lt = {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.uint32 else v)
          for k, v in lanes.items()}
    return jx, tx, lj, lt


def _close(t, j, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def test_density_lookup_and_emission_match_reference():
    jx, tx, lj, lt = _sides(1)
    gid_j = jx.media.grid_id[lj["mid"]]
    gid_t = tx.media.grid_id[lt["mid"].long()]
    for field in ("density", "emission"):
        _close(t_grid.density_lookup(tx.grids, gid_t, lt["o"], field),
               j_grid.density_lookup(jx.grids, gid_j, lj["o"], field), atol=1e-6)
    _close(t_grid.blackbody_rgb(lt["temp"]), j_grid.blackbody_rgb(lj["temp"]))
    _close(t_grid.query_emission(tx, lt["mid"], lt["o"]),
           j_grid.query_emission(jx, lj["mid"], lj["o"]), atol=1e-6)


def test_tracking_matches_reference():
    """Delta tracking (flight), ratio tracking and residual ratio tracking:
    the same values from the same pcg states, and the same states after
    MAX_TRACK_STEPS draws."""
    assert t_grid.MAX_TRACK_STEPS == j_grid.MAX_TRACK_STEPS == 64
    jx, tx, lj, lt = _sides(2)
    t_surf_j, t_surf_t = lj["dist"] + 0.5, lt["dist"] + 0.5
    rj, sj = j_grid.sample_distance_grid(jx, lj["mid"], lj["o"], lj["d"], t_surf_j, lj["rng"],
                                         lj["active"])
    rt, s_t = t_grid.sample_distance_grid(tx, lt["mid"], lt["o"], lt["d"], t_surf_t, lt["rng"],
                                          lt["active"])
    _close(rt["t"], rj["t"])
    _close(rt["weight"], rj["weight"])
    np.testing.assert_array_equal(rt["is_medium"].numpy(), np.asarray(rj["is_medium"]))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj).astype(np.int64))
    assert 0.1 < float(rt["is_medium"].float().mean()) < 0.9
    for fn in ("transmittance_grid", "transmittance_grid_residual"):
        trj, sj = getattr(j_grid, fn)(jx, lj["mid"], lj["o"], lj["d"], lj["dist"], lj["rng"],
                                      lj["active"])
        trt, s_t = getattr(t_grid, fn)(tx, lt["mid"], lt["o"], lt["d"], lt["dist"], lt["rng"],
                                       lt["active"])
        _close(trt, trj, atol=1e-7)
        np.testing.assert_array_equal(s_t.numpy(), np.asarray(sj).astype(np.int64))
        assert 0.05 < float(trt.mean()) < 0.95, fn


@pytest.fixture(scope="module")
def smoke():
    """grid_smoke 8x8 from both builders, each with its NumPy BVH."""
    mp = pytest.MonkeyPatch()
    numpy_bvh_builds(mp)
    try:
        sj, cj, _ = j_ts.grid_smoke(8, 8)
        st, ct, _ = t_ts.grid_smoke(8, 8)
    finally:
        mp.undo()
    return sj, cj, st, ct


def test_grid_smoke_scene_arrays_equal(smoke):
    sj, cj, st, ct = smoke
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        for f in table.__dataclass_fields__:
            got = getattr(table, f)
            got = got.numpy() if torch.is_tensor(got) else got
            np.testing.assert_array_equal(got, flat[f"{name}.{f}"], err_msg=f"{name}.{f}")
    for f in ("R", "t", "focal"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), f)
    pack = t_mk.make_pack(st, node_fmt="w8", vpt=True)
    pack_j = j_mk.make_pack(sj, node_fmt="w8", vpt=True)
    assert pack.has_grid and pack_j.has_grid and t_mk.megakernel_ok(st, TMD(), renderer="vpt")
    for k in ("mrow", "g_hit", "tlbox", "gr_gscale", "gr_isg"):
        np.testing.assert_array_equal(pack[k].numpy(), np.asarray(pack_j[k]), err_msg=k)


def test_split_driver_matches_jax_interpret(smoke):
    """The port's split driver on the CPU against JAX's (interpret mode),
    8x8, max_depth 3, key_mode "pos_dir" (auto_trace's), on the same rays:
    the per-lane contract; the same driver unsorted gives the same lanes."""
    sj, cj, _, _ = smoke
    md_j, md_t = JMD(max_depth=3), TMD(max_depth=3)
    lane = jnp.arange(64, dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", 4, lane, 2)
    o, d, rng = j_cam.generate_rays(cj, lane, rng)
    pack_j = j_mk.make_pack(sj, node_fmt="w8", vpt=True)
    Lj = np.asarray(j_mk.trace_megakernel_swf(pack_j, md_j, o, d, rng, interpret=True,
                                              key_mode="pos_dir"))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pack = t_mk.make_pack(st, node_fmt="w8", vpt=True)
    ot, dt_, rt = (torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
                   torch.tensor(np.asarray(rng).astype(np.int64)))
    Lt = t_mk.auto_trace(pack, md_t, ot, dt_, rt)
    close = np.isclose(Lt.numpy(), Lj, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert np.isfinite(Lt.numpy()).all() and Lj.mean() > 0.01
    assert close.mean() >= 1.0 - MAX_LANE_FRAC, (close.mean(), np.abs(Lt.numpy() - Lj).max())
    assert abs(float(Lt.mean()) - float(Lj.mean())) < MEAN_TOL
    L_none = t_mk.trace_megakernel_swf(pack, md_t, ot, dt_, rt, key_mode="none")
    assert torch.equal(L_none, Lt)


def _parsed(scene, cam, md=None):
    return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height,
                                                   md=md or TMD(max_depth=4), seed=0))


def test_renderer_renders_grid_smoke_on_the_cpu():
    scene, cam, _ = t_ts.grid_smoke(8, 6)
    r = Renderer(_parsed(scene, cam), renderer=RendererType.VOLUME_PT, device="cpu")
    assert r.info()["driver"] == "swf_split" and r.info()["has_grid"]
    img = r.render(2)
    assert img.shape == (6, 8, 3) and np.isfinite(img).all() and img.mean() > 0.01


def test_grid_envelope_rules():
    """As the reference: a grid medium with an envmap or with emission stays
    outside the fused route; the Renderer names what waits."""
    _, _, b = t_ts.grid_smoke(8, 8)
    b.add_emitter(EmitterSpec(etype=TT.EMITTER_ENVMAP, emission=(1, 1, 1), scaler=1.0,
                              extra=(1.0, 0.0, 0.0, 0.0)))
    scene = b.compile()
    assert not t_mk.megakernel_ok(scene, TMD(), renderer="vpt")
    _, cam, b = t_ts.grid_smoke(8, 8)
    b.add_medium(MediumSpec(mtype=TT.MEDIUM_GRID, grid_id=0, emission_scale=1.0))
    scene = b.compile()
    assert not t_mk.megakernel_ok(scene, TMD(), renderer="vpt")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Renderer(_parsed(scene, cam), renderer=RendererType.VOLUME_PT, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        t_vpt.trace_paths(t_ts.grid_smoke(4, 4)[0], TMD(), torch.zeros((1, 3)),
                          torch.ones((1, 3)), torch.zeros((1, 2), dtype=torch.int64))
