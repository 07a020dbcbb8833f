"""The port's sorted-wavefront driver against the JAX reference's
trace_megakernel_swf(interpret=True) where its state carries records
beyond the surface path: textured scenes (inline texturing: each bounce's
diffuse texel resolved between launches) and the media box (the medium
stack planes); and render_pack's batched route.

Contracts: on the textured scenes the phase-4 contract of chip_smoke.py,
allclose(rtol 1e-4, atol 1e-5) on >= 98 % of lanes, image means within
5e-3 (per lane the driver differs from the whole-path kernel there, its
Russian roulette seeing the texels of the earlier bounces; both agree in
the mean); on the media box every lane at rtol 1e-5 with an atol of 1e-7,
as tests/test_torch_swf.py holds the untextured surface scenes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from test_round4_fixes import _medium_box_scene
from test_torch_bridge import flatten_jax_scene

RTOL, ATOL, MAX_LANE_FRAC, MEAN_TOL = 1e-4, 1e-5, 0.02, 5e-3

SCENES = {
    "kitchen": lambda: j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)[:2],
    "textured_floor": lambda: _j_textured_floor(),
}


def _j_textured_floor():
    """The port's textured_floor (a checker-textured Lambertian floor), built
    with the JAX builder."""
    from cuda_pt_tpu.scene import types as JT
    from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, SceneBuilder

    q = j_ts.quad
    b = SceneBuilder()
    checker = b.add_texture(j_ts._checker_texture(n=32, tiles=4))
    floor_m = b.add_bsdf(BSDFSpec(k_d=(0.9, 0.8, 0.7), tex_ids=(checker, -1, -1, -1, -1)))
    wall_m = b.add_bsdf(BSDFSpec(k_d=(0.5, 0.5, 0.6)))
    dark = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    panel = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1, 1, 1), scaler=18.0))
    uv = np.array([[[0, 0], [2, 0], [2, 2]], [[0, 0], [2, 2], [0, 2]]], np.float32)
    b.add_mesh(q([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]), floor_m, uv=uv)
    b.add_mesh(q([-2, 0, 2], [2, 0, 2], [2, 2, 2], [-2, 2, 2]), wall_m)
    b.add_mesh(q([-0.4, 1.9, -0.4], [0.4, 1.9, -0.4], [0.4, 1.9, 0.4], [-0.4, 1.9, 0.4]), dark,
               emitter_id=panel)
    cam = j_cam.make_camera(origin=(0, 1.4, -2.6), target=(0, 0.1, 0), fov=50.0, width=8,
                            height=8)
    return b.compile(), cam


@pytest.mark.parametrize("kind", list(SCENES))
def test_swf_inline_texturing_matches_jax_interpret(kind):
    sj, cj = SCENES[kind]()
    W, H = int(cj.width), int(cj.height)
    lane = jnp.arange(W * H, dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", 7, lane, 1)
    o, d, rng = j_cam.generate_rays(cj, lane, rng)
    pack_j = j_mk.make_pack(sj, node_fmt="w8")
    assert pack_j.textured
    Lj = np.asarray(j_mk.trace_megakernel_swf(pack_j, JMD(max_depth=4), o, d, rng,
                                              interpret=True, key_mode="pos_dir"))
    pack = t_mk.make_pack(bridge.scene_from_numpy(flatten_jax_scene(sj)), node_fmt="w8")
    assert pack.textured
    Lt = t_mk.trace_megakernel_swf(pack, TMD(max_depth=4), torch.tensor(np.asarray(o)),
                                   torch.tensor(np.asarray(d)),
                                   torch.tensor(np.asarray(rng).astype(np.int64)),
                                   key_mode="pos_dir").numpy()
    close = np.isclose(Lt, Lj, rtol=RTOL, atol=ATOL).all(axis=-1)
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    assert close.mean() >= 1.0 - MAX_LANE_FRAC, (close.mean(), np.abs(Lt - Lj).max())
    assert abs(float(Lt.mean()) - float(Lj.mean())) < MEAN_TOL


def test_render_pack_batches_big_scenes():
    """A pack of SWF_AUTO_BOXES boxes or more traces all samples in one
    driver call: the image equals the per-sample loop's."""
    scene, cam, _ = t_ts.kitchen_stress(6, 4, grid=2, ns=16, nt=12)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    md = TMD(max_depth=3)
    assert t_mk.driver_of(pack) == "swf"
    img = t_mk.render_pack(pack, cam, md, 3, seed=2)
    perm, inv = t_mk.tile_swizzle(cam.width, cam.height)
    acc = torch.zeros((cam.width * cam.height, 3))
    for i in range(3):
        rng = t_qmc.make_state("pcg", 2, perm, i)
        o, d, rng = t_cam.generate_rays(cam, perm, rng)
        acc = acc + t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    ref = (acc[inv] / 3).reshape(cam.height, cam.width, 3)
    torch.testing.assert_close(img, ref, rtol=1e-6, atol=1e-7)
    assert float(img.mean()) > 0.01


def test_swf_media_box_matches_jax_interpret():
    """The HG slab behind null faces (the medium stack in the state
    planes), vpt packs, max_depth 6, key "pos_dir": every lane at rtol 1e-5,
    atol 1e-7."""
    sj, cj = _medium_box_scene(8)
    lane = jnp.arange(64, dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", 5, lane, 1)
    o, d, rng = j_cam.generate_rays(cj, lane, rng)
    pack_j = j_mk.make_pack(sj, node_fmt="w8", vpt=True)
    Lj = np.asarray(j_mk.trace_megakernel_swf(pack_j, JMD(max_depth=6), o, d, rng,
                                              interpret=True, key_mode="pos_dir"))
    pack = t_mk.make_pack(bridge.scene_from_numpy(flatten_jax_scene(sj)), node_fmt="w8", vpt=True)
    assert pack.has_media
    Lt = t_mk.trace_megakernel_swf(pack, TMD(max_depth=6), torch.tensor(np.asarray(o)),
                                   torch.tensor(np.asarray(d)),
                                   torch.tensor(np.asarray(rng).astype(np.int64)),
                                   key_mode="pos_dir").numpy()
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    np.testing.assert_allclose(Lt, Lj, rtol=1e-5, atol=1e-7)
