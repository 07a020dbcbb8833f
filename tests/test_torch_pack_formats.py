"""The reference's pack formats in the port: binary skip-tree nodes in f32
and bf16 rows, t9 prims and bf16 attrs (cuda_pt_tpu/ops/pallas/megakernel.py
make_pack, pack_prims_t9, pack_attrs_bf16; ops/pallas/traverse_kernel.py
pack_nodes, pack_nodes_bf16), and kernel S1's plain version.

- Tables bit-equal to the reference's, and the sizes, box counts, drivers
  and formats make_pack picks equal to the reference's, with the format
  rule's threshold (AUTO_COMPACT_BYTES) patched low on both sides so that
  small scenes take the compact formats.
- The plain version of the kernel on a pack in the compact formats (bf16
  nodes, t9 prims, bf16 attrs) against the reference's render_pack in
  interpret mode on the same scene: allclose(rtol 1e-4, atol 1e-5) on >=
  95 % of lanes, as the K3 tests hold the w8 pack.
- S1's plain version (ops/node_bench.node_bench_reference) against the
  reference's _node_bench_kernel run through pl.pallas_call(interpret=True)
  on one (1, 1, 128) tile of cornell's rows: bit-equal.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.ops import node_bench as t_nb
from cuda_pt_torch.ops import traverse_kernel as t_tk
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.ops.pallas import traverse_kernel as j_tk
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from cuda_pt_tpu.scene.builder import BSDFSpec, EmitterSpec, SceneBuilder
from test_round4_fixes import _medium_box_scene
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL, MIN_LANES = 1e-4, 1e-5, 0.95


def torus_scene(width=8, height=8):
    """A floor, an area panel and a GGX-conductor torus with vertex normals
    (the reference's pack-format scene, tests/test_round4_fixes.py:115)."""
    b = SceneBuilder()
    grey = b.add_bsdf(BSDFSpec(k_d=(0.6, 0.6, 0.6)))
    gold = b.add_bsdf(BSDFSpec(btype=JT.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444),
                               k=(3.983, 2.386, 1.603), roughness_x=0.2, roughness_y=0.2))
    panel = b.add_emitter(EmitterSpec(etype=JT.EMITTER_AREA, emission=(1, 1, 1), scaler=15.0))
    b.add_mesh(j_ts.quad([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]), grey)
    b.add_mesh(j_ts.quad([-0.5, 1.8, -0.5], [0.5, 1.8, -0.5], [0.5, 1.8, 0.5],
                         [-0.5, 1.8, 0.5]), grey, emitter_id=panel)
    p, n, uv = j_ts._torus_mesh((0, 0.5, 0), R=0.5, r=0.2, ns=16, nt=12)
    b.add_mesh(p, gold, n=n, uv=uv)
    cam = j_cam.make_camera(origin=(0, 1.2, -2.4), target=(0, 0.4, 0), fov=45.0, width=width,
                            height=height)
    return b.compile(), cam


@pytest.fixture(scope="module")
def scenes():
    """(JAX scene, port scene) pairs: the torus scene, medium_box (media:
    its attrs carry medium_in and is_null), cornell and furnace (a
    sphere)."""
    out = {}
    for name, make in (("torus", lambda: torus_scene()[0]),
                       ("medium_box", lambda: _medium_box_scene(8)[0]),
                       ("cornell", lambda: j_ts.cornell_box(8, 8)[0]),
                       ("furnace", lambda: j_ts.furnace(8, 8)[0])):
        sj = make()
        out[name] = (sj, bridge.scene_from_numpy(flatten_jax_scene(sj)))
    return out


@pytest.mark.parametrize("name", ["torus", "medium_box", "furnace"])
def test_compact_tables_bit_equal(scenes, name):
    """pack_prims_t9 (all-triangle scenes), pack_attrs_bf16 (with and
    without media) and the binary node rows in f32 and bf16 bit-equal to
    the reference's."""
    sj, st = scenes[name]
    pairs = [(t_mk.pack_attrs_bf16(st), j_mk.pack_attrs_bf16(sj)),
             (t_tk.pack_nodes(st.bvh), j_tk.pack_nodes(sj.bvh)),
             (t_tk.pack_nodes_bf16(st.bvh), j_tk.pack_nodes_bf16(sj.bvh))]
    if not bool(st.geom.is_sphere.any()):
        pairs.append((t_mk.pack_prims_t9(st.geom), j_mk.pack_prims_t9(sj.geom)))
    for got, want in pairs:
        want = np.asarray(want)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("vpt", [False, True])
def test_make_pack_picks_the_reference_formats(scenes, monkeypatch, vpt):
    """fused_pack_bytes, resident_pack_bytes, make_pack's formats and tables,
    pack_boxes and driver_of equal the reference's, below the format rule's
    threshold and with it patched to 1 byte (every scene compact)."""
    for threshold in (None, 1):
        if threshold is not None:
            monkeypatch.setattr(j_mk, "AUTO_COMPACT_BYTES", threshold)
            monkeypatch.setattr(t_mk, "AUTO_COMPACT_BYTES", threshold)
        for name, (sj, st) in scenes.items():
            if vpt != (name == "medium_box"):  # media pack only for the volume path tracer
                continue
            assert t_mk.fused_pack_bytes(st) == j_mk.fused_pack_bytes(sj)
            assert t_mk.resident_pack_bytes(st) == j_mk.resident_pack_bytes(sj)
            for fmt in (None, "w8", "f32", "bf16"):
                pj = j_mk.make_pack(sj, node_fmt=fmt, vpt=vpt)
                pt = t_mk.make_pack(st, node_fmt=fmt, vpt=vpt)
                assert (pt.node_fmt, pt.attr_fmt, pt.prim_fmt, pt.tri_only) == (
                    pj.node_fmt, pj.attr_fmt, pj.prim_fmt, pj.tri_only), (name, fmt)
                assert ("tlbox" in pt.arrays) == ("tlbox" in pj.keys()) == (pt.node_fmt == "w8")
                for key in ("nodes", "prims", "attrs"):
                    np.testing.assert_array_equal(pt[key].numpy().view(np.uint32),
                                                  np.asarray(pj[key]).view(np.uint32))
                assert t_mk.pack_boxes(pt) == j_mk._pack_boxes(pj)
                j_driver = "swf" if j_mk._pack_boxes(pj) >= j_mk.SWF_AUTO_BOXES else "whole_path"
                assert t_mk.driver_of(pt) == j_driver
        if threshold is not None:
            sj, st = scenes["torus"]
            assert t_mk.make_pack(st).prim_fmt == "t9"
            assert t_mk.make_pack(scenes["furnace"][1]).prim_fmt == "f32"  # a sphere
            with pytest.raises(ValueError, match="t9"):
                t_mk.make_pack(scenes["furnace"][1], prim_fmt="t9")


def test_compact_pack_plain_matches_jax_interpret(scenes):
    """The port's render_pack on CPU tensors (the plain version: binary
    bf16 nodes and t9 prims give the f32 hits, bf16 attrs the truncated
    normals) against the reference's render_pack(interpret=True) on the
    pack make_pack(node_fmt="bf16", attr_fmt="bf16", prim_fmt="t9") of the
    torus scene, 8x8, depth 3, 1 spp."""
    sj, st = scenes["torus"]
    _, cj = torus_scene()
    ct = bridge.camera_from_numpy(flatten_jax_camera(cj))
    fmts = dict(node_fmt="bf16", attr_fmt="bf16", prim_fmt="t9")
    pj = j_mk.make_pack(sj, **fmts)
    pt = t_mk.make_pack(st, **fmts)
    assert t_mk.driver_of(pt) == "whole_path"
    img_j = np.asarray(j_mk.render_pack(pj, cj, JMD(max_depth=3), spp=1, seed=5,
                                        interpret=True)).reshape(-1, 3)
    img_t = t_mk.render_pack(pt, ct, TMD(max_depth=3), 1, 5).numpy().reshape(-1, 3)
    close = np.isclose(img_t, img_j, rtol=RTOL, atol=ATOL).all(axis=-1)
    print(f"compact pack, plain version vs JAX interpret: {int(close.sum())} of {close.size} "
          f"lanes within the contract")
    assert np.isfinite(img_t).all() and img_j.mean() > 0.01
    assert close.mean() >= MIN_LANES, (close.mean(), np.abs(img_t - img_j).max())


def _roofline():
    spec = importlib.util.spec_from_file_location(
        "roofline_ref", os.path.join(REPO, "scripts", "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_node_bench_plain_matches_jax_interpret(scenes):
    """S1: node_bench_reference, 8 steps on the reference's rays, against
    _node_bench_kernel on one (1, 1, 128) tile of cornell's binary f32 rows
    in interpret mode, bit for bit."""
    import functools

    from jax.experimental import pallas as pl

    sj, st = scenes["cornell"]
    nodes_j = j_tk.pack_nodes(sj.bvh)
    nodes_t = torch.as_tensor(t_tk.pack_nodes(st.bvh))
    rn = nodes_j.shape[0]
    rays = [jnp.ones((1, 1, 128), jnp.float32) * v for v in (*t_nb.REF_O, *t_nb.REF_D)]
    kern = functools.partial(_roofline()._node_bench_kernel, 8, rn)
    out_j = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((1, 1, 128), jnp.float32), interpret=True,
    )(nodes_j, *rays)).reshape(-1)
    o, d = t_nb.reference_rays(128)
    out_t = t_nb.node_bench(nodes_t, o, d, 8).numpy()
    np.testing.assert_array_equal(out_t.view(np.uint32), out_j.view(np.uint32))
    assert out_t[0] != 0.0


def test_binary_pack_routes():
    """Only a w8 pack carries the driver's treelet boxes and hit matrix, as
    in the reference: a grid pack with binary nodes and a treelet sort key
    on a binary pack raise in the driver; render_megakernel is
    render_pack(make_pack(scene)) with the pcg sampler only."""
    from cuda_pt_torch.scene import testscenes as t_ts

    scene, cam, _ = t_ts.grid_smoke(4, 4)
    pack = t_mk.make_pack(scene, node_fmt="f32", vpt=True)
    assert pack.has_grid and t_mk.driver_of(pack) == "swf_split" and "g_hit" not in pack.arrays
    o, d = torch.zeros((2, 3)), torch.tensor([[0.0, 0.0, 1.0]] * 2)
    rng = torch.zeros((2, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="w8 pack"):
        t_mk.auto_trace(pack, TMD(), o, d, rng)
    scene, cam, _ = t_ts.cornell_box(4, 4)
    with pytest.raises(ValueError, match="w8 pack"):
        t_mk.trace_megakernel_swf(t_mk.make_pack(scene), TMD(), o, d, rng, key_mode="tl_pos")
    md = TMD(max_depth=2)
    img = t_mk.render_megakernel(scene, cam, md, 1, seed=3)
    np.testing.assert_array_equal(img.numpy(),
                                  t_mk.render_pack(t_mk.make_pack(scene), cam, md, 1, 3).numpy())
    with pytest.raises(ValueError, match="pcg"):
        t_mk.render_megakernel(scene, cam, md, 1, sampler="sobol")
