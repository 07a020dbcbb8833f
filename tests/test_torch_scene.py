"""Port scene compile and kernel pack against the JAX reference: NumPy BVH
bit-equal, w8 collapse equal, cornell and kitchen scene arrays equal (the
reference builder given the same NumPy BVH; kitchen adds the texture atlas
and the envmap importance tables), make_pack(node_fmt="w8") bit-equal with
the kernel K3 inputs equal to the reference pack's."""

import dataclasses

import numpy as np
import pytest
import torch

from cuda_pt_torch.accel import bvh_build as t_bvh
from cuda_pt_torch.accel import wide_build as t_wide
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import builder as t_builder
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_tpu.accel import bvh_build as j_bvh
from cuda_pt_tpu.accel import wide_build as j_wide
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import builder as j_builder
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene import types as JT
from test_torch_bridge import TABLES, flatten_jax_scene, numpy_bvh_builds


@pytest.fixture
def numpy_bvh_reference(monkeypatch):
    """Make both builders take their NumPy BVH paths (use_native=False)."""
    numpy_bvh_builds(monkeypatch)


def _tall_box(kind: str, mod):
    T = JT
    if kind == "mirror":
        return mod.BSDFSpec(btype=T.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95))
    if kind == "glass":
        return mod.BSDFSpec(btype=T.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)
    return None


def _cornell_prims():
    _, _, b = t_ts.cornell_box(8, 8)
    p = np.concatenate([o.p for o in b.objects])
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    return p[:, 0], e1, e2, np.zeros(len(p), bool)


def _soup(n=2000, seed=11):
    rs = np.random.default_rng(seed)
    c = rs.uniform(-5, 5, (n, 1, 3))
    p = (c + rs.normal(scale=0.3, size=(n, 3, 3))).astype(np.float32)
    sph = rs.random(n) < 0.05
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    e1[sph] = np.abs(e1[sph]) * [1, 0, 0]
    return p[:, 0], e1, e2, sph


@pytest.mark.parametrize("prims", [_cornell_prims, _soup], ids=["cornell", "soup2k"])
def test_bvh_build_bit_equal_numpy_path(prims):
    p0, e1, e2, sph = prims()
    bt = t_bvh.prim_bounds(p0, e1, e2, sph)
    bj = j_bvh.prim_bounds(p0, e1, e2, sph)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    nt = t_bvh.build_bvh(*bt, max_leaf=4, use_native=False)
    nj = j_bvh.build_bvh(*bj, max_leaf=4, use_native=False)
    assert nt.keys() == nj.keys()
    for k in nt:
        np.testing.assert_array_equal(nt[k], nj[k], err_msg=k)
    wt = t_wide.collapse_wide(nt, max_leaf=4)
    wj = j_wide.collapse_wide(nj, max_leaf=4)
    for f in ("child_min", "child_max", "child_node", "leaf_base", "leaf_count"):
        np.testing.assert_array_equal(getattr(wt, f).numpy(), np.asarray(getattr(wj, f)), f)
    assert (wt.max_leaf, wt.max_stack) == (wj.max_leaf, wj.max_stack)


def _scene_pair(kind):
    if kind == "kitchen":
        st, ct, _ = t_ts.kitchen_stress(20, 12, grid=2, ns=6, nt=4)
        sj, cj, _ = j_ts.kitchen_stress(20, 12, grid=2, ns=6, nt=4)
        return st, ct, sj, cj
    st, ct, _ = t_ts.cornell_box(20, 12, tall_box_bsdf=_tall_box(kind, t_builder))
    sj, cj, _ = j_ts.cornell_box(20, 12, tall_box_bsdf=_tall_box(kind, j_builder))
    return st, ct, sj, cj


@pytest.mark.parametrize("kind", ["white", "mirror", "glass", "kitchen"])
def test_cornell_scene_arrays_equal(numpy_bvh_reference, kind):
    st, ct, sj, cj = _scene_pair(kind)
    flat = flatten_jax_scene(sj)
    for name in TABLES:
        table = getattr(st, name)
        for f in dataclasses.fields(table):
            got = getattr(table, f.name)
            want = flat[f"{name}.{f.name}"]
            if torch.is_tensor(got):
                got = got.numpy()
                assert got.dtype == np.asarray(want).dtype, (name, f.name)
            np.testing.assert_array_equal(got, want, err_msg=f"{name}.{f.name}")
    assert (st.env_emitter, st.cam_medium, st.num_emitters) == (
        flat["env_emitter"], flat["cam_medium"], flat["num_emitters"])
    assert st.present_bsdfs == flat["present_bsdfs"]
    for f in ("R", "t", "focal", "aperture", "focal_dist", "hsign"):
        np.testing.assert_array_equal(getattr(ct, f).numpy(), np.asarray(getattr(cj, f)), f)


@pytest.mark.parametrize("kind", ["white", "mirror", "glass"])
def test_make_pack_w8_bit_equal(kind):
    sj, _, _ = j_ts.cornell_box(8, 8, tall_box_bsdf=_tall_box(kind, j_builder))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pj = j_mk.make_pack(sj, node_fmt="w8")
    pt = t_mk.make_pack(st, node_fmt="w8")
    for k in t_mk.PACK_KEYS:
        a, b = np.asarray(pj[k]), pt[k].numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert pt.max_stack == pj.max_stack
    assert pt.max_leaf == pj.max_leaf and pt.tri_only == pj.tri_only
    assert t_mk.megakernel_ok(st) and j_mk.megakernel_ok(sj)


def test_make_pack_k3_inputs_equal_reference():
    """kitchen_stress: the six TPU tables bit-equal, and the kernel's K3
    inputs (per-prim uvs, diffuse texture per BSDF, texture atlas, envmap
    parameters) equal the reference pack's epilogue arrays."""
    sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    pj = j_mk.make_pack(sj, node_fmt="w8")
    pt = t_mk.make_pack(st, node_fmt="w8")
    for k in t_mk.PACK_KEYS:
        np.testing.assert_array_equal(pt[k].numpy(), np.asarray(pj[k]), err_msg=k)
    assert (pt.has_env, pt.textured, pt.has_disp) == (pj.has_env, pj.textured, pj.has_disp)
    assert pt.has_env and pt.textured and pt.has_disp
    P = st.geom.num_prims
    auv = np.asarray(pj["auv"])[:, : j_mk.UV_PER_ROW * 6].reshape(-1, 6)[:P]
    np.testing.assert_array_equal(pt["uvs"].numpy()[:, :6], auv)
    np.testing.assert_array_equal(pt["tdiff"].numpy(), np.asarray(pj["tdiff"]))
    np.testing.assert_array_equal(pt["texels"].numpy(), np.asarray(pj["tex_texels"]))
    np.testing.assert_array_equal(pt["tinfo"].numpy()[:, :3], np.stack(
        [np.asarray(pj[k]) for k in ("tex_offset", "tex_width", "tex_height")], axis=1))
    env = pt["envrow"].numpy()
    assert env[0] == int(np.asarray(pj["env_tid"]))
    np.testing.assert_array_equal(env[1:4], np.asarray(pj["env_extra"])[:3])
    np.testing.assert_array_equal(env[4:7], np.asarray(pj["env_base"]))


def test_kitchen_full_tree_fits_the_kernel_stack():
    """The port's own default tree for full-size kitchen_stress: its w8
    traversal stack (+8 for the walk's unconditional write) fits
    MK_MAX_STACK, and its leaves fit the stack entry's 4-bit count."""
    from cuda_pt_torch.ops import cuda_build

    st, _, _ = t_ts.kitchen_stress(8, 8)
    wb = t_wide.from_bvharrays(st.bvh)
    assert st.geom.num_prims == 98790
    assert int(wb.max_stack) + 8 <= cuda_build.MK_MAX_STACK
    assert int(st.bvh.max_leaf) <= t_mk.MK_MAX_LEAF


def test_tile_swizzle_matches_reference():
    for w, h in ((16, 16), (10, 7), (24, 3)):
        pt, it = t_mk.tile_swizzle(w, h)
        pj, ij = j_mk.tile_swizzle(w, h)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_unported_builder_branches_raise():
    from cuda_pt_torch.core.config import BVHConfig

    b = t_builder.SceneBuilder()
    b.add_mesh(t_ts.quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), b.add_bsdf(t_builder.BSDFSpec()))
    with pytest.raises(ValueError, match="node_fmt"):  # K1's forest takes f32 or bf16 rows
        b.compile(forest_chunk=64, node_fmt="f16")
    # the SBVH is ported: it compiles, every prim referenced at least once
    sbvh = b.compile(bvh_cfg=BVHConfig(use_sbvh=True))
    assert sbvh.geom.num_prims >= 2 and int(sbvh.bvh.node_count.sum()) == sbvh.geom.num_prims


_TYPES = [n for n, c in sorted(vars(TT).items())
          if isinstance(c, type) and dataclasses.is_dataclass(c) and c.__module__ == TT.__name__]


@pytest.mark.parametrize("name", _TYPES)
def test_types_fields_match_reference(name):
    """Every dataclass of scene/types.py has its JAX counterpart's field
    names in its order, so a positional construction or a walk of the
    fields pairs them as the reference does."""
    got = [f.name for f in dataclasses.fields(getattr(TT, name))]
    assert got == [f.name for f in dataclasses.fields(getattr(JT, name))]


def test_wide_num_leaves_matches_reference():
    """WideBVHArrays.num_leaves, which the wide walk clamps its leaf ids
    to, equals the reference's on small kitchen_stress's wide tree."""
    st, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    wt, wj = t_wide.from_bvharrays(st.bvh), j_wide.from_bvharrays(sj.bvh)
    assert wt.num_leaves == wj.num_leaves == int(wt.leaf_base.shape[0]) > 1
