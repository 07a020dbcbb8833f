"""The port's sorted-wavefront driver (ops/megakernel.trace_megakernel_swf,
kernel K5's plain version in it) against the JAX reference's
trace_megakernel_swf(interpret=True), and its sort and pack helpers.

Contracts: the sort keys, treelet boxes and hit matrix equal the
reference's; on untextured surface scenes (cornell with key_mode "none"
and "pos_dir", the envmap furnace) every lane agrees with the
reference's driver at rtol 1e-5 with an atol of 1e-7 (the float32
rounding differences of the two implementations, which the whole-path
plain version and the reference's whole-path kernel show too, reach 1.2e-7
on lanes near 0.01); the port's driver with any sort key equals its own whole-path plain
version per lane (bit-equal: lanes are independent). The textured scenes
(inline texturing) and the media box are held in
tests/test_torch_swf_records.py."""

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
from cuda_pt_tpu.accel import native as j_native
from cuda_pt_tpu.accel import wide_build as j_wide
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_scene

EXACT_RTOL, EXACT_ATOL = 1e-5, 1e-7


def _random_state(n=4096, seed=0):
    """Seeded state planes: origins, directions, a seventh of lanes dead."""
    rs = np.random.default_rng(seed)
    st = np.zeros((21, n), np.float32)
    st[2:5] = rs.uniform(-1.5, 2.5, (3, n))
    st[5:8] = rs.normal(size=(3, n))
    st[5:8] /= np.linalg.norm(st[5:8], axis=0, keepdims=True)
    st[14] = 1.0
    st[14, ::7] = 0.0
    return st


@pytest.fixture(scope="module")
def kitchen_packs():
    """kitchen_stress(grid=2) packed by both sides, the JAX scene built with
    its NumPy BVH as the port's builder does."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "build_bvh_native", lambda *a, **k: None)
    try:
        sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    finally:
        mp.undo()
    st, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    return j_mk.make_pack(sj, node_fmt="w8"), t_mk.make_pack(st, node_fmt="w8"), sj, st


@pytest.mark.parametrize("mode", ["dir_pos", "pos_dir", "tl_pos", "tl_oct"])
def test_sort_key_matches_reference(kitchen_packs, mode):
    pack_j, pack_t, _, _ = kitchen_packs
    st = _random_state()
    kj = np.asarray(j_mk.swf_sort_key(tuple(jnp.asarray(x) for x in st), mode,
                                      pack_j["tlbox"] if mode.startswith("tl") else None))
    kt = t_mk.swf_sort_key(torch.as_tensor(st).view(torch.int32), mode,
                           pack_t["tlbox"] if mode.startswith("tl") else None)
    np.testing.assert_array_equal(kt.numpy(), kj)
    assert (kj == t_mk.DEAD_KEY).sum() == (st[14] == 0).sum()
    with pytest.raises(ValueError, match="treelet"):
        t_mk.swf_sort_key(torch.as_tensor(st).view(torch.int32), "tl_pos", None)


def test_treelet_boxes_and_hit_matrix_match_reference(kitchen_packs):
    pack_j, pack_t, sj, st = kitchen_packs
    np.testing.assert_array_equal(pack_t["tlbox"].numpy(), np.asarray(pack_j["tlbox"]))
    np.testing.assert_array_equal(pack_t["g_hit"].numpy(), np.asarray(pack_j["g_hit"]))
    used = int((pack_t["tlbox"][:, 0] < 1e29).sum())
    assert 8 <= used <= 64
    wb = j_wide.from_bvharrays(sj.bvh)
    np.testing.assert_array_equal(np.asarray(j_mk.treelet_boxes_w8(wb, max_tl=16)),
                                  t_mk.treelet_boxes_w8(t_mk.wide_build.from_bvharrays(st.bvh),
                                                        max_tl=16))


def _jax_rays(cj, seed=5, sample=1):
    lane = jnp.arange(int(cj.width) * int(cj.height), dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", seed, lane, sample)
    return j_cam.generate_rays(cj, lane, rng)


def _torch(o, d, rng):
    return (torch.tensor(np.asarray(o)), torch.tensor(np.asarray(d)),
            torch.tensor(np.asarray(rng).astype(np.int64)))


CASES = {
    # name: (JAX scene and camera, max_depth, key_mode, vpt pack)
    "cornell_none": (lambda: j_ts.cornell_box(8, 8)[:2], 4, "none", False),
    "cornell_pos_dir": (lambda: j_ts.cornell_box(8, 8)[:2], 4, "pos_dir", False),
    "furnace": (lambda: j_ts.furnace(8, 8)[:2], 3, "pos_dir", False),
}


@pytest.fixture(scope="module")
def jax_cornell_unsorted():
    """JAX's interpret driver on cornell, unsorted (key "none"): the
    reference for both cornell cases. Sorting only moves lanes, so the
    port's driver under any key is held to it lane for lane
    (test_sorting_changes_nothing_per_lane holds the port's keys to one
    another)."""
    return _jax_driver(*CASES["cornell_none"])


def _jax_driver(make, depth, key_mode, vpt):
    sj, cj = make()
    o, d, rng = _jax_rays(cj)
    pack_j = j_mk.make_pack(sj, node_fmt="w8", vpt=vpt)
    Lj = np.asarray(j_mk.trace_megakernel_swf(pack_j, JMD(max_depth=depth), o, d, rng,
                                              interpret=True, key_mode=key_mode))
    return sj, o, d, rng, Lj


@pytest.mark.parametrize("case", list(CASES))
def test_swf_plain_matches_jax_interpret(case, request):
    """The port's driver on the CPU (plain K5) against JAX's driver in
    interpret mode on the same rays and streams, every lane at rtol 1e-5,
    atol 1e-7 (both cornell cases against one unsorted JAX run)."""
    make, depth, key_mode, vpt = CASES[case]
    if case.startswith("cornell"):
        sj, o, d, rng, Lj = request.getfixturevalue("jax_cornell_unsorted")
    else:
        sj, o, d, rng, Lj = _jax_driver(*CASES[case])
    pack_t = t_mk.make_pack(bridge.scene_from_numpy(flatten_jax_scene(sj)), node_fmt="w8", vpt=vpt)
    before = dict(t_mk.LAUNCHES)
    Lt = t_mk.trace_megakernel_swf(pack_t, TMD(max_depth=depth), *_torch(o, d, rng),
                                   key_mode=key_mode).numpy()
    assert t_mk.LAUNCHES == before  # CPU tensors never count as kernel launches
    assert np.isfinite(Lt).all() and Lj.mean() > 0.01
    np.testing.assert_allclose(Lt, Lj, rtol=EXACT_RTOL, atol=EXACT_ATOL)
    if case == "furnace":
        assert abs(Lt.mean() - 1.0) < 0.05


@pytest.mark.parametrize("kind", ["cornell", "glass", "furnace", "nested_media", "spot"])
@pytest.mark.parametrize("key_mode", ["none", "dir_pos", "pos_dir", "tl_pos", "tl_oct"])
def test_sorting_changes_nothing_per_lane(kind, key_mode):
    """The port's driver with any key equals the whole-path plain version
    lane for lane on untextured scenes."""
    from cuda_pt_torch.scene.builder import BSDFSpec
    from cuda_pt_torch.scene import types as TT

    scene, cam, _ = {
        "cornell": lambda: t_ts.cornell_box(8, 8),
        "glass": lambda: t_ts.cornell_box(8, 8, tall_box_bsdf=BSDFSpec(
            btype=TT.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)),
        "furnace": lambda: t_ts.furnace(8, 8),
        "nested_media": lambda: t_ts.nested_media(8, 8),
        "spot": lambda: t_ts.spot_light(8, 8),
    }[kind]()
    pack = t_mk.make_pack(scene, node_fmt="w8", vpt=kind == "nested_media")
    perm, _ = t_mk.tile_swizzle(cam.width, cam.height)
    rng = t_qmc.make_state("pcg", 2, perm, 3)
    o, d, rng = t_cam.generate_rays(cam, perm, rng)
    md = TMD(max_depth=8)
    L0 = t_mk.trace_megakernel(pack, md, o, d, rng)
    L1 = t_mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode=key_mode)
    assert float(L0.mean()) > 0.01
    assert torch.equal(L0, L1)


def test_auto_trace_routes_as_the_reference():
    """cornell -> whole path; 512 boxes or more -> the driver; the
    reference's threshold."""
    assert t_mk.SWF_AUTO_BOXES == j_mk.SWF_AUTO_BOXES == 512
    scene, _, _ = t_ts.cornell_box(8, 8)
    assert t_mk.driver_of(t_mk.make_pack(scene, node_fmt="w8")) == "whole_path"
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=16, nt=12)
    pack = t_mk.make_pack(scene, node_fmt="w8")
    assert t_mk.pack_boxes(pack) >= 512 and t_mk.driver_of(pack) == "swf"
    scene, _, _ = t_ts.grid_smoke(8, 8)
    assert t_mk.driver_of(t_mk.make_pack(scene, node_fmt="w8", vpt=True)) == "swf_split"
