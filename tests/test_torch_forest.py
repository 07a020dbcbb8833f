"""Kernel K1's host side and plain version (cuda_pt_torch/ops/
traverse_kernel.py) against the JAX reference's traverse_kernel.py, and the
Morton codes of ops/morton.py against ops/morton.py of the reference.

Contracts: the forest arrays (f32 and bf16 rows, one chunk and several)
and the directed bf16 rounding are bit-equal to the reference's, the
reference's BVH built by its NumPy path as the port's builder builds it;
the plain K1 (per-ray and packet forms) against the reference's kernel in
interpret mode on one 512-ray tile of a four-chunk forest: prim ids and
occlusion equal, t at rtol 1e-6 and the barycentrics b1, b2 at rtol 1e-6
with an atol of 1e-6 (XLA may order the triangle test's sums its own way;
a barycentric is a difference of products near 1, so its rounding is
absolute), tile_iters equal; morton3d bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.ops import morton as t_morton
from cuda_pt_torch.ops import traverse_kernel as t_tk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_tpu.accel import native as j_native
from cuda_pt_tpu.ops import morton as j_morton
from cuda_pt_tpu.ops.pallas import traverse_kernel as j_tk
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_scene

FOREST = (("f32", 256), ("bf16", 256), ("f32", 64), ("bf16", 64))


@pytest.fixture(scope="module")
def kitchen():
    """kitchen_stress(grid=2) (198 triangles) from the JAX builder with its
    NumPy BVH, and the same scene bridged to the port."""
    mp = pytest.MonkeyPatch()
    mp.setattr(j_native, "build_bvh_native", lambda *a, **k: None)
    try:
        sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
        forests = {key: j_tk.build_forest(sj.geom, chunk_prims=key[1], node_fmt=key[0])
                   for key in FOREST}
    finally:
        mp.undo()
    return sj, bridge.scene_from_numpy(flatten_jax_scene(sj)), forests


def _bits(x) -> np.ndarray:
    x = np.asarray(x.numpy() if torch.is_tensor(x) else x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


def _same_forest(ft, fj):
    assert ft.node_fmt == fj.node_fmt
    for name in ("nodes", "prims", "n_nodes"):
        got, want = getattr(ft, name), np.asarray(getattr(fj, name))
        assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


@pytest.mark.parametrize("node_fmt,chunk", FOREST)
def test_forest_matches_reference(kitchen, node_fmt, chunk):
    """build_forest bit-equal to the reference's: one chunk (256) and four
    (64), f32 and bf16 rows."""
    _, st, forests = kitchen
    ft = t_tk.build_forest(st.geom, chunk_prims=chunk, node_fmt=node_fmt)
    _same_forest(ft, forests[(node_fmt, chunk)])
    assert ft.num_chunks == (1 if chunk == 256 else 4)


def test_compiled_forest_and_single_chunk_match_reference(kitchen):
    """SceneBuilder.compile(forest_chunk=...) through kitchen_stress, and
    the single-chunk forest and bf16 rows of the scene's own BVH."""
    sj, st, forests = kitchen
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64, node_fmt="bf16")
    _same_forest(scene.forest, forests[("bf16", 64)])
    _same_forest(t_tk.single_chunk_forest(st.geom, st.bvh), j_tk.single_chunk_forest(sj.geom,
                                                                                       sj.bvh))
    np.testing.assert_array_equal(_bits(t_tk.pack_nodes_bf16(st.bvh)),
                                  _bits(j_tk.pack_nodes_bf16(sj.bvh)))
    assert t_tk.scene_fits_vmem(st.geom, st.bvh) == j_tk.scene_fits_vmem(sj.geom, sj.bvh)


def test_bf16_directed_rounding_bit_equal():
    rs = np.random.default_rng(4)
    x = np.concatenate([rs.normal(scale=s, size=512) for s in (1e-30, 1e-3, 1.0, 1e6, 1e30)])
    x = np.concatenate([x, [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-45, 65536.0]])
    x = x.astype(np.float32)
    for up in (False, True):
        got = t_tk._bf16_directed(x, up)
        np.testing.assert_array_equal(got.view(np.uint32), j_tk._bf16_directed(x, up).view(
            np.uint32))
        inside = np.abs(x) <= t_tk._BF16_MAX  # beyond it both clip to the largest bf16
        assert (got >= x)[inside].all() if up else (got <= x)[inside].all()
    lo, hi = t_tk._bf16_directed(x, False), t_tk._bf16_directed(x, True)
    np.testing.assert_array_equal(t_tk._pack2(lo, hi).view(np.uint32),
                                  j_tk._pack2(lo, hi).view(np.uint32))


def _rays(scene, n: int, seed: int):
    rs = np.random.default_rng(seed)
    lo, hi = np.asarray(scene.bvh.node_min)[0], np.asarray(scene.bvh.node_max)[0]
    o = rs.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, rs.uniform(0.05, 6.0, n).astype(np.float32)


@pytest.fixture(scope="module")
def jax_k1(kitchen):
    """The reference kernel in interpret mode on one 512-ray tile of the
    four-chunk f32 forest: closest hit and any hit, with tile_iters."""
    sj, _, forests = kitchen
    o, d, t_far = _rays(sj, 512, 6)
    fj = forests[("f32", 64)]
    closest = j_tk.traverse_forest(fj, jnp.asarray(o), jnp.asarray(d), max_leaf=4,
                                   interpret=True, count_iters=True)
    anyhit = j_tk.traverse_forest(fj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_far),
                                  max_leaf=4, occlusion=True, interpret=True, count_iters=True)
    return o, d, t_far, {k: np.asarray(v) for k, v in closest.items()}, \
        {k: np.asarray(v) for k, v in anyhit.items()}


@pytest.mark.parametrize("count_iters", [False, True])
def test_plain_k1_matches_jax_interpret(kitchen, jax_k1, count_iters):
    """traverse_forest on CPU tensors (the plain version), per-ray form and
    packet form, against the reference kernel."""
    _, st, _ = kitchen
    o, d, t_far, cj, aj = jax_k1
    ft = t_tk.build_forest(st.geom, chunk_prims=64)
    before = dict(t_tk.LAUNCHES)
    ct = t_tk.traverse_forest(ft, torch.as_tensor(o), torch.as_tensor(d),
                              count_iters=count_iters)
    at = t_tk.traverse_forest(ft, torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(t_far), occlusion=True, count_iters=count_iters)
    assert t_tk.LAUNCHES == before  # CPU tensors never count as kernel launches
    np.testing.assert_array_equal(ct["prim"].numpy(), cj["prim"])
    hit = cj["hit"]
    assert 0.2 < hit.mean() < 1.0
    np.testing.assert_allclose(ct["t"].numpy()[hit], cj["t"][hit], rtol=1e-6)
    for k in ("b1", "b2"):  # differences of products near 1: absolute rounding
        np.testing.assert_allclose(ct[k].numpy()[hit], cj[k][hit], rtol=1e-6, atol=1e-6)
    assert np.isinf(ct["t"].numpy()[~hit]).all()
    np.testing.assert_array_equal(at["occluded"].numpy(), aj["occluded"])
    assert 0.05 < aj["occluded"].mean() < 0.95
    if count_iters:
        np.testing.assert_array_equal(ct["tile_iters"].numpy(), cj["tile_iters"])
        np.testing.assert_array_equal(at["tile_iters"].numpy(), aj["tile_iters"])
        # the packet walks every padding node of every chunk: 4 x 7 rows x 8
        assert cj["tile_iters"][0] == ft.nodes.shape[0] * ft.nodes.shape[1] * t_tk.SLOTS


def test_plain_k1_forms_and_formats_agree(kitchen):
    """The per-ray and packet forms give the same hits on 1,000 rays (a
    ragged last tile: the padding lanes take part in the packet only), the
    bf16 rows the same prim ids as the f32 rows, and traverse_pallas (the
    scene's own BVH as one chunk) the same ids as the skip walk."""
    _, st, _ = kitchen
    o, d, t_far = (torch.as_tensor(x) for x in _rays(st, 1000, 8))
    per_ray = t_tk.traverse_forest(t_tk.build_forest(st.geom, 64), o, d)
    packet = t_tk.traverse_forest(t_tk.build_forest(st.geom, 64), o, d, count_iters=True,
                                  tile=256)
    bf16 = t_tk.traverse_forest(t_tk.build_forest(st.geom, 64, node_fmt="bf16"), o, d)
    for k in ("t", "prim", "b1", "b2"):
        assert torch.equal(per_ray[k], packet[k]) and torch.equal(per_ray[k], bf16[k]), k
    assert packet["tile_iters"].shape == (4,)
    one = t_tk.traverse_pallas(st.geom, st.bvh, o, d, t_far, occlusion=True)["occluded"]
    from cuda_pt_torch.accel import traverse as t_trav

    assert torch.equal(one, t_trav.occlusion_bvh(st.geom, st.bvh, o, d, t_far))
    np.testing.assert_array_equal(
        t_tk.traverse_pallas(st.geom, st.bvh, o, d)["prim"].numpy(),
        t_trav.closest_hit_bvh(st.geom, st.bvh, o, d)["prim"].numpy())


def test_wrapper_checks():
    scene, _, _ = t_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4, forest_chunk=64)
    o, d = torch.zeros((4, 3)), torch.ones((4, 3))
    with pytest.raises(ValueError, match="multiple of 128"):
        t_tk.traverse_forest(scene.forest, o, d, count_iters=True, tile=200)
    with pytest.raises(ValueError, match="CUDA"):
        t_tk.traverse_forest(scene.forest, o, d, stats=torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        t_tk.traverse_forest(scene.forest, o.to("meta"), d.to("meta"))
    with pytest.raises(ValueError, match="node_fmt"):
        t_tk.build_forest(scene.geom, 64, node_fmt="f16")


def test_path_tracer_walk_routes(kitchen, monkeypatch):
    """closest_hit / occluded under each traversal give the skip walk's
    prim ids and occlusion; on CPU tensors "pallas" keeps the reference's
    routing (the skip walk past scene_fits_vmem); "mxu" raises naming its
    ROADMAP item."""
    _, st, _ = kitchen
    o, d, t_far = (torch.as_tensor(x) for x in _rays(st, 512, 10))
    live = torch.ones(512, dtype=torch.bool)
    live[::3] = False
    want = t_pt.closest_hit(st, o, d, live)
    want_occ = t_pt.occluded(st, o, d, t_far, live)
    assert t_pt.TRAVERSAL_IMPL == "xla" and t_pt.pallas_forest(st) is not None
    for trav in ("pallas", "xla"):
        st.traversal = trav
        got = t_pt.closest_hit(st, o, d, live)
        np.testing.assert_array_equal(got["prim"].numpy(), want["prim"].numpy())
        assert not got["hit"][::3].any()
        assert torch.equal(t_pt.occluded(st, o, d, t_far, live), want_occ)
    monkeypatch.setattr(t_tk, "VMEM_BUDGET_BYTES", 0)
    assert st.forest is None and t_pt.pallas_forest(st) is None
    st.traversal = "pallas"
    np.testing.assert_array_equal(t_pt.closest_hit(st, o, d, live)["prim"].numpy(),
                                  want["prim"].numpy())
    st.traversal = "mxu"
    with pytest.raises(NotImplementedError, match="item 13"):
        t_pt.closest_hit(st, o, d, live)
    st.traversal = ""


def test_morton_matches_reference():
    rs = np.random.default_rng(12)
    p = rs.uniform(-3.0, 3.0, (4096, 3)).astype(np.float32)
    lo = np.array([-2.0, -1.0, -2.5], np.float32)
    hi = np.array([2.0, 2.5, 1.0], np.float32)
    got = t_morton.morton3d(torch.as_tensor(p), torch.as_tensor(lo), torch.as_tensor(hi))
    want = np.asarray(j_morton.morton3d(jnp.asarray(p), jnp.asarray(lo), jnp.asarray(hi)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.max() < 2 ** 30 and len(np.unique(want)) > 3000
