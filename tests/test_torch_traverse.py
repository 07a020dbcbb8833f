"""The port's skip walk (accel/traverse.py) against the JAX reference's on
kitchen_stress (grid 2): equal prim ids and occlusion. t agrees to 1 ulp on
most hits and to a few ulps on the rest: XLA fuses the triangle test's dot
products in an order of its own, and JAX's skip walk and its brute force
differ from each other by as much on these rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.accel import traverse as t_trav
from cuda_pt_torch.accel import wide_build as t_wide
from cuda_pt_torch.accel import wide_traverse as t_wtrav
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.accel import traverse as j_trav
from cuda_pt_tpu.accel import wide_build as j_wide
from cuda_pt_tpu.accel import wide_traverse as j_wtrav
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_scene

B = 4096


@pytest.fixture(scope="module")
def kitchen():
    sj, _, _ = j_ts.kitchen_stress(8, 8, grid=2, ns=6, nt=4)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    rs = np.random.default_rng(8)
    lo = np.asarray(sj.bvh.node_min)[0]
    hi = np.asarray(sj.bvh.node_max)[0]
    o = rs.uniform(lo, hi, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return sj, st, o, d, rs


def test_closest_hit_bvh_matches(kitchen):
    sj, st, o, d, _ = kitchen
    hj = j_trav.closest_hit_bvh(sj.geom, sj.bvh, jnp.asarray(o), jnp.asarray(d))
    ht = t_trav.closest_hit_bvh(st.geom, st.bvh, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(ht["prim"].numpy(), np.asarray(hj["prim"]))
    np.testing.assert_array_equal(ht["hit"].numpy(), np.asarray(hj["hit"]))
    hit = np.asarray(hj["hit"])
    tj = np.asarray(hj["t"])[hit]
    tt = ht["t"].numpy()[hit]
    ulps = np.abs(tt.view(np.int32).astype(np.int64) - tj.view(np.int32).astype(np.int64))
    assert (ulps <= 1).mean() > 0.9, np.bincount(np.minimum(ulps, 10))
    np.testing.assert_allclose(tt, tj, rtol=4e-6)
    np.testing.assert_allclose(ht["b1"].numpy()[hit], np.asarray(hj["b1"])[hit], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(ht["b2"].numpy()[hit], np.asarray(hj["b2"])[hit], rtol=1e-5,
                               atol=1e-6)
    assert 0.2 < hit.mean() < 1.0


def test_occlusion_bvh_matches(kitchen):
    sj, st, o, d, rs = kitchen
    t_far = rs.uniform(0.05, 6.0, B).astype(np.float32)
    oj = j_trav.occlusion_bvh(sj.geom, sj.bvh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_far))
    ot = t_trav.occlusion_bvh(st.geom, st.bvh, torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(t_far))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0.05 < np.asarray(oj).mean() < 0.95


def test_wide_walk_matches(kitchen):
    """The 8-wide ordered-stack walks (accel/wide_traverse.py, traversal
    "wide") against the reference's on the same wide tree: equal prim ids
    and occlusion, and the skip walk's t on every hit (one arithmetic)."""
    sj, st, o, d, rs = kitchen
    t_far = rs.uniform(0.05, 6.0, B).astype(np.float32)
    wj, wt = j_wide.from_bvharrays(sj.bvh), t_wide.from_bvharrays(st.bvh)
    hj = j_wtrav.closest_hit_wide(sj.geom, wj, jnp.asarray(o), jnp.asarray(d))
    ht = t_wtrav.closest_hit_wide(st.geom, wt, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(ht["prim"].numpy(), np.asarray(hj["prim"]))
    hs = t_trav.closest_hit_bvh(st.geom, st.bvh, torch.as_tensor(o), torch.as_tensor(d))
    assert torch.equal(ht["prim"], hs["prim"]) and torch.equal(ht["t"], hs["t"])
    oj = j_wtrav.occlusion_wide(sj.geom, wj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_far))
    ot = t_wtrav.occlusion_wide(st.geom, wt, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(t_far))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert 0.05 < np.asarray(oj).mean() < 0.95
