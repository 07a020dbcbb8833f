"""The port's megakernel module against the JAX reference (the CUDA
kernels against their plain versions on a card: tests/test_torch_cuda.py).

Per-lane contract (a thread-per-ray walk regroups rays, like the TPU's
tile-shared walk): allclose(rtol=1e-4, atol=1e-5) on all three channels,
with at most 2 % of lanes differing."""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.scene import bridge
from cuda_pt_torch.scene import testscenes as t_ts
from cuda_pt_torch.scene import types as TT
from cuda_pt_torch.scene.builder import BSDFSpec
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.ops import intersect as j_isect
from cuda_pt_tpu.ops.pallas import megakernel as j_mk
from cuda_pt_tpu.scene import testscenes as j_ts
from test_torch_bridge import flatten_jax_scene

RTOL, ATOL, MAX_LANE_FRAC = 1e-4, 1e-5, 0.02


def lanes_differing(a: np.ndarray, b: np.ndarray) -> float:
    return float((~np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=-1)).mean())


def test_trace_megakernel_cpu_matches_jax_interpret():
    """cornell 8x8, max_depth 3: port trace_megakernel (plain version on
    CPU tensors) vs JAX trace_megakernel(interpret=True) on the same o, d, rng."""
    sj, cj, _ = j_ts.cornell_box(8, 8)
    lane = jnp.arange(64, dtype=jnp.int32)
    rng = j_qmc.make_state("pcg", 5, lane, 1)
    o, d, rng = j_cam.generate_rays(cj, lane, rng)
    Lj = np.asarray(j_mk.trace_megakernel(j_mk.make_pack(sj, node_fmt="w8"), JMD(max_depth=3),
                                          o, d, rng, interpret=True))
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    before = dict(t_mk.LAUNCHES)
    Lt = t_mk.trace_megakernel(t_mk.make_pack(st), TMD(max_depth=3), torch.tensor(np.asarray(o)),
                               torch.tensor(np.asarray(d)),
                               torch.tensor(np.asarray(rng).astype(np.int64))).numpy()
    assert t_mk.LAUNCHES == before  # CPU tensors never count as kernel launches
    assert np.isfinite(Lt).all() and Lt.shape == (64, 3)
    assert Lj.mean() > 0.05
    assert lanes_differing(Lt, Lj) <= MAX_LANE_FRAC, np.abs(Lt - Lj).max(axis=-1)


def test_closest_hit_w8_cpu_is_brute_force_reference():
    sj, _, _ = j_ts.cornell_box(8, 8)
    st = bridge.scene_from_numpy(flatten_jax_scene(sj))
    rs = np.random.default_rng(5)
    o = rs.uniform(0.05, 0.95, (2048, 3)).astype(np.float32)
    d = rs.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    hj = j_isect.closest_hit_brute(sj.geom, jnp.asarray(o), jnp.asarray(d))
    t, prim, b1, b2 = t_mk.closest_hit_w8(t_mk.make_pack(st), torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(prim.numpy(), np.asarray(hj["prim"]))
    np.testing.assert_allclose(t.numpy(), np.asarray(hj["t"]), rtol=1e-6)
    np.testing.assert_allclose(b1.numpy(), np.asarray(hj["b1"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b2.numpy(), np.asarray(hj["b2"]), rtol=1e-5, atol=1e-6)


def test_envelope_matches_reference_on_supported_families():
    sj, _, _ = j_ts.cornell_box(8, 8)
    assert j_mk.megakernel_ok(sj) and t_mk.megakernel_ok(bridge.scene_from_numpy(flatten_jax_scene(sj)))
    plastic = BSDFSpec(btype=TT.BSDF_PLASTIC, k_d=(0.5, 0.5, 0.5))
    st, _, _ = t_ts.cornell_box(8, 8, tall_box_bsdf=plastic)
    assert not t_mk.megakernel_ok(st)  # narrowed: only three families ported


def test_kernel_input_check_rejects_cpu_tensors():
    st, _, _ = t_ts.cornell_box(8, 8)
    pack = t_mk.make_pack(st)
    o = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        t_mk._check_rays(pack, o)


def test_emitter_prim_rows_follow_emitter_order():
    """The kernel's NEE pick (csrc/nee.cuh) finds an area emitter's CDF rows
    at the sum of kmax + 1 over the area emitters before it, and picks the
    row by binary search. With a point light between two area lights, those
    rows belong to the emitter in k order, and the search gives the plain
    version's count of CDF entries below u."""
    scene, _, _ = t_ts.cornell_box_lights(8, 8)
    pack = t_mk.make_pack(scene)
    er = pack["erow"].numpy().reshape(-1, t_mk.SLOT_F)
    ep = pack["eprims"].numpy().reshape(-1, t_mk.SLOT_F)
    cdf = scene.emitters.prim_cdf.numpy()
    u = np.random.default_rng(5).uniform(0.0, 1.0, 4096).astype(np.float32)
    area = (TT.EMITTER_AREA, TT.EMITTER_AREA_SPOT)
    seen = 0
    for eid in range(1, er.shape[0]):
        if int(er[eid, 0]) not in area:
            continue
        seen += 1
        kmax = int(er[eid, 9])
        base = sum(int(er[i, 9]) + 1 for i in range(1, eid) if int(er[i, 0]) in area)
        rows = ep[base: base + kmax + 1]
        np.testing.assert_array_equal(rows[:, 10], eid)
        np.testing.assert_array_equal(rows[:, 11], np.arange(kmax + 1))
        k_kernel = np.minimum(np.searchsorted(rows[:, 9], u, side="left"), kmax)
        k_plain = np.minimum((cdf[eid][None, :] < u[:, None]).sum(-1), cdf.shape[1] - 1)
        np.testing.assert_array_equal(k_kernel, k_plain)
    assert seen == 2 and t_mk.megakernel_ok(scene)
