"""The port's Owen-scrambled Sobol sampler (cuda_pt_torch/core/qmc.py)
against the JAX reference: states and draws bit for bit on 4,096 lanes
across MAX_DIMS, the reference's property cases (tests/test_qmc.py), and
Sobol renders: the committed golden, the wavefront against the path
tracer, the light tracer's and the composed volume path tracer's passes
against JAX's at 16x16. No Pallas call."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core import rng as t_rng
from cuda_pt_torch.core.config import MaxDepthParams as TMD
from cuda_pt_torch.models import light_tracer as t_lt
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.models import wavefront as t_wf
from cuda_pt_torch.scene import bridge
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core import rng as j_rng
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.models import light_tracer as j_lt
from cuda_pt_tpu.models import volume_pt as j_vpt
from cuda_pt_tpu.scene import testscenes as j_ts
from cuda_pt_tpu.scene.builder import MediumSpec
from test_torch_bridge import flatten_jax_camera, flatten_jax_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "cornell_sobol_24_s4.npz")
LANES = (np.arange(4096, dtype=np.int64) * 7919 % 1_000_003).astype(np.int32)


def _bits(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _port(sj, cj):
    return (bridge.scene_from_numpy(flatten_jax_scene(sj)),
            bridge.camera_from_numpy(flatten_jax_camera(cj)))


# ---------------------------------------------------------------------------
# states and draws, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("base_seed, sample", [(4, 0), (0xFFFFFFF0, 77_777)])
def test_seed_and_make_state_bit_equal(base_seed, sample):
    sj = j_qmc.seed(base_seed, jnp.asarray(LANES), sample)
    st = t_qmc.seed(base_seed, torch.as_tensor(LANES), sample)
    np.testing.assert_array_equal(st.numpy(), _bits(sj))
    mj = j_qmc.make_state("sobol", base_seed, jnp.asarray(LANES), sample)
    mt = t_qmc.make_state("sobol", base_seed, torch.as_tensor(LANES), sample)
    assert mt.shape == (4096, 4) and mt.dtype == torch.int64
    np.testing.assert_array_equal(mt.numpy(), _bits(mj))


def test_mixed_draws_across_max_dims_bit_equal():
    """40 draws, 1d / 2d / discrete / 2d in turn (each 2d draw after an
    odd dim aligning up), from dim 0 to dim 80, past MAX_DIMS (the hash
    fall-back): every value and every state equal to JAX's."""
    draws_j = [jax.jit(j_rng.next1d), jax.jit(j_rng.next2d),
               jax.jit(lambda s: j_rng.discrete1d(s, 7))]
    draws_t = [t_rng.next1d, t_rng.next2d, lambda s: t_rng.discrete1d(s, 7)]
    sj = j_qmc.make_state("sobol", 11, jnp.asarray(LANES), 3)
    st = t_qmc.make_state("sobol", 11, torch.as_tensor(LANES), 3)
    for k in range(40):
        kind = (0, 1, 2, 1)[k % 4]
        uj, sj = draws_j[kind](sj)
        ut, st = draws_t[kind](st)
        assert ut.dtype == (torch.int32 if kind == 2 else torch.float32)
        np.testing.assert_array_equal(ut.numpy(), np.asarray(uj), err_msg=f"draw {k}")
        np.testing.assert_array_equal(st.numpy(), _bits(sj), err_msg=f"state {k}")
    assert int(st[0, 1]) == 80 > t_qmc.MAX_DIMS


def test_per_lane_sample_index_bit_equal():
    """sample_idx as a per-lane tensor (adaptive sampling's), under both
    samplers, and the draws that follow."""
    s_idx = (np.arange(4096) % 13 + 1000).astype(np.uint32)
    for sampler in ("sobol", "pcg"):
        sj, uj = jax.jit(lambda lane, s: (lambda st: (st, j_rng.next2d(st)[0]))(
            j_qmc.make_state(sampler, 9, lane, s)))(jnp.asarray(LANES), jnp.asarray(s_idx))
        st = t_qmc.make_state(sampler, 9, torch.as_tensor(LANES),
                              torch.as_tensor(s_idx.astype(np.int64)))
        np.testing.assert_array_equal(st.numpy(), _bits(sj))
        np.testing.assert_array_equal(t_rng.next2d(st)[0].numpy(), np.asarray(uj))


def test_mul32_wraps_like_u32():
    """rng.mul32 against Python's arithmetic on u32 edges and random
    values, for constants below and at or above 2^31."""
    rs = np.random.default_rng(5)
    x = np.concatenate([[0, 1, 2**31 - 1, 2**31, 2**32 - 1],
                        rs.integers(0, 2**32, 2000)]).astype(np.int64)
    for c in (9781, 0x6C50B47C, 0x7FFFFFFF, 0x80000000, 0x9E3779B9, 0xFFFFFFFF):
        got = t_rng.mul32(torch.as_tensor(x), c).numpy()
        want = np.array([(int(v) * c) & 0xFFFFFFFF for v in x], np.int64)
        np.testing.assert_array_equal(got, want)


def test_unknown_sampler_names_the_value():
    with pytest.raises(NotImplementedError, match="'halton'"):
        t_qmc.make_state("halton", 0, torch.arange(4), 0)


# ---------------------------------------------------------------------------
# the reference's property cases (tests/test_qmc.py)
# ---------------------------------------------------------------------------


def _pair_points(lane_val: int, n: int, pair: int = 0, base_seed: int = 7) -> np.ndarray:
    st = t_qmc.seed(base_seed, torch.full((n,), lane_val), torch.arange(n))
    for _ in range(pair):
        _, st = t_qmc.next2d(st)
    return t_qmc.next2d(st)[0].numpy()


@pytest.mark.parametrize("lane_val", [0, 311])
def test_elementary_interval_stratification(lane_val):
    """The first 16 samples of any pair fill every 16-cell elementary grid."""
    for pair in (0, 1, 3):
        p = _pair_points(lane_val, 16, pair)
        for nx, ny in [(4, 4), (16, 1), (1, 16), (8, 2), (2, 8)]:
            assert len({(int(x * nx), int(y * ny)) for x, y in p}) == 16, (pair, nx, ny)


def test_progressive_prefixes_stratified():
    p = _pair_points(5, 64)
    for m in (4, 16, 64):
        g = int(np.sqrt(m))
        assert len({(int(x * g), int(y * g)) for x, y in p[:m]}) == m


def test_lanes_decorrelated():
    assert np.abs(_pair_points(0, 16) - _pair_points(1, 16)).max() > 0.05


def test_uniform_mean():
    st = t_qmc.seed(3, torch.arange(4096), 0)
    us = []
    for _ in range(8):
        u, st = t_qmc.next2d(st)
        us.append(u.numpy())
    u = np.concatenate(us, axis=-1)
    assert abs(u.mean() - 0.5) < 0.01 and abs(u.var() - 1.0 / 12.0) < 0.005


def test_dispatch_via_rng_module():
    """rng.next1d / next2d / discrete1d route (..., 4) states to qmc; a 2d
    draw aligns up to a pair boundary (dim 1 -> pair [2, 3] -> dim 4)."""
    st = t_qmc.seed(1, torch.arange(8), 2)
    u1, st1 = t_rng.next1d(st)
    assert u1.shape == (8,) and st1.shape == (8, 4)
    u2, st2 = t_rng.next2d(st1)
    assert u2.shape == (8, 2) and int(st2[0, 1]) == 4
    i, _ = t_rng.discrete1d(st2, 5)
    assert bool(((i >= 0) & (i < 5)).all())


def test_deep_dims_fall_back_but_stay_uniform():
    st = t_qmc.seed(9, torch.arange(2048), 1)
    st[..., 1] = t_qmc.MAX_DIMS + 3
    u = t_rng.next2d(st)[0].numpy()
    assert abs(u.mean() - 0.5) < 0.02 and u.min() >= 0 and u.max() < 1


# ---------------------------------------------------------------------------
# Sobol renders
# ---------------------------------------------------------------------------


def test_pt_sobol_matches_golden():
    """pt.render(cornell 24x24, max_depth 4, 8 spp, seed 4, the tree
    walked, sampler "sobol") against the committed JAX golden under
    test_golden._check's f32 contract."""
    st, ct = _port(*j_ts.cornell_box(width=24, height=24)[:2])
    img = t_pt.render(st, ct, TMD(max_depth=4), spp=8, seed=4, use_bvh=True,
                      sampler="sobol").numpy()
    ref = np.load(GOLDEN)["img"].astype(np.float32)
    assert img.shape == ref.shape
    assert np.isclose(img, ref, atol=2e-4, rtol=1e-4).mean() > 0.995
    assert abs(float(img.mean()) - float(ref.mean())) < 5e-4


def test_wavefront_sobol_matches_path_tracer():
    """The (B, 4) states survive the wavefront's sorts and compaction
    ladder: its compact Sobol render equals pt.render's up to the splat's
    add order (the reference's test_qmc.py tolerance)."""
    st, ct = _port(*j_ts.cornell_box(width=24, height=24)[:2])
    md = TMD(max_depth=4)
    a = t_pt.render(st, ct, md, spp=4, seed=3, use_bvh=False, sampler="sobol").numpy()
    b = t_wf.render(st, ct, md, spp=4, seed=3, compact=True, sampler="sobol").numpy()
    np.testing.assert_allclose(a, b, rtol=5e-4, atol=1e-4)


def test_light_tracer_sobol_pass_matches_jax():
    """One Sobol light-tracing pass (pass 1, seed 9) on cornell 16x16,
    brute force: per pixel allclose(rtol 1e-4, atol 1e-6) on >= 99 %, sums
    within 1e-4, and unlike the pcg pass."""
    sj, cj, _ = j_ts.cornell_box(16, 16)
    run = jax.jit(lambda s, c: j_lt.render_pass(s, c, JMD(max_depth=4), 9, 1, False,
                                                sampler="sobol"))
    img_j = np.asarray(run(sj, cj))
    st, ct = _port(sj, cj)
    img_t = t_lt.render_pass(st, ct, TMD(max_depth=4), 9, 1, False, sampler="sobol").numpy()
    assert np.isfinite(img_t).all() and img_j.sum() > 0
    close = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(img_t.sum() / img_j.sum() - 1.0) < 1e-4
    pcg = t_lt.render_pass(st, ct, TMD(max_depth=4), 9, 1, False).numpy()
    assert not np.array_equal(pcg, img_t)


def test_composed_vpt_sobol_matches_jax():
    """volume_pt.render on cornell with the camera inside a medium, 16x16,
    max_depth 4, 2 spp, sampler "sobol": the VPT contract per pixel
    (allclose rtol 1e-4, atol 1e-5 on >= 95 %, means within 1e-3)."""
    _, cj, b = j_ts.cornell_box(width=16, height=16)
    b.add_medium(MediumSpec(sigma_a=(0.05, 0.05, 0.05), sigma_s=(0.25, 0.25, 0.25)))
    sj = b.compile().replace(cam_medium=jnp.int32(0))
    img_j = np.asarray(j_vpt.render(sj, cj, JMD(max_depth=4), spp=2, seed=5, use_bvh=False,
                                    sampler="sobol"))
    st, ct = _port(sj, cj)
    img_t = t_vpt.render(st, ct, TMD(max_depth=4), spp=2, seed=5, use_bvh=False,
                         sampler="sobol").numpy()
    close = np.isclose(img_t, img_j, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert np.isfinite(img_t).all() and img_j.mean() > 0.01
    assert close.mean() >= 0.95, (close.mean(), np.abs(img_t - img_j).max())
    assert abs(img_t.mean() - img_j.mean()) <= 1e-3 * abs(img_j.mean())
