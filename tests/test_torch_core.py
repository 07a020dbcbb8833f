"""Port core modules (cuda_pt_torch.core) against the JAX reference:
pcg states and uniforms bit-equal, camera rays to the ulp, film."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.core import film as t_film
from cuda_pt_torch.core import qmc as t_qmc
from cuda_pt_torch.core import rng as t_rng
from cuda_pt_torch.core import sampling as t_sampling
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.core import film as j_film
from cuda_pt_tpu.core import qmc as j_qmc
from cuda_pt_tpu.core import rng as j_rng
from cuda_pt_tpu.core import sampling as j_sampling


@pytest.mark.parametrize("seed,sample", [(0, 0), (1234, 3), (0xFFFFFFFF, 77), (0x80000001, 9781)])
def test_pcg_states_and_uniforms_bit_equal(seed, sample):
    lane = np.random.default_rng(1).integers(0, 2**31 - 1, 4096).astype(np.int32)
    sj = j_qmc.make_state("pcg", seed, jnp.asarray(lane), sample)
    st = t_qmc.make_state("pcg", seed, torch.as_tensor(lane), sample)
    np.testing.assert_array_equal(np.asarray(sj).astype(np.int64), st.numpy())
    for _ in range(3):  # several advances, 2d and 1d draws
        uj, sj = j_rng.next2d(sj)
        ut, st = t_rng.next2d(st)
        np.testing.assert_array_equal(np.asarray(uj), ut.numpy())
        u1j, sj = j_rng.next1d(sj)
        u1t, st = t_rng.next1d(st)
        np.testing.assert_array_equal(np.asarray(u1j), u1t.numpy())
    np.testing.assert_array_equal(np.asarray(sj).astype(np.int64), st.numpy())


def test_u01_rounds_like_u32_cast():
    bits = np.array([0, 1, 2**24 - 1, 2**24 + 1, 2**31 - 1, 2**31, 2**32 - 129, 2**32 - 1],
                    np.uint32)
    want = bits.astype(np.float32) * np.float32(2.3283064365386963e-10)
    got = t_rng.u01(torch.as_tensor(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


def test_sampling_warps_match():
    u = np.random.default_rng(2).random((512, 2)).astype(np.float32)
    dj, pj = j_sampling.cosine_hemisphere(jnp.asarray(u))
    dt, pt_ = t_sampling.cosine_hemisphere(torch.as_tensor(u))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pt_.numpy(), np.asarray(pj), rtol=1e-6)
    np.testing.assert_allclose(t_sampling.uniform_triangle(torch.as_tensor(u)).numpy(),
                               np.asarray(j_sampling.uniform_triangle(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)
    a, b = (np.random.default_rng(3).random((2, 512)) * 3).astype(np.float32)
    np.testing.assert_allclose(
        t_sampling.power_heuristic(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.asarray(j_sampling.power_heuristic(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (same-sign finite values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("kw", [{}, {"hflip": True}, {"aperture": 0.05, "focal_dist": 1.8}])
def test_camera_rays_cornell_ulps(kw):
    args = dict(origin=(0.5, 0.5, -1.35), target=(0.5, 0.5, 0.5), fov=40.0, width=24, height=16)
    cj = j_cam.make_camera(**args, **kw)
    ct = t_cam.make_camera(**args, **kw)
    np.testing.assert_array_equal(ct.R.numpy(), np.asarray(cj.R))
    np.testing.assert_array_equal(ct.focal.numpy(), np.asarray(cj.focal))
    lane = np.arange(24 * 16, dtype=np.int32)
    oj, dj, rj = j_cam.generate_rays(cj, jnp.asarray(lane),
                                     j_qmc.make_state("pcg", 7, jnp.asarray(lane), 2))
    ot, dt, rt = t_cam.generate_rays(ct, torch.as_tensor(lane),
                                     t_qmc.make_state("pcg", 7, torch.as_tensor(lane), 2))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj).astype(np.int64))
    assert _ulps(ot.numpy(), np.asarray(oj)).max() <= 1  # lens origins: sin/cos ulps
    # The port rounds the unit direction once from float64; the reference
    # multiplies by XLA's float32 rsqrt, itself up to 1 ulp off, which the
    # product can widen to 2 ulps on a few components (measured: 8 of 1152).
    u = _ulps(dt.numpy(), np.asarray(dj))
    assert u.max() <= 2 and (u > 1).mean() <= 0.01, np.bincount(u.ravel())


def test_film_welford_matches_reference():
    rs = np.random.default_rng(4)
    fj = j_film.make_film(6, 5)
    ft = t_film.make_film(6, 5)
    for _ in range(5):
        img = rs.random((6, 5, 3)).astype(np.float32)
        fj = j_film.accumulate(fj, jnp.asarray(img))
        ft = t_film.accumulate(ft, torch.as_tensor(img))
    assert ft.count == int(fj.count) == 5
    np.testing.assert_allclose(ft.mean.numpy(), np.asarray(fj.mean), rtol=1e-6)
    np.testing.assert_allclose(t_film.variance(ft).numpy(), np.asarray(j_film.variance(fj)),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(t_film.export_numpy(ft), j_film.export_numpy(fj))
