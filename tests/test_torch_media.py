"""Port media primitives against the JAX reference on random inputs (rtol
1e-5): the five phase functions (evaluation and sampling), homogeneous
free-flight sampling and transmittance. Also the reference's HG sign
convention, which the port copies as it is (ROADMAP Queue 3), and the
fused kernel's own forward HG."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_pt_torch.media import homogeneous as t_homo
from cuda_pt_torch.media import phase as t_phase
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.scene import types as TT
from cuda_pt_tpu.media import homogeneous as j_homo
from cuda_pt_tpu.media import phase as j_phase
from cuda_pt_tpu.scene import types as JT

RTOL, ATOL = 1e-5, 1e-6
B = 2048
PHASES = {"isotropic": JT.PHASE_ISOTROPIC, "hg": JT.PHASE_HG, "dual_hg": JT.PHASE_DUAL_HG,
          "rayleigh": JT.PHASE_RAYLEIGH, "sggx": JT.PHASE_SGGX}


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL, err_msg=what)


def _unit(rs, n):
    v = rs.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _phase_inputs(ptype, seed):
    rs = np.random.default_rng(seed)
    g = rs.uniform(-0.9, 0.9, B).astype(np.float32)
    g[:64] = rs.uniform(-5e-4, 5e-4, 64)  # the |g| < 1e-3 branch of the HG sampler
    g2 = rs.uniform(-0.9, 0.9, B).astype(np.float32)
    w = rs.uniform(0.0, 1.0, B).astype(np.float32)
    pt = np.full(B, ptype, np.int32)
    return pt, g, g2, w, _unit(rs, B), _unit(rs, B), rs


@pytest.mark.parametrize("kind", list(PHASES))
def test_phase_eval_matches(kind):
    pt, g, g2, w, d_in, d_out, _ = _phase_inputs(PHASES[kind], 1)
    want = j_phase.phase_eval(jnp.asarray(pt), jnp.asarray(g), jnp.asarray(g2), jnp.asarray(w),
                              jnp.asarray(d_in), jnp.asarray(d_out))
    got = t_phase.phase_eval(*(torch.as_tensor(x) for x in (pt, g, g2, w, d_in, d_out)))
    _close(got, want, kind)


@pytest.mark.parametrize("kind", list(PHASES))
def test_phase_sample_matches(kind):
    pt, g, g2, w, d_in, _, rs = _phase_inputs(PHASES[kind], 2)
    u2 = rs.uniform(0.0, 1.0, (B, 2)).astype(np.float32)
    u1 = rs.uniform(0.0, 1.0, B).astype(np.float32)
    d_j, pdf_j = j_phase.phase_sample(*(jnp.asarray(x) for x in (pt, g, g2, w, d_in, u2, u1)))
    d_t, pdf_t = t_phase.phase_sample(*(torch.as_tensor(x) for x in (pt, g, g2, w, d_in, u2, u1)))
    _close(d_t, d_j, f"{kind} direction")
    _close(pdf_t, pdf_j, f"{kind} pdf")


def _media(seed):
    """A random table of four homogeneous media (numpy), per-lane ids with
    vacuum (-1) among them, surface distances with misses (1e7)."""
    rs = np.random.default_rng(seed)
    M = 4
    arrays = dict(mtype=np.zeros(M, np.int32),
                  sigma_a=rs.uniform(0.0, 0.5, (M, 3)).astype(np.float32),
                  sigma_s=rs.uniform(0.0, 2.0, (M, 3)).astype(np.float32),
                  scale=rs.uniform(0.5, 2.0, M).astype(np.float32),
                  phase_type=np.arange(M, dtype=np.int32), phase_g=np.zeros((M, 2), np.float32),
                  phase_w=np.ones(M, np.float32), emission_scale=np.zeros(M, np.float32),
                  grid_id=np.full(M, -1, np.int32))
    arrays["sigma_s"][1, 2] = 0.0  # a channel that does not scatter
    mid = rs.integers(-1, M, B).astype(np.int32)
    t_surf = rs.uniform(0.01, 5.0, B).astype(np.float32)
    t_surf[:128] = 1e7
    u = rs.uniform(0.0, 1.0, (B, 2)).astype(np.float32)
    jm = JT.MediumTable(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tm = TT.MediumTable(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    return jm, tm, mid, t_surf, u


def test_sample_distance_matches():
    jm, tm, mid, t_surf, u = _media(3)
    want = j_homo.sample_distance(jm, jnp.asarray(mid), jnp.asarray(t_surf), jnp.asarray(u))
    got = t_homo.sample_distance(tm, torch.as_tensor(mid), torch.as_tensor(t_surf),
                                 torch.as_tensor(u))
    np.testing.assert_array_equal(got["is_medium"].numpy(), np.asarray(want["is_medium"]))
    _close(got["t"], want["t"], "t")
    _close(got["weight"], want["weight"], "weight")
    for a, b in zip(t_homo.sigma_at(tm, torch.as_tensor(mid)),
                    j_homo.sigma_at(jm, jnp.asarray(mid))):
        _close(a, b, "sigma_at")


def test_transmittance_matches():
    jm, tm, mid, t_surf, _ = _media(4)
    dist = t_surf.copy()
    dist[:16] = -0.5  # clamped to 0
    _close(t_homo.transmittance(tm, torch.as_tensor(mid), torch.as_tensor(dist)),
           j_homo.transmittance(jm, jnp.asarray(mid), jnp.asarray(dist)))


def test_hg_sign_caveat_of_the_reference():
    """The reference's composed HG (media/phase.py) evaluates 1 + g^2 + 2g
    cos at cos = d_in . d_out, a backward-peaked lobe for g > 0, while its
    sampler draws forward around d_in: at g = 0.5 the value is 0.0177
    forward and 0.4775 backward, and 4,096 samples have a mean cosine near
    +0.49. The port copies it (both packages give the same numbers); the
    fused kernel's forward HG (models/volume_pt.phase_value_fused) is the
    reverse."""
    d = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (2, 1))
    out = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], np.float32)
    args = (np.full(2, JT.PHASE_HG, np.int32), np.full(2, 0.5, np.float32),
            np.zeros(2, np.float32), np.ones(2, np.float32), d, out)
    v_j = np.asarray(j_phase.phase_eval(*(jnp.asarray(a) for a in args)))
    v_t = t_phase.phase_eval(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(v_t, v_j, rtol=RTOL)
    np.testing.assert_allclose(v_t, [0.0177, 0.4775], atol=1e-4)
    mp = {"ptype": torch.full((2,), TT.PHASE_HG), "g1": torch.full((2,), 0.5),
          "g2": torch.zeros(2), "w": torch.ones(2)}
    fused = t_vpt.phase_value_fused(mp, torch.tensor([1.0, -1.0])).numpy()
    np.testing.assert_allclose(fused, v_t[::-1], rtol=1e-6)

    n = 4096
    rs = np.random.default_rng(5)
    u2 = torch.as_tensor(rs.uniform(0, 1, (n, 2)).astype(np.float32))
    d_out, _ = t_phase.phase_sample(torch.full((n,), TT.PHASE_HG), torch.full((n,), 0.5),
                                    torch.zeros(n), torch.ones(n),
                                    torch.as_tensor(np.tile([[0.0, 0.0, 1.0]], (n, 1)),
                                                    dtype=torch.float32), u2, torch.zeros(n))
    assert 0.47 < float(d_out[:, 2].mean()) < 0.52
