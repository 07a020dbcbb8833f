"""The JAX package's last public helpers against their port counterparts:
core/math (to_local, spherical_to_dir, sqr), core/sampling
(uniform_hemisphere, uniform_cone, balance_heuristic), ops/morton
(direction_octant) and utils/timing (warm_readback). Seeded numpy inputs
through both sides, eager (no JAX trace); values within 1e-6, ints
exact."""

import numpy as np
import pytest
import torch

from cuda_pt_torch.core import math as t_math
from cuda_pt_torch.core import sampling as t_sampling
from cuda_pt_torch.ops import morton as t_morton
from cuda_pt_torch.utils import timing as t_timing
from cuda_pt_tpu.core import math as j_math
from cuda_pt_tpu.core import sampling as j_sampling
from cuda_pt_tpu.ops import morton as j_morton

N = 257


def _inputs():
    rs = np.random.default_rng(2024)
    n = rs.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = rs.normal(size=(N, 3)).astype(np.float32)
    d[:8] = [[0, 0, 0], [-0.0, 1, 0], [1, -0.0, 0], [0, 0, -0.0],
             [-1, -1, -1], [1, 1, 1], [0, -1, 0], [-1, 0, 1]]  # zeros and signed zeros
    u = rs.uniform(size=(N, 2)).astype(np.float32)
    pdf = rs.uniform(0, 2, size=(2, N)).astype(np.float32)
    pdf[0, :9] = 0.0
    return {"n": n, "d": d, "u": u, "theta": rs.uniform(0, np.pi, N).astype(np.float32),
            "phi": rs.uniform(0, 2 * np.pi, N).astype(np.float32), "pdf": pdf,
            "cos_max": rs.uniform(-0.5, 0.999, N).astype(np.float32)}


def _pair(name, x):
    """(port output, JAX output) of helper name on inputs x, as numpy."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cases = {
        "to_local": (lambda: t_math.to_local(t["d"], t["n"]),
                     lambda: j_math.to_local(x["d"], x["n"])),
        "spherical_to_dir": (lambda: t_math.spherical_to_dir(t["theta"], t["phi"]),
                             lambda: j_math.spherical_to_dir(x["theta"], x["phi"])),
        "sqr": (lambda: t_math.sqr(t["d"]), lambda: j_math.sqr(x["d"])),
        "uniform_hemisphere": (lambda: t_sampling.uniform_hemisphere(t["u"]),
                               lambda: j_sampling.uniform_hemisphere(x["u"])),
        "uniform_cone": (lambda: t_sampling.uniform_cone(t["u"], t["cos_max"]),
                         lambda: j_sampling.uniform_cone(x["u"], x["cos_max"])),
        "balance_heuristic": (lambda: t_sampling.balance_heuristic(t["pdf"][0], t["pdf"][1]),
                              lambda: j_sampling.balance_heuristic(x["pdf"][0], x["pdf"][1])),
        "direction_octant": (lambda: t_morton.direction_octant(t["d"]),
                             lambda: j_morton.direction_octant(x["d"])),
    }
    got, want = cases[name]
    as_np = lambda r: [np.asarray(v) for v in (r if isinstance(r, tuple) else (r,))]  # noqa: E731
    return as_np(got()), as_np(want())


@pytest.mark.parametrize("name", ["to_local", "spherical_to_dir", "sqr", "uniform_hemisphere",
                                  "uniform_cone", "balance_heuristic", "direction_octant",
                                  "warm_readback"])
def test_helper_matches_reference(name):
    if name == "warm_readback":
        # the reference's signature; on the CPU a copy of a small product
        s = t_timing.warm_readback()
        assert isinstance(s, float) and 0.0 <= s < 5.0
        assert t_timing.warm_readback(False, device="cpu") >= 0.0
        return
    got, want = _pair(name, _inputs())
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name == "direction_octant":
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w.astype(np.int64))
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=name)
