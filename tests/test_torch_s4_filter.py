"""Kernel S4's mxu arithmetic on the CPU: the TF32 split of its prologue,
its divide-free filter in front of the exact test, and the combine of its
leaf chunks' least t (csrc/mxuleaf.cu; the card runs the kernel itself in
tests/test_torch_cuda.py and chip_smoke.py phase 15).

- ``tf32_split`` against a NumPy model of the rounding written with float64
  arithmetic (round to nearest, ties away from zero, at a 10-bit
  significand), on ties, both signs, subnormals and random values.
- ``filter_pass`` never rejects a triangle that the exact test
  (``mxuleaf._epilogue``, the script's :158-164) accepts, on drawn and on
  adversarial inputs: |det| at and around 1e-12, u + v at 1 and one ulp
  either side, t at 1e-4 and at t_best, both signs of det; the filter and
  then the exact test give the exact test's least t bit for bit.
- the kernel's combine of its leaf chunks (an atomicMin on the int bits of
  a non-negative float) equals the plain version's whole minimum.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cuda_pt_torch.ops import mxuleaf as mx

F32 = np.float32


def _rna_model(x: np.ndarray) -> np.ndarray:
    """x rounded to TF32 in float64 arithmetic: the spacing of a 10-bit
    significand at x's binade (2^-136 below the normals), to nearest, ties
    away from zero."""
    x64 = x.astype(np.float64)
    _, e = np.frexp(np.abs(x64))  # |x| in [2^(e-1), 2^e)
    ulp = np.maximum(np.ldexp(1.0, e - 11), 2.0 ** -136)
    mag = np.floor(np.abs(x64) / ulp + 0.5) * ulp
    with np.errstate(over="ignore"):
        return (np.sign(x64) * mag).astype(F32)


def _tie_values() -> np.ndarray:
    """Values exactly halfway between two TF32 numbers, of both signs, and
    their f32 neighbours."""
    rs = np.random.default_rng(0)
    bits = rs.integers(0x00800000, 0x7F000000, 256, dtype=np.int64) & ~0x1FFF
    ties = (bits | 0x1000).astype(np.uint32).view(F32)
    near = np.concatenate([np.nextafter(ties, np.inf), np.nextafter(ties, -np.inf)])
    vals = np.concatenate([ties, near])
    return np.concatenate([vals, -vals])


@pytest.mark.parametrize("kind", ["ties", "random", "subnormal"])
def test_tf32_split_rounds_ties_away(kind):
    rs = np.random.default_rng(1)
    x = {"ties": _tie_values(),
         "random": (rs.normal(size=4096) * 10.0 ** rs.integers(-30, 30, 4096)).astype(F32),
         "subnormal": (rs.uniform(-1, 1, 1024) * 2.0 ** -126).astype(F32)}[kind]
    hi, lo = mx.tf32_split(torch.as_tensor(x))
    want_hi = _rna_model(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  _rna_model((x - want_hi).astype(F32)).view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    # hi + lo is x to about f32's precision (lo's TF32 spacing is 2^-136 below the normals)
    err = np.abs(hi.numpy().astype(np.float64) + lo.numpy() - x)
    assert (err <= np.abs(x.astype(np.float64)) * 2.0 ** -20 + 2.0 ** -136).all()
    if kind == "ties":  # halfway values round away from zero
        t = x[:256]
        assert (np.abs(hi.numpy()[:256]) > np.abs(t)).all()


def _exact(det, u_n, v_n, t_n):
    return mx._epilogue(det, u_n, v_n, t_n)


def _hold(det, u_n, v_n, t_n, t_best):
    """The filter passes every candidate the exact test accepts below
    t_best; filter-then-exact equals the exact test's update bit for bit."""
    tgate = t_best * (1.0 + 2.0 ** -20)
    t = _exact(det, u_n, v_n, t_n)
    accept = torch.isfinite(t) & (t < t_best)
    passed = mx.filter_pass(det, u_n, v_n, t_n, tgate)
    assert not bool((accept & ~passed).any()), "the filter rejects a triangle the test accepts"
    new = torch.where(passed & accept, t, t_best)
    assert torch.equal(new.view(torch.int32), torch.where(accept, t, t_best).view(torch.int32))
    return accept, passed


def _f(x):
    return torch.as_tensor(np.asarray(x, F32))


def test_filter_adversarial_det():
    """|det| at and one or two ulps around 1e-12, both signs, with u, v, t
    inside the triangle."""
    base = F32(1e-12)
    dets = [np.nextafter(base, F32(0)), base, np.nextafter(base, F32(1)),
            np.nextafter(np.nextafter(base, F32(1)), F32(1)), F32(2e-12)]
    dets = np.array(dets + [-x for x in dets], F32)
    a = np.abs(dets)
    sg = np.sign(dets)
    det = _f(dets)
    u_n, v_n, t_n = _f(0.25 * a * sg), _f(0.25 * a * sg), _f(0.5 * a * sg)
    accept, _ = _hold(det, u_n, v_n, t_n, torch.full_like(det, torch.inf))
    # the exact test accepts exactly |det| > 1e-12
    assert accept.tolist() == [bool(x > F32(1e-12)) for x in a]


def test_filter_adversarial_edges():
    """u + v at 1 and one ulp either side, u and v at zero and -0, t at 1e-4
    and one ulp either side, t at t_best, both signs of det, dets from
    1e-12 to 1e30."""
    rows = []
    one = F32(1.0)
    for det in (F32(3e-12), F32(0.37), F32(1.0), F32(1.7e3), F32(2.5e30)):
        for s in (F32(1), F32(-1)):
            dd = det * s
            fdet = F32(1) / dd
            for uv in (np.nextafter(one, F32(0)), one, np.nextafter(one, F32(2))):
                # u_n, v_n with fdet * u_n + fdet * v_n near uv
                for split in (F32(0.5), F32(0.0), F32(1.0), F32(0.3)):
                    u_n = F32(uv * split) * dd
                    v_n = F32(uv * (F32(1) - split)) * dd
                    for dv in (-1, 0, 1):
                        v2 = F32(v_n)
                        for _ in range(abs(dv)):
                            v2 = np.nextafter(v2, F32(np.inf) if dv > 0 else F32(-np.inf))
                        rows.append((dd, u_n, v2, F32(0.5) * dd))
            for u_n in (F32(0.0), F32(-0.0), F32(-1e-45), F32(1e-45)):
                rows.append((dd, u_n * s, F32(0.2) * dd, F32(0.5) * dd))
                rows.append((dd, F32(0.2) * dd, u_n * s, F32(0.5) * dd))
            tau = F32(1e-4)
            for t in (np.nextafter(tau, F32(0)), tau, np.nextafter(tau, F32(1)),
                      np.nextafter(np.nextafter(tau, F32(1)), F32(1))):
                # t_n with fdet * t_n at and around t
                for k in range(-2, 3):
                    t_n = F32(t * dd)
                    for _ in range(abs(k)):
                        t_n = np.nextafter(t_n, F32(np.inf) if k > 0 else F32(-np.inf))
                    rows.append((dd, F32(0.2) * dd, F32(0.2) * dd, t_n))
            del fdet
    r = np.array(rows, F32)
    det, u_n, v_n, t_n = (_f(r[:, i]) for i in range(4))
    accept, passed = _hold(det, u_n, v_n, t_n, torch.full_like(det, torch.inf))
    assert 0 < int(accept.sum()) < len(rows)
    # t at t_best: the candidates just accepted, against a best of their own t
    # (not accepted: strictly smaller is needed) and of one ulp either side
    t_acc = _exact(det, u_n, v_n, t_n)[accept]
    for t_best in (t_acc, torch.nextafter(t_acc, torch.full_like(t_acc, torch.inf)),
                   torch.nextafter(t_acc, torch.zeros_like(t_acc))):
        acc2, _ = _hold(det[accept], u_n[accept], v_n[accept], t_n[accept], t_best)
        assert bool((acc2 == (t_acc < t_best)).all())


def _floats(lo: float, hi: float):
    return st.floats(float(F32(lo)), float(F32(hi)), width=32)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.tuples(_floats(-1e6, 1e6), _floats(-1e6, 1e6), _floats(-1e6, 1e6),
                          _floats(-1e6, 1e6), _floats(1e-6, 1e6) | st.just(float("inf"))),
                min_size=1, max_size=64))
def test_filter_never_rejects_what_the_test_accepts(rows):
    r = np.array(rows, F32)
    _hold(*(_f(r[:, i]) for i in range(5)))


@settings(max_examples=200, deadline=None, database=None)
@given(_floats(1e-13, 1e4), _floats(-0.1, 1.1), _floats(-0.1, 1.1), _floats(-1.0, 10.0),
       st.booleans())
def test_filter_near_the_triangle(a, u, v, t, neg):
    """Candidates drawn as (det, u, v, t) around the triangle's edges and
    the ray's origin: u_n = u det etc., both signs of det."""
    det = F32(-a if neg else a)
    row = np.array([[det, F32(u) * det, F32(v) * det, F32(t) * det, np.inf]], F32)
    _hold(*(_f(row[:, i]) for i in range(5)))


def test_filter_then_exact_equals_the_reference_over_leaves():
    """Leaf by leaf over a drawn scene, the kernel's update (filter with the
    running t gate, then the exact test) gives mxu_reference's least t bit
    for bit; the filter lets through a small share of the candidates."""
    inp = mx.make_inputs(3, 1, 64)
    o, d, coef = inp["o"], inp["d"], inp["coef"]
    feat = mx.features(o, d)
    m = torch.matmul(coef.reshape(64, 32, 16), feat).reshape(64, 8, 4, -1)
    t_best = torch.full((o.shape[0],), torch.inf)
    passed = 0
    for lf in range(64):
        for k in range(8):
            det, u_n, v_n, t_n = m[lf, k]
            tgate = t_best * (1.0 + 2.0 ** -20)
            ok = mx.filter_pass(det, u_n, v_n, t_n, tgate)
            passed += int(ok.sum())
            t = _exact(det, u_n, v_n, t_n)
            t_best = torch.where(ok & (t < t_best), t, t_best)
    want = mx.mxu_reference(coef, o, d)
    assert torch.equal(t_best.view(torch.int32), want.view(torch.int32))
    assert 0 < passed < 0.2 * 64 * 8 * o.shape[0]


@pytest.mark.parametrize("chunks", [1, 3, 7, 16])
def test_chunked_min_combine_equals_whole_min(chunks):
    """The leaves cut into chunks of whole stages (two leaves), each chunk's
    least t taken alone, the chunks combined by the minimum of their f32
    bits as int32 (the kernel's atomicMin onto +inf): the plain version's
    whole minimum, bit for bit."""
    nleaf = 32
    inp = mx.make_inputs(5, 2, nleaf)
    o, d, coef = inp["o"], inp["d"], inp["coef"].reshape(nleaf, 32, 16)
    nst = nleaf // 2
    spc = -(-nst // chunks)
    out = torch.full((o.shape[0],), torch.inf).view(torch.int32)
    for s0 in range(0, nst, spc):
        part = mx.mxu_reference(coef[2 * s0:2 * (s0 + spc)].reshape(-1, 16), o, d)
        assert bool((part > 0).all())
        out = torch.minimum(out, part.view(torch.int32))
    whole = mx.mxu_reference(inp["coef"], o, d)
    assert torch.equal(out, whole.view(torch.int32))
    assert 0.1 < float(torch.isfinite(whole).float().mean()) < 1.0
