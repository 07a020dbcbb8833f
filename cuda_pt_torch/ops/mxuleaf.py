"""Kernel S4: the leaf triangle test, scalar and on the tensor cores (port of
the TPU kernels kern_scalar, :99, and kern_mxu, :139, of
scripts/exp_r5_mxuleaf.py; pallas_call at :176).

Each ray tests the 8 triangles of each leaf and keeps the least hit t (inf
where it hits none). Moller-Trumbore is bilinear in the ray's features
f = (o x d, d, o, 1) and per-triangle constants, so det, u_num, v_num and
t_num of a leaf's 8 triangles are one (32, 16) x (16, rays) product (the
coefficient rows 4 k + j: det, u, v, t of triangle k). Forms:
  scalar       per-triangle Moller-Trumbore from the leaf's row (9 fields x
               8: a, e1, e2); the kernel is bit-equal to the plain version
  mxu          the product on the tensor cores (wgmma TF32 in 3xTF32,
               which keeps f32's accuracy, as the reference's
               Precision.HIGHEST does), then a divide-free filter and the
               script's epilogue on what passes it
  mxu_1xtf32   the product in one TF32 pass: an A/B of the split's cost,
               not a port of kern_mxu

On CUDA tensors ``leaf_min_t`` launches the kernel (csrc/mxuleaf.cu) or
raises; on CPU tensors it runs the plain version, and only there. Each
launch adds one to ``LAUNCHES["mxuleaf"]`` (the package's one launch dict,
ops/traverse_kernel.LAUNCHES).

    python -m cuda_pt_torch.ops.mxuleaf [--device cpu] [--rows 8192] [--nleaf N]

prints the reference's rows (sec, ns_per_leaf, ns_per_prim_lane, checksum
per form; the parity of mxu and scalar) as JSON lines; the times are the
card's (CUDA events), None on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import timing
from . import cuda_build
from . import traverse_kernel as tk

LAUNCHES = tk.LAUNCHES
LAUNCHES.setdefault("mxuleaf", 0)
ROWS = 32  # the reference's rays: (32, 128) lanes, 4,096
NLEAF = 2000  # leaves per launch
NP8 = 8  # triangles per leaf
FORMS = ("scalar", "mxu", "mxu_1xtf32")  # the C entry's numbering
# elements per temporary of the plain versions (leaves are taken in chunks)
_CHUNK = 1 << 21


def make_inputs(seed: int = 0, rows: int = ROWS, nleaf: int = NLEAF, device="cpu") -> dict:
    """The script's rays and triangles (default_rng(seed): o, d, a, e1, e2
    in its order, :59-67) and its two tables (:71-87): o, d (rows * 128, 3)
    float32, lane r * 128 + c; prow (nleaf, 128) float32; coef (nleaf * 32,
    16) float32."""
    rs = np.random.default_rng(seed)
    o = rs.uniform(-1, 1, (rows, 128, 3)).astype(np.float32)
    d = rs.normal(size=(rows, 128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    m = nleaf * NP8
    a = rs.uniform(-1, 1, (m, 3)).astype(np.float32)
    e1 = rs.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    e2 = rs.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    prow = np.zeros((nleaf, 128), np.float32)
    prow[:, :NP8 * 9] = np.concatenate([a, e1, e2], -1).reshape(nleaf, NP8 * 9)
    n = np.cross(e1, e2)
    coef = np.zeros((m, 4, 16), np.float32)
    coef[:, 0, 3:6] = -n                       # det
    coef[:, 1, 0:3] = e2                       # u_num
    coef[:, 1, 3:6] = np.cross(a, e2)
    coef[:, 2, 0:3] = -e1                      # v_num
    coef[:, 2, 3:6] = np.cross(e1, a)
    coef[:, 3, 6:9] = n                        # t_num
    coef[:, 3, 9] = -np.sum(a * n, -1)
    arrays = {"o": o.reshape(-1, 3), "d": d.reshape(-1, 3), "prow": prow,
              "coef": coef.reshape(nleaf * 32, 16)}
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _check(form: str, table: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> int:
    """The number of leaves in table, after the form's shape checks."""
    if form not in FORMS:
        raise ValueError(f"unknown form {form!r}: one of {FORMS}")
    if o.dtype != torch.float32 or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (n, 3) float32")
    if o.shape[0] == 0 or o.shape[0] % 128:
        raise ValueError("the rays must be a positive multiple of 128")
    if table.dtype != torch.float32 or table.dim() != 2:
        raise ValueError("expected a float32 table")
    if form == "scalar":
        if table.shape[1] != 128:
            raise ValueError("expected leaf rows (nleaf, 128) float32")
        return table.shape[0]
    if table.shape[1] != 16 or table.shape[0] % 32:
        raise ValueError("expected coefficient rows (nleaf * 32, 16) float32")
    return table.shape[0] // 32


def _epilogue(det, u_n, v_n, t_n):
    """The script's epilogue (:158-164): t where the triangle is hit, else
    inf."""
    fdet = 1.0 / torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    u, v, t = fdet * u_n, fdet * v_n, fdet * t_n
    ok = (torch.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return torch.where(ok, t, torch.inf)


def scalar_reference(prow: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain version of scalar: Moller-Trumbore in the script's operation
    order (:103-133), a chunk of leaves' triangles against every ray at
    once -> (n,) float32. The least t does not depend on the order the
    triangles are taken in."""
    nleaf = _check("scalar", prow, o, d)
    f = prow[:, :NP8 * 9].reshape(nleaf * NP8, 9)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    t_best = torch.full((o.shape[0],), torch.inf, dtype=torch.float32, device=o.device)
    step = max(1, _CHUNK // o.shape[0])
    for p0 in range(0, f.shape[0], step):
        ax, ay, az, ux, uy, uz, vx, vy, vz = f[p0:p0 + step, :, None].unbind(1)
        hx = dy * vz - dz * vy
        hy = dz * vx - dx * vz
        hz = dx * vy - dy * vx
        aa = ux * hx + uy * hy + uz * hz
        fdet = 1.0 / torch.where(torch.abs(aa) < 1e-12, 1e-12, aa)
        sx, sy, sz = ox - ax, oy - ay, oz - az
        u = fdet * (sx * hx + sy * hy + sz * hz)
        qx = sy * uz - sz * uy
        qy = sz * ux - sx * uz
        qz = sx * uy - sy * ux
        v = fdet * (dx * qx + dy * qy + dz * qz)
        t = fdet * (vx * qx + vy * qy + vz * qz)
        ok = (torch.abs(aa) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
        t_best = torch.minimum(t_best, torch.where(ok, t, torch.inf).amin(0))
    return t_best


def features(o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The rays' features (16, n) float32 (:144-146): o x d, d, o, 1, 0 x 6."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    one = torch.ones_like(ox)
    return torch.stack([oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, dx, dy, dz,
                        ox, oy, oz, one] + [torch.zeros_like(ox)] * 6)


def mxu_reference(coef: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain version of mxu: the (32, 16) x (16, n) product per leaf in f32
    (torch.matmul, a chunk of leaves at once), then the script's epilogue
    -> (n,) float32. On a card the product must not run in TF32."""
    nleaf = _check("mxu", coef, o, d)
    if o.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the plain version computes in f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    feat = features(o, d)
    blocks = coef.reshape(nleaf, 32, 16)
    t_best = torch.full((o.shape[0],), torch.inf, dtype=torch.float32, device=o.device)
    step = max(1, _CHUNK // (32 * o.shape[0]))
    for l0 in range(0, nleaf, step):
        m = torch.matmul(blocks[l0:l0 + step], feat).reshape(-1, NP8, 4, o.shape[0])
        t = _epilogue(m[:, :, 0], m[:, :, 1], m[:, :, 2], m[:, :, 3])
        t_best = torch.minimum(t_best, t.reshape(-1, o.shape[0]).amin(0))
    return t_best


def tf32_split(x: torch.Tensor) -> tuple:
    """The kernel's split of f32 x into TF32 hi and lo (hi + lo = x to about
    f32's precision): hi = x rounded to a 10-bit significand, to nearest
    with ties away from zero (cvt.rna's rounding), lo = the same rounding
    of x - hi; both f32 with the 13 low bits clear."""
    def rna(v):
        return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(x)
    return hi, rna(x - hi)


def filter_pass(det, u_n, v_n, t_n, tgate):
    """The mxu kernel's divide-free filter (s4_pass, csrc/mxuleaf.cu), in the
    kernel's f32 operations: False only where _epilogue's test rejects the
    triangle at a least t of t_best, tgate = t_best * (1 + 2^-20) (the
    proof is beside s4_pass)."""
    a = det.abs()
    sg = det.view(torch.int32) & torch.iinfo(torch.int32).min

    def fold(x):
        return (x.contiguous().view(torch.int32) ^ sg).view(torch.float32)

    su, sv, st = fold(u_n), fold(v_n), fold(t_n)
    m = a * 2.0 ** -20
    tmin = torch.tensor(1e-4, dtype=torch.float32) * (1.0 - 2.0 ** -20)
    keep = (su >= -m) & (sv >= -m) & (su + sv <= a + m) & (st > a * tmin) & (st < a * tgate)
    return (a > 1e-12) & ((a > 2.0 ** 125) | keep)


def leaf_min_t(form: str, table: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """The least hit t per ray over every leaf of table -> (n,) float32
    (inf: no hit): for scalar, table is the leaf rows (nleaf, 128); for mxu
    and mxu_1xtf32 the coefficients (nleaf * 32, 16). The plain version on
    CPU tensors (mxu_reference for both mxu forms), kernel S4 on CUDA
    ones."""
    nleaf = _check(form, table, o, d)
    if o.device.type == "cpu":
        return scalar_reference(table, o, d) if form == "scalar" else mxu_reference(table, o, d)
    cuda_build.check_inputs(o, d, table)
    out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
    lib = cuda_build.load()
    split = None
    if form != "scalar":  # the coefficients split into TF32 hi and lo, sized by the kernel
        split = torch.empty(lib.s4_mxuleaf_scratch(nleaf), dtype=torch.float32, device=o.device)
    rc = lib.s4_mxuleaf(
        FORMS.index(form), table.data_ptr(), nleaf, o.data_ptr(), d.data_ptr(), out.data_ptr(),
        o.shape[0], None if split is None else split.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s4_mxuleaf launch failed: cudaError {rc}")
    LAUNCHES["mxuleaf"] += 1
    return out


def parity(r_s: np.ndarray, r_m: np.ndarray) -> dict:
    """The script's parity of two results (:219-227)."""
    fin = np.isfinite(r_s) & np.isfinite(r_m)
    agree = np.isclose(r_s[fin], r_m[fin], rtol=2e-4, atol=1e-5)
    return {"finite_frac": float(fin.mean()), "agree_frac": float(agree.mean()),
            "hitmask_match": float((np.isfinite(r_s) == np.isfinite(r_m)).mean()),
            "both_inf_frac": float((~np.isfinite(r_s) & ~np.isfinite(r_m)).mean())}


def main(argv=None) -> list:
    """The reference's main(): per form its time, ns per leaf and per
    triangle and lane, the checksum; then the parity of mxu (and of the
    1xTF32 A/B) against scalar; returns the rows."""
    ap = timing.entry_parser(__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="rows of 128 rays (32: the reference's; 8192: 1,048,576 rays)")
    ap.add_argument("--nleaf", type=int, default=NLEAF, help="leaves per launch")
    args = ap.parse_args(argv)
    dev = timing.device_of(args.device)
    rows = []

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    emit({"event": "device", "device": args.device, "card": timing.card(dev),
          "rays": args.rows * 128, "nleaf": args.nleaf})
    inp = make_inputs(0, args.rows, args.nleaf, dev)
    res = {}
    for form in FORMS:
        table = inp["prow" if form == "scalar" else "coef"]
        out = leaf_min_t(form, table, inp["o"], inp["d"])
        res[form] = out.cpu().numpy()
        dt = None
        if dev.type == "cuda":
            dt = timing.events_ms(lambda: leaf_min_t(form, table, inp["o"], inp["d"]),
                                  args.reps) * 1e-3
        rays = args.rows * 128
        emit({"variant": form, "sec": dt,
              "ns_per_leaf": None if dt is None else dt / args.nleaf * 1e9,
              "ns_per_prim_lane": None if dt is None else dt / (args.nleaf * NP8 * rays) * 1e12,
              "checksum": float(np.where(np.isfinite(res[form]), res[form], 0.0).sum())})
    emit({"check": "parity", **parity(res["scalar"], res["mxu"])})
    emit({"check": "parity_1xtf32", **parity(res["scalar"], res["mxu_1xtf32"])})
    return rows


if __name__ == "__main__":
    main()
