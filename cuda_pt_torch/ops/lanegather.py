"""Kernel S3: the per-lane gather micro-kernel (port of the TPU kernels of
scripts/exp_lanegather.py: the timed kernels of make(), pallas_call at :57,
and the check kernel kern_chk, :100).

Each element of x (R, 128) runs REPS iterations of its tag's body on its
accumulator (the tags and outputs of the reference):
  e0          acc * 1.000001 + 0.5, rounded once (a fused multiply-add:
              XLA contracts the reference's body so on the CPU, where the
              tests hold the port to it)
  g1 g4 g14   acc + row[(idx + i) % 128] for i < N: N gathers from a row
  w14 w112    where(idx == i, acc + 1, acc) for i < N: N selects
and ``gather`` (kern_chk) is row[idx], once; ``empty_launch`` launches an
empty kernel on the gather's grid, the launch floor of its time. The port
adds s1, s4 and s14:
the gN bodies with the row held in registers and read by warp shuffles,
bit-equal to gN. Timed with REPS iterations inside the kernel, a tag's
time over REPS is its cost per iteration; gN - e0 is what a gather costs,
wN - e0 a select.

On a CUDA tensor ``lanegather`` and ``gather`` launch the kernel
(csrc/lanegather.cu) or raise; on a CPU tensor they run the plain versions,
and only there. Each launch adds one to ``LAUNCHES["lanegather"]`` (the
package's one launch dict, ops/traverse_kernel.LAUNCHES).

    python -m cuda_pt_torch.ops.lanegather [--device cpu] [--rows 8192]

prints the reference's rows (gather_bit_exact, per_iter_ns per tag, the
per-gather summary) as JSON lines; the times are the card's (CUDA events),
None on the CPU.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..utils import timing
from . import cuda_build
from . import traverse_kernel as tk

LAUNCHES = tk.LAUNCHES
LAUNCHES.setdefault("lanegather", 0)
ROWS = 64  # the reference's (64, 128) tile: 8,192 lanes
REPS = 512  # iterations inside the kernel
ROW = 128
# tag -> (kind of the C entry, operations per iteration): 0 e0, 1 gN, 2 wN,
# 3 sN (shuffle form of gN)
TAGS = {"e0": (0, 0), "g1": (1, 1), "g4": (1, 4), "g14": (1, 14), "w14": (2, 14),
        "w112": (2, 112), "s1": (3, 1), "s4": (3, 4), "s14": (3, 14)}
_CHECK = 4
_EMPTY = 5


def make_inputs(seed: int = 0, rows: int = ROWS, device="cpu"):
    """x (rows, 128) f32, row (1, 128) f32, idx (rows, 128) int32, drawn as
    the reference draws them (default_rng(seed): normal, normal, integers
    in [0, 128), in that order)."""
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(rows, ROW)).astype(np.float32)
    row = rs.normal(size=(1, ROW)).astype(np.float32)
    idx = rs.integers(0, ROW, size=(rows, ROW)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (x, row, idx))


def _check(x, row: torch.Tensor, idx: torch.Tensor):
    if row.dtype != torch.float32 or tuple(row.shape) != (1, ROW):
        raise ValueError("expected row (1, 128) float32")
    if idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != ROW:
        raise ValueError("expected idx (R, 128) int32")
    if x is not None and (x.dtype != torch.float32 or x.shape != idx.shape):
        raise ValueError("expected x (R, 128) float32, the shape of idx")


def _body(tag: str):
    if tag not in TAGS:
        raise ValueError(f"unknown tag {tag!r}: one of {sorted(TAGS)}")
    kind, n = TAGS[tag]
    if kind == 0:
        # the f32 product is exact in f64, so the f64 sum rounds once before
        # the f32 cast: fmaf's result unless the f64 rounding lands on an f32
        # tie, which needs 28 equal bits below the f32 mantissa
        c = float(np.float32(1.000001))
        return lambda acc, row, idx: (acc.double() * c + 0.5).float()

    if kind == 2:
        def body(acc, row, idx):
            for i in range(n):
                acc = torch.where(idx == i, acc + 1.0, acc)
            return acc
        return body

    def body(acc, row, idx):  # gN and its shuffle form sN
        rb = row.expand(idx.shape[0], ROW)
        for i in range(n):
            acc = acc + torch.take_along_dim(rb, ((idx + i) % ROW).long(), dim=1)
        return acc
    return body


def lanegather_reference(tag: str, x: torch.Tensor, row: torch.Tensor, idx: torch.Tensor,
                         reps: int = REPS) -> torch.Tensor:
    """Plain version: reps iterations of the tag's body on every element at
    once, in the kernel's operation order -> (R, 128) float32."""
    _check(x, row, idx)
    body = _body(tag)
    acc = x
    for _ in range(reps):
        acc = body(acc, row, idx)
    return acc


def gather_reference(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the check form: row[idx] -> (R, 128) float32."""
    _check(None, row, idx)
    return torch.take_along_dim(row.expand(idx.shape[0], ROW), idx.long(), dim=1)


def _launch(kind: int, n_ops: int, x, row, idx, reps: int) -> torch.Tensor:
    cuda_build.check_inputs(*[t for t in (idx, x, row) if t is not None])
    if idx.data_ptr() % 16:
        raise ValueError("idx must be 16-byte aligned: the gather reads it as int4")
    out = torch.empty(idx.shape, dtype=torch.float32, device=idx.device)
    rc = cuda_build.load().s3_lanegather(
        kind, n_ops, None if x is None else x.data_ptr(), row.data_ptr(), idx.data_ptr(),
        out.data_ptr(), idx.numel(), int(reps),
        torch.cuda.current_stream(idx.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s3_lanegather launch failed: cudaError {rc}")
    LAUNCHES["lanegather"] += 1
    return out


def lanegather(tag: str, x: torch.Tensor, row: torch.Tensor, idx: torch.Tensor,
               reps: int = REPS) -> torch.Tensor:
    """reps iterations of the tag's body on x (R, 128) -> (R, 128) float32:
    the plain version on CPU tensors, kernel S3 on CUDA ones."""
    if idx.device.type == "cpu":
        return lanegather_reference(tag, x, row, idx, reps)
    _check(x, row, idx)
    _body(tag)  # raises on an unknown tag
    return _launch(*TAGS[tag], x, row, idx, reps)


def gather(row: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """row[idx] for idx (R, 128) in [0, 128): the plain version on CPU
    tensors, kernel S3's check form on CUDA ones."""
    if idx.device.type == "cpu":
        return gather_reference(row, idx)
    _check(None, row, idx)
    return _launch(_CHECK, 0, None, row, idx, 0)


def empty_launch(row: torch.Tensor, idx: torch.Tensor) -> None:
    """Launch an empty kernel on the grid the check gather takes for idx
    (CUDA tensors only): the launch floor beside the gather's time."""
    _check(None, row, idx)
    _launch(_EMPTY, 0, None, row, idx, 0)


def main(argv=None) -> list:
    """The reference's main(): the gather check against NumPy, each tag's
    time per iteration and the per-gather summary, as JSON lines; returns
    the rows."""
    ap = timing.entry_parser(__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=ROWS,
                    help="rows of 128 lanes (64: the reference's tile; 8192: 1,048,576 lanes)")
    ap.add_argument("--iters", type=int, default=REPS, help="iterations inside the kernel")
    args = ap.parse_args(argv)
    dev = timing.device_of(args.device)
    rows = []

    def emit(r):
        rows.append(r)
        print(json.dumps(r), flush=True)

    emit({"event": "device", "device": args.device, "card": timing.card(dev),
          "rows": args.rows, "lanes": args.rows * ROW, "reps": args.iters})
    x, row, idx = make_inputs(0, args.rows, dev)
    got = gather(row, idx).cpu().numpy()
    want = np.take_along_axis(np.broadcast_to(row.cpu().numpy(), idx.shape),
                              idx.cpu().numpy(), axis=1)
    emit({"check": "gather_bit_exact", "ok": bool(np.array_equal(got, want))})
    results = {}
    for tag in TAGS:
        out = lanegather(tag, x, row, idx, args.iters)
        per = None
        if dev.type == "cuda":
            ms = timing.events_ms(lambda: lanegather(tag, x, row, idx, args.iters), args.reps)
            per = ms * 1e6 / args.iters
            results[tag] = per
        emit({"tag": tag, "per_iter_ns": per,
              "checksum": float(np.abs(out.cpu().numpy()).sum())})
    if results:
        emit({"summary": "per-gather ns",
              "g1_minus_e0": results["g1"] - results["e0"],
              "g14_minus_e0_per": (results["g14"] - results["e0"]) / 14,
              "s14_minus_e0_per": (results["s14"] - results["e0"]) / 14,
              "w112_minus_e0_per": (results["w112"] - results["e0"]) / 112})
    return rows


if __name__ == "__main__":
    main()
