"""The comparison that decides a run's ``correct``.

After the window has closed, a sample of pixels drawn from the seed is
taken from the images that the window's first calls returned (the film's
running mean after each call), and the plain reference
(reference/plain_render.py) works the same pixels out again from the
configuration and the seed. Two numbers are compared, each with the
limit the cell's file under limits/ gives:

- tables_off: tables of the program's compiled scene (per-prim geometry,
  emitter pick) that differ bit for bit from the reference's own, once
  the reference has put its prims in the program's order (the one thing
  it takes from the program); limit 0;
- pixels_off_pct: the share, in percent, of the sampled (pixel, call)
  values whose colour differs from the reference's by more than
  RTOL x |reference| + ATOL in a channel, or is not finite.

mean_gap_pct, the gap between the sums of the sampled values in percent
of the reference's, is printed beside them and not compared: one path
that diverges onto a bright light moves it by more than the control
does in the media scene (PERF.md).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from .reference import plain_render

RTOL = 1e-3
ATOL = 1e-4
NAMES = ("tables_off", "pixels_off_pct")


def sample_pixels(seed: int, n_pixels: int, count: int) -> np.ndarray:
    """count distinct pixel ids drawn from the seed, sorted."""
    rng = np.random.default_rng(int(seed))
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def compare(prog: list, ref: list) -> dict:
    """pixels_off_pct and mean_gap_pct of the program's sampled values
    (one (P, 3) array per compared call) against the reference's."""
    p = torch.cat([torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in prog])
    r = torch.cat([torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in ref])
    close = torch.isfinite(p).all(-1) & ((p - r).abs() <= RTOL * r.abs() + ATOL).all(-1)
    off = 100.0 * float((~close).sum()) / close.shape[0]
    sp, sr = float(p.double().sum()), float(r.double().sum())
    gap = 100.0 * abs(sp - sr) / max(abs(sr), 1e-30) if math.isfinite(sp) else math.inf
    return {"pixels_off_pct": off, "mean_gap_pct": gap}


def reference_means(rs, traffic: dict, seed: int, pixels: np.ndarray, device,
                    precision: str = "f32") -> list:
    """The reference's running means (P, 3) at the sampled pixels after
    each compared call of the mix, on its scene rs (plain_render.make_scene)."""
    spp, calls = traffic["spp_per_call"], traffic["check_calls"]
    paths = plain_render.pixel_paths(rs, seed, torch.as_tensor(pixels, device=device),
                                     spp * calls, precision)
    means = plain_render.film_means(paths, [spp * (k + 1) for k in range(calls)])
    return [m.cpu().numpy() for m in means]


def load_limits(root: str, workload: str) -> dict:
    with open(os.path.join(root, "benchmark", "limits", f"{workload}.json")) as f:
        return json.load(f)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit; a number that is
    not finite fails."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NAMES}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
