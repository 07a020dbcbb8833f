"""Measured per-scene traversal-backend selection (port of
cuda_pt_tpu/accel/autotune.py): Renderer(traversal="auto").

Which walk is fastest depends on the scene and on the device, so each
eligible backend is timed on a representative ray mix and the winner is
kept: "xla" (the skip walk) and "wide" / "wide_bf16" (the 8-wide walk over
f32 or outward-rounded bf16 boxes) always; "pallas" (kernel K1) where the
scene ships a forest, on a card (K1 reads its rows from global memory,
models/path_tracer.pallas_forest), and on the CPU where the scene fits
the reference's VMEM rule; "mxu" (the matmul brute force,
ops/intersect_mxu.py) at 8,192 prims or fewer. Times come
from CUDA events (utils/timing.events_ms) on a card, from perf_counter
around a call on the CPU. The result is cached per scene key, as in the
reference, with the device type in place of its backend name.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from ..core import camera as cam_mod
from ..core import rng as prng
from ..scene import types as T

_CACHE: dict[tuple, dict] = {}


def _probe_rays(scene: T.Scene, cam=None, n_rays: int = 4096):
    """Representative mix: camera primaries when a camera is given, plus a
    shuffled copy (stands in for post-bounce incoherence). Without a camera,
    deterministic inward rays from a sphere around the scene AABB. On the
    scene's device."""
    n_rays = max(256, n_rays)
    dev = scene.device
    if cam is not None:
        B = int(cam.width) * int(cam.height)
        lane = torch.arange(n_rays, device=dev) % B
        state = prng.seed(123, lane)
        o, d, _ = cam_mod.generate_rays(cam, lane, state)
    else:
        lo = scene.bvh.node_min[0].cpu().numpy()
        hi = scene.bvh.node_max[0].cpu().numpy()
        c, r = (lo + hi) / 2, float(np.linalg.norm(hi - lo)) * 0.75 + 1e-3
        rng = np.random.default_rng(123)
        u = rng.normal(size=(n_rays, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
        tgt = rng.uniform(lo, hi, size=(n_rays, 3))
        o_np = (c + r * u).astype(np.float32)
        dn = tgt - o_np
        d_np = (dn / (np.linalg.norm(dn, axis=1, keepdims=True) + 1e-12)).astype(np.float32)
        o, d = torch.as_tensor(o_np, device=dev), torch.as_tensor(d_np, device=dev)
    perm = torch.as_tensor(np.random.default_rng(7).permutation(n_rays), device=dev)
    return torch.cat([o, o[perm]]), torch.cat([d, d[perm]])


def _scene_key(scene: T.Scene) -> tuple:
    return (
        scene.device.type,
        int(scene.geom.num_prims),
        int(scene.bvh.num_nodes),
        None if scene.forest is None else tuple(scene.forest.nodes.shape),
        None if scene.forest is None else scene.forest.node_fmt,
    )


def candidates(scene: T.Scene) -> list:
    """The eligible backends, in the reference's order."""
    from ..ops import traverse_kernel as tk

    out = ["xla", "wide", "wide_bf16"]
    if (scene.forest is not None or scene.device.type == "cuda"
            or tk.scene_fits_vmem(scene.geom, scene.bvh)):
        out.append("pallas")
    # the matmul brute force: eligible while the per-bounce contraction stays cheap
    if int(scene.geom.num_prims) <= 8192:
        out.append("mxu")
    return out


def _timed_ms(fn, device: torch.device, reps: int) -> float:
    """Median ms of fn() over reps calls after a warm-up: CUDA events on a
    card, perf_counter around a synchronized call on the CPU."""
    if device.type == "cuda":
        from ..utils import timing

        return timing.events_ms(fn, reps)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def autotune_traversal(scene: T.Scene, cam=None, n_rays: int = 4096, reps: int = 3,
                       verbose: bool = False) -> dict:
    """Time each eligible traversal backend on this scene; return
    {"impl": best, "timings_ms": {impl: median ms}, "cached": bool}. A
    candidate that fails raises (the reference disqualifies it: every
    candidate of the port runs)."""
    from ..models import path_tracer as pt
    from . import wide_build

    key = _scene_key(scene)
    if key in _CACHE:
        return dict(_CACHE[key], cached=True)

    o, d = _probe_rays(scene, cam, n_rays)
    live = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    timings: dict[str, float] = {}
    for impl in candidates(scene):
        sc = dataclasses.replace(scene, traversal="wide" if impl.startswith("wide") else impl)
        if impl.startswith("wide"):
            sc.wide = wide_build.from_bvharrays(scene.bvh, box_dtype=impl[5:] or "f32")
        elif impl == "pallas":
            sc.forest = pt.pallas_forest(scene)  # packed once, as the Renderer does

        def hot(sc=sc):
            res = pt.closest_hit(sc, o, d, live, use_bvh=True)
            # the any-hit walk too: NEE shadow rays are about half the load
            return res["t"], pt.occluded(sc, o, d, res["t"], live, use_bvh=True)

        timings[impl] = _timed_ms(hot, o.device, reps)

    best = min(timings, key=timings.get)
    out = {"impl": best, "timings_ms": timings}
    _CACHE[key] = out
    if verbose:
        print(f"[autotune] {key[0]}: {timings} -> {best}")
    return dict(out, cached=False)


def with_tuned_traversal(scene: T.Scene, cam=None, **kw) -> T.Scene:
    """A copy of scene with ``traversal`` pinned to the measured winner (and
    the wide BVH, f32 or bf16, of this scene attached when an 8-wide
    backend wins)."""
    from . import wide_build

    impl = autotune_traversal(scene, cam, **kw)["impl"]
    if impl.startswith("wide"):
        return wide_build.with_wide(scene, box_dtype=impl[5:] or "f32")
    return dataclasses.replace(scene, traversal=impl)
