"""GPU smoke test of the PyTorch + CUDA port (cuda_pt_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from cuda_pt_torch/csrc (one nvcc, sm_90a) and
     print the seconds;
  2. print the card's name and power limit (nvidia-smi);
  3. closest_hit_w8 against closest_hit_brute on 65536 random rays in the
     cornell box: prim ids equal except on exact ties;
  4. the megakernel against its plain PyTorch version on cornell_box, its
     mirror / glass variants and cornell_box_lights (three emitters), 256x256,
     4 spp, default depth caps: per-lane allclose(rtol=1e-4, atol=1e-5) on
     >= 98% of lanes, and the image means within 5e-3;
  5. the main path: api.Renderer on cornell_box at 1024x1024, 64 spp,
     default depth caps, pcg, nee_candidates=1; the kernel's launch count
     must rise and the image must be finite; then one spp of the main
     path's rays through the kernel and its plain version, held to the
     phase-4 contract; prints the kernel time per spp (CUDA events),
     paths/s, the plain version's time on the same rays and the bound.
The last two lines are a JSON object of kernel numbers and
{"ok": true, "device": {...}}. ``--size`` and ``--spp`` shrink phase 5
for quick checks; ``--profile`` adds a torch.profiler breakdown of a few
main-path passes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_S = 67e12  # H100 SXM f32 outside the tensor cores
# f32 operations per test, counted from csrc/walk.cuh: a child slab test is
# 6 sub + 6 mul + 6 min/max + 4 min/max; a triangle test is 2 cross (9
# each) + 4 dot (5 each) + 3 sub + 1 reciprocal + 3 mul.
OPS_SLAB = 22
OPS_TRI = 45
RTOL, ATOL, MAX_LANE_FRAC = 1e-4, 1e-5, 0.02
MEAN_TOL = 5e-3


def log(msg):
    print(msg, flush=True)


def events_ms(fn, reps: int) -> float:
    """Mean device ms of fn() over reps launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def lane_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    close = torch.isclose(a, b, rtol=RTOL, atol=ATOL).all(dim=-1)
    return float((~close).float().mean())


def check_contract(name: str, L_k: torch.Tensor, L_p: torch.Tensor) -> tuple:
    """Hold kernel output to the plain version's: finite, at most
    MAX_LANE_FRAC of lanes outside allclose, means within MEAN_TOL.
    Returns (lane fraction differing, |mean difference|)."""
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{name}: non-finite kernel output")
    frac = lane_mismatch(L_k, L_p)
    dmean = abs(float(L_k.mean()) - float(L_p.mean()))
    if frac > MAX_LANE_FRAC or dmean > MEAN_TOL:
        raise SystemExit(f"{name}: kernel breaks the per-lane contract "
                         f"({frac} of lanes differ, means differ by {dmean})")
    return frac, dmean


def phase_build(cb):
    secs = cb.build()
    log(f"[1] built megakernel in {secs:.1f} s")
    for line in cb.build_log().splitlines():
        if "registers" in line or "spill" in line:
            log(f"    {line.strip()}")


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(out)
    return out


def phase_walk(mk, tts, dev):
    scene, _, _ = tts.cornell_box(device=dev)
    pack = mk.make_pack(scene)
    rs = np.random.default_rng(7)
    B = 65536
    o = rs.uniform(0.05, 0.95, (B, 3)).astype(np.float32)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t = torch.as_tensor(o, device=dev)
    d_t = torch.as_tensor(d, device=dev)
    t_k, prim_k, _, _ = mk.closest_hit_w8(pack, o_t, d_t)
    from cuda_pt_torch.ops import intersect as isect

    t_all, _, _, _ = isect.intersect_gather(scene.geom, o_t, d_t,
                                            *isect.all_prims(scene.geom, B))
    prim_b = isect.closest_hit_brute(scene.geom, o_t, d_t)["prim"]
    differ = prim_k != prim_b
    t_min = t_all.min(dim=1).values
    t_of_k = torch.gather(t_all, 1, prim_k.clamp(min=0)[:, None])[:, 0]
    ties = differ & (prim_k >= 0) & (t_of_k == t_min)
    bad = int((differ & ~ties).sum())
    log(f"[3] closest_hit_w8 vs closest_hit_brute, {B} rays: {int(differ.sum())} prim ids differ, "
        f"{int(ties.sum())} on exact ties, {bad} otherwise; hits {int((prim_k >= 0).sum())}")
    if bad:
        raise SystemExit(f"walk check failed: {bad} prim ids differ off exact ties")
    return {"rays": B, "differ": int(differ.sum()), "exact_ties": int(ties.sum())}


def phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T):
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    md = MaxDepthParams()
    variants = {
        "cornell": lambda: tts.cornell_box(256, 256, device=dev),
        "mirror": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_SPECULAR, k_d=(0.95, 0.95, 0.95))),
        "glass": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)),
        "lights": lambda: tts.cornell_box_lights(256, 256, device=dev),
    }
    res = {}
    for name, make in variants.items():
        scene, cam, _ = make()
        pack = mk.make_pack(scene)
        perm, _ = mk.tile_swizzle(cam.width, cam.height, dev)
        worst, means_k, means_p = 0.0, [], []
        for i in range(4):
            rng = qmc.make_state("pcg", 0, perm, i)
            o, d, rng = cam_mod.generate_rays(cam, perm, rng)
            L_p = mk.trace_megakernel_reference(scene, md, o, d, rng)
            L_k = mk.trace_megakernel(pack, md, o, d, rng)
            frac, _ = check_contract(f"{name} pass {i}", L_k, L_p)
            worst = max(worst, frac)
            means_k.append(float(L_k.mean()))
            means_p.append(float(L_p.mean()))
        row = {"lanes_differ": worst, "mean_plain": float(np.mean(means_p)),
               "mean_kernel": float(np.mean(means_k))}
        res[name] = row
        log(f"[4] {name} 256x256x4spp: lanes differing (worst pass) {worst:.5f}; means plain "
            f"{row['mean_plain']:.6f} kernel {row['mean_kernel']:.6f}")
        if abs(row["mean_kernel"] - row["mean_plain"]) > MEAN_TOL:
            raise SystemExit(f"{name}: 4-spp image means differ by more than {MEAN_TOL}")
    return res


def phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene, Renderer,
               ref_mean):
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    size, spp = args.size, args.spp
    md = MaxDepthParams()
    scene, cam, _ = tts.cornell_box(size, size)
    parsed = ParsedScene(scene, cam, RenderingConfig(width=size, height=size, md=md, seed=0))
    r = Renderer(parsed, nee_candidates=1)  # device=None -> cuda
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    if launches["trace_megakernel"] <= 0:
        raise SystemExit("main path did not launch the megakernel")
    if img.shape != (size, size, 3) or not np.isfinite(img).all():
        raise SystemExit("main path image is not finite / has the wrong shape")
    mean = float(img.mean())
    log(f"[5] Renderer {size}x{size}x{spp}spp: {wall:.2f} s wall, launches {launches}, "
        f"image mean {mean:.6f} (256x256 plain mean {ref_mean:.6f})")
    if abs(mean - ref_mean) > 0.02 * ref_mean:
        raise SystemExit("main path image mean disagrees with the plain version's")

    # one spp of the main path's rays, timed alone
    pack = r._pack
    perm, _ = mk.tile_swizzle(size, size, r.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(r.camera, perm, rng)
    B = o.shape[0]
    rng_bits = mk.rng_bits(rng)  # the kernel's own input format: time the launch alone
    k_ms = events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 10)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(r.scene, md, o, d, rng)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    frac, dmean = check_contract(f"main path {size}x{size} rays", L_k, L_p)
    nodes = int(stats[:, 0].sum(dtype=torch.int64))
    prims = int(stats[:, 1].sum(dtype=torch.int64))
    ops = nodes * 8 * OPS_SLAB + prims * OPS_TRI
    pack_bytes = sum(t.numel() * t.element_size() for t in pack.arrays.values())
    nbytes = B * (6 * 4 + 2 * 4 + 3 * 4) + pack_bytes
    bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_F32_S else "operations"
    log(f"[5] kernel {k_ms:.3f} ms/spp, {B / (k_ms * 1e-3):.4g} paths/s; plain version "
        f"{plain_ms:.1f} ms on the same rays ({frac:.7f} lanes differ, means differ by "
        f"{dmean:.3g}); bound {bound_ms:.4f} ms ({bound_by}: {nodes} wide nodes, "
        f"{prims} prim tests, {nbytes} bytes); {bound_ms / k_ms:.4f} of bound")
    return {
        "name": "trace_megakernel", "route": "cuda", "source": "cuda_pt_torch/csrc/megakernel.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:500",
        "launches": launches["trace_megakernel"], "max_abs_err": float((L_k - L_p).abs().max()),
        "ms": k_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "paths_per_s": B / (k_ms * 1e-3), "lanes_differ": frac,
        "mean_differ": dmean,
        "wide_nodes": nodes, "prim_tests": prims, "wall_ms_per_spp": wall * 1e3 / spp,
    }, r


def phase_profile(r, passes: int = 4) -> dict:
    """Device time by kernel over a few Renderer passes (torch.profiler,
    CUPTI), after one warm-up profile; the device busy share is the summed
    kernel time over the wall of the same passes run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        r.render_raw()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / passes
    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                r.render_raw()
            torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  reverse=True)
    dev_ms = sum(us for us, _, _ in rows) / 1e3 / passes
    top = [{"name": k[:70], "ms_per_pass": us / 1e3 / passes, "calls_per_pass": n / passes}
           for us, k, n in rows[:8]]
    log(f"[profile] {passes} passes: wall {wall_ms:.3f} ms/pass (unprofiled), kernels "
        f"{dev_ms:.3f} ms/pass, device busy share {dev_ms / wall_ms:.3f}, "
        f"{sum(n for _, _, n in rows) / passes:.0f} kernel launches/pass")
    for t in top:
        log(f"    {t['ms_per_pass']:.4f} ms/pass  x{t['calls_per_pass']:g}  {t['name']}")
    return {"wall_ms_per_pass": wall_ms, "device_ms_per_pass": dev_ms,
            "busy_share": dev_ms / wall_ms, "top": top}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", type=int, default=1024, help="phase-5 image side")
    ap.add_argument("--spp", type=int, default=64, help="phase-5 samples per pixel")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path passes (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig
    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.ops import megakernel as mk
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scene import types as T
    from cuda_pt_torch.scene.builder import BSDFSpec
    from cuda_pt_torch.scene.xml_parser import ParsedScene

    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build(cb)
    card = phase_card()
    walk = phase_walk(mk, tts, dev)
    res4 = phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T)
    k2, r = phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene, Renderer,
                       res4["cornell"]["mean_plain"])
    extra = {"profile": phase_profile(r)} if args.profile else {}
    log(json.dumps({"kernels": [k2], "card": card, "walk_check": walk, "kernel_check": res4,
                    **extra}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
