"""GPU smoke test of the PyTorch + CUDA port (cuda_pt_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from cuda_pt_torch/csrc (one nvcc, sm_90a) and
     print the seconds and ptxas' register counts;
  2. print the card's name and power limit (nvidia-smi);
  3. closest_hit_w8 against closest_hit_brute on 65536 random rays in the
     cornell box, and against the skip walk (accel/traverse.py) on 16384
     random rays in full-size kitchen_stress (98,790 triangles): prim ids
     equal except on exact ties;
  4. the megakernel against its plain PyTorch version (the fused kernel's
     estimator), 256x256, 4 spp, default depth caps, per-lane
     allclose(rtol=1e-4, atol=1e-5) on >= 98% of lanes and the image means
     within 5e-3, on cornell_box and its mirror / glass / GGX conductor /
     plastic / rough-dielectric tall boxes, cornell_box_lights (three
     emitters), the Oren-Nayar + Forward scene, the area-spot scene, the
     envmap furnace (its mean also within 0.05 of 1.0), the textured floor
     and kitchen_stress(grid=2, ns=6, nt=4) with all three K3 flags;
  5. the main path on cornell_box: api.Renderer at 1024x1024, 64 spp,
     default depth caps, pcg, nee_candidates=1; the kernel's launch count
     must rise and the image must be finite; then one spp of the main
     path's rays through the kernel and its plain version, held to the
     phase-4 contract; prints the kernel time per spp (CUDA events),
     paths/s, the plain version's time on the same rays and the bound;
  6. the main path on full-size kitchen_stress (envmap, textures,
     dispersion): api.Renderer at 1024x1024, 16 spp, the same settings;
     launch count and finite image as in phase 5; one spp of its rays
     through the kernel at the full grid, one 65,536-lane Z-order block of
     that output held to the phase-4 contract against the plain version
     (skip walk) on the same lanes; prints the BVH build seconds,
     wall and kernel ms per spp, paths/s, the bound (count_stats, with the
     texel and uv bytes) and the kernel's share of it;
  4 (media). kernel K4, the volume path tracer's MED instantiations,
     against its plain version (the fused volume path tracer) under the
     phase-4 contract, 256x256, 4 spp: medium_box (HG), cornell_vpt (the
     camera in a medium), nested_media (media nested two deep), medium_box
     with a dual-HG and with a Rayleigh phase, and medium_box with an
     envmap (the K3 x MED instantiation);
  7. the main path of the volume path tracer on full-size medium_cbox
     (36,888 triangles, media nested two deep): prints the BVH build
     seconds; api.Renderer(renderer=VOLUME_PT) at 1024x1024, 16 spp,
     default depth caps; the launch count (all of the MED instantiation)
     and a finite image; one spp of its rays through the kernel at the full
     grid, a 65,536-lane Z-order block of that output held to the phase-4
     contract against the plain version on the same lanes; prints kernel
     and wall ms per spp, paths/s, launches per frame, the walk work
     (count_stats, with the transmittance walks) and the share of the bound.
The last two lines are a JSON object of kernel numbers and
{"ok": true, "device": {...}}. ``--size`` and ``--spp`` shrink phase 5
for quick checks and ``--kitchen-spp`` phase 6; phase 7 always runs at
VPT_SPP samples per pixel and holds VPT_BLOCK lanes. ``--profile`` adds a
torch.profiler breakdown of a few main-path passes of each scene.
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
# lanes of the surface main path (phase 6) held to the plain version
KITCHEN_BLOCK = 65536
# the volume main path (phase 7): samples per pixel, and the lanes held to
# the plain version (its run on this block stays under 30 s on an H100)
VPT_SPP = 16
VPT_BLOCK = 65536


T0 = time.perf_counter()


def log(msg):
    """Print msg after the seconds since the script started."""
    print(f"{time.perf_counter() - T0:7.1f}s {msg}", flush=True)


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
    print(out, flush=True)  # as nvidia-smi gives it, on a line of its own
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


def phase_walk_kitchen(mk, tts, dev):
    """The w8 walk against the skip walk on full-size kitchen_stress; returns
    (the result row, the scene, its camera, the build seconds)."""
    from cuda_pt_torch.accel import traverse
    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.ops import intersect as isect

    t0 = time.perf_counter()
    scene, cam, _ = tts.kitchen_stress(1024, 1024, device=dev)
    build_s = time.perf_counter() - t0
    pack = mk.make_pack(scene)
    rs = np.random.default_rng(11)
    B = 16384
    lo = scene.bvh.node_min[0].cpu().numpy()
    hi = scene.bvh.node_max[0].cpu().numpy()
    o_t = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32), device=dev)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d_t = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=dev)
    _, prim_k, _, _ = mk.closest_hit_w8(pack, o_t, d_t)
    h = traverse.closest_hit_bvh(scene.geom, scene.bvh, o_t, d_t)
    differ = prim_k != h["prim"]
    # an exact tie: the walk's own prim is hit at the plain walk's t
    idx = torch.nonzero(differ & (prim_k >= 0))[:, 0]
    t_of_k, hit_k, _, _ = isect.intersect_gather(
        scene.geom, o_t[idx], d_t[idx], prim_k[idx][:, None],
        torch.ones((idx.numel(), 1), dtype=torch.bool, device=dev))
    ties = int((hit_k[:, 0] & (t_of_k[:, 0] == h["t"][idx])).sum())
    bad = int(differ.sum()) - ties
    log(f"[3] kitchen_stress ({scene.geom.num_prims} triangles, BVH built in {build_s:.1f} s; "
        f"{pack['nodes'].shape[0]} wide nodes, walk stack {pack.max_stack} of "
        f"{cb.MK_MAX_STACK}, max leaf {pack.max_leaf}): "
        f"closest_hit_w8 vs closest_hit_bvh, {B} rays: {int(differ.sum())} prim ids differ, "
        f"{ties} on exact ties, {bad} otherwise; hits {int((prim_k >= 0).sum())}")
    if bad:
        raise SystemExit(f"kitchen walk check failed: {bad} prim ids differ off exact ties")
    return {"rays": B, "differ": int(differ.sum()), "exact_ties": ties}, scene, cam, build_s


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
        "ggx_conductor": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444), k=(3.983, 2.386, 1.603),
            roughness_x=0.2, roughness_y=0.2)),
        "plastic": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_PLASTIC, k_d=(0.1, 0.3, 0.65), k_s=(1.0, 1.0, 1.0), ior=1.5,
            thickness=0.2)),
        "rough_dielectric": lambda: tts.cornell_box(256, 256, device=dev, tall_box_bsdf=BSDFSpec(
            btype=T.BSDF_GGX_DIELECTRIC, k_s=(0.95, 0.95, 0.95), ior=1.5, roughness_x=0.25,
            roughness_y=0.25)),
        "oren_nayar_forward": lambda: tts.oren_nayar_forward(256, 256, device=dev),
        "area_spot": lambda: tts.spot_light(256, 256, device=dev),
        "furnace": lambda: tts.furnace(256, 256, device=dev),
        "textured_floor": lambda: tts.textured_floor(256, 256, device=dev),
        "kitchen_small": lambda: tts.kitchen_stress(256, 256, grid=2, ns=6, nt=4, device=dev),
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
            L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
            L_k = mk.trace_megakernel(pack, md, o, d, rng)
            frac, _ = check_contract(f"{name} pass {i}", L_k, L_p)
            worst = max(worst, frac)
            means_k.append(float(L_k.mean()))
            means_p.append(float(L_p.mean()))
        row = {"lanes_differ": worst, "mean_plain": float(np.mean(means_p)),
               "mean_kernel": float(np.mean(means_k))}
        row.update(pack.flags)
        res[name] = row
        log(f"[4] {name} 256x256x4spp: lanes differing (worst pass) {worst:.5f}; means plain "
            f"{row['mean_plain']:.6f} kernel {row['mean_kernel']:.6f}; {pack.flags}")
        if abs(row["mean_kernel"] - row["mean_plain"]) > MEAN_TOL:
            raise SystemExit(f"{name}: 4-spp image means differ by more than {MEAN_TOL}")
    if abs(res["furnace"]["mean_kernel"] - 1.0) > 0.05:
        raise SystemExit("furnace: the kernel's mean is not within 0.05 of 1.0")
    k = res["kitchen_small"]
    if not (k["has_env"] and k["textured"] and k["has_disp"]):
        raise SystemExit("kitchen_small did not set all three K3 flags")
    return res


def phase_kernel_media(mk, tts, dev, MaxDepthParams, T):
    """Phase 4 for kernel K4: vpt packs of the media scenes, every launch of
    the MED instantiation the scene needs."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    md = MaxDepthParams()
    variants = {
        "medium_box": lambda: tts.medium_box(256, 256, device=dev),
        "cornell_vpt": lambda: tts.cornell_vpt(256, 256, device=dev),
        "nested_media": lambda: tts.nested_media(256, 256, device=dev),
        "medium_box_dual_hg": lambda: tts.medium_box(256, 256, phase_type=T.PHASE_DUAL_HG,
                                                     phase_g=(0.7, -0.4), phase_w=0.6,
                                                     device=dev),
        "medium_box_rayleigh": lambda: tts.medium_box(256, 256, phase_type=T.PHASE_RAYLEIGH,
                                                      device=dev),
        "medium_box_env": lambda: tts.medium_box(256, 256, env_scale=0.5, device=dev),
    }
    res = {}
    for name, make in variants.items():
        scene, cam, _ = make()
        pack = mk.make_pack(scene, vpt=True)
        want = "K3+ALL+MED" if pack.has_env else "ALL+MED"
        perm, _ = mk.tile_swizzle(cam.width, cam.height, dev)
        worst, means_k, means_p = 0.0, [], []
        for i in range(4):
            rng = qmc.make_state("pcg", 0, perm, i)
            o, d, rng = cam_mod.generate_rays(cam, perm, rng)
            L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
            mk.reset_launches()
            L_k = mk.trace_megakernel(pack, md, o, d, rng)
            if mk.INSTANTIATION_LAUNCHES != {want: 1}:
                raise SystemExit(f"{name}: launched {mk.INSTANTIATION_LAUNCHES}, not {want}")
            frac, _ = check_contract(f"{name} pass {i}", L_k, L_p)
            worst = max(worst, frac)
            means_k.append(float(L_k.mean()))
            means_p.append(float(L_p.mean()))
        row = {"lanes_differ": worst, "mean_plain": float(np.mean(means_p)),
               "mean_kernel": float(np.mean(means_k)), "instantiation": want}
        res[name] = row
        log(f"[4] {name} 256x256x4spp ({want}): lanes differing (worst pass) {worst:.5f}; means "
            f"plain {row['mean_plain']:.6f} kernel {row['mean_kernel']:.6f}")
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
    L_p = mk.trace_megakernel_reference(pack, md, o, d, rng)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    frac, dmean = check_contract(f"main path {size}x{size} rays", L_k, L_p)
    bound_ms, bound_by, nodes, prims, nbytes = bound_of(stats, B, mk.pack_bytes(pack))
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


def bound_of(stats, B: int, pack_bytes: int) -> tuple:
    """(bound ms, what bounds it, wide nodes, prim tests, bytes): rays, pcg
    states and L once plus the pack, against this run's walk work."""
    nodes = int(stats[:, 0].sum(dtype=torch.int64))
    prims = int(stats[:, 1].sum(dtype=torch.int64))
    ops = nodes * 8 * OPS_SLAB + prims * OPS_TRI
    nbytes = B * (6 * 4 + 2 * 4 + 3 * 4) + pack_bytes
    bound_ms = max(nbytes / PEAK_BYTES_S, ops / PEAK_F32_S) * 1e3
    bound_by = "bytes" if nbytes / PEAK_BYTES_S > ops / PEAK_F32_S else "operations"
    return bound_ms, bound_by, nodes, prims, nbytes


def phase_kitchen(mk, dev, args, scene, cam, build_s, MaxDepthParams, RenderingConfig,
                  ParsedScene, Renderer):
    """The surface main path: the Renderer on full-size kitchen_stress."""
    spp = args.kitchen_spp
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not (info["has_env"] and info["textured"] and info["has_disp"]):
        raise SystemExit(f"kitchen_stress did not set the K3 flags: {info}")
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    if launches["trace_megakernel"] <= 0:
        raise SystemExit("kitchen main path did not launch the megakernel")
    if img.shape != (cam.height, cam.width, 3) or not np.isfinite(img).all():
        raise SystemExit("kitchen main path image is not finite / has the wrong shape")
    log(f"[6] Renderer kitchen_stress {cam.width}x{cam.height}x{spp}spp: {wall:.2f} s wall "
        f"({wall * 1e3 / spp:.2f} ms per spp), launches {launches}, image mean "
        f"{float(img.mean()):.6f}, flags {r._pack.flags}")

    k = hold_main_path(mk, r, md, KITCHEN_BLOCK, "6", "kitchen",
                       f"incl. {mk.pack_bytes(r._pack, mk.K3_KEYS)} of uvs, texels and K3 tables")
    return {
        "name": "trace_megakernel (K3: has_env, textured, has_disp)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1445",
        "launches": launches["trace_megakernel"], **k, "library_ms": None,
        "wall_ms_per_spp": wall * 1e3 / spp, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims,
    }, r


def hold_main_path(mk, r, md, blk: int, phase: str, label: str, bytes_note: str = "") -> dict:
    """The main path's rays of sample 0 through the kernel at the full grid;
    one blk-lane Z-order block of its output (the one holding the image
    centre) held to the phase-4 contract against the plain version on the
    same lanes (lanes are independent); the kernel's time per spp (CUDA
    events) and on the block alone; its walk work and bound."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    cam, pack = r.camera, r._pack
    B = cam.width * cam.height
    perm, inv = mk.tile_swizzle(cam.width, cam.height, r.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(cam, perm, rng)
    k0 = int(inv[(cam.height // 2) * cam.width + cam.width // 2]) // blk * blk
    ob, db, rb = (x[k0:k0 + blk].contiguous() for x in (o, d, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(pack, md, ob, db, rb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k = mk.trace_megakernel(pack, md, o, d, rng)
    torch.cuda.synchronize()
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{label} main path rays: non-finite kernel output")
    L_kb = L_k[k0:k0 + blk]
    frac, dmean = check_contract(f"{label} main path {B} rays, block of {blk}", L_kb, L_p)
    block_ms = events_ms(lambda: mk.trace_megakernel(pack, md, ob, db, mk.rng_bits(rb)), 5)

    rng_bits = mk.rng_bits(rng)
    k_ms = events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 5)
    _, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    bound_ms, bound_by, nodes, prims, nbytes = bound_of(stats, B, mk.pack_bytes(pack))
    log(f"[{phase}] kernel {k_ms:.3f} ms/spp, {B / (k_ms * 1e-3):.4g} paths/s; block of {blk} "
        f"lanes of the {B}-ray launch vs the plain version ({plain_ms:.1f} ms on the block): "
        f"{frac:.7f} lanes differ, means differ by {dmean:.3g}; the kernel launched on the "
        f"block alone {block_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nodes} wide nodes, "
        f"{prims} prim tests, {nbytes} bytes {bytes_note}); {bound_ms / k_ms:.4f} of bound")
    return {"max_abs_err": float((L_kb - L_p).abs().max()), "ms": k_ms, "plain_ms": plain_ms,
            "plain_lanes": blk, "block_kernel_ms": block_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "paths_per_s": B / (k_ms * 1e-3), "lanes_differ": frac,
            "mean_differ": dmean, "wide_nodes": nodes, "prim_tests": prims}


def phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
              Renderer):
    """The volume path tracer's main path: the Renderer on full-size
    medium_cbox through kernel K4."""
    t0 = time.perf_counter()
    scene, cam, _ = tts.medium_cbox(1024, 1024, device=dev)
    build_s = time.perf_counter() - t0
    spp = VPT_SPP
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not info["has_media"]:
        raise SystemExit(f"medium_cbox: the Renderer's pack has no media: {info}")
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    img = r.render(spp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(mk.LAUNCHES)
    inst = dict(mk.INSTANTIATION_LAUNCHES)
    if launches["trace_megakernel"] <= 0 or inst != {"ALL+MED": launches["trace_megakernel"]}:
        raise SystemExit(f"VPT main path did not launch kernel K4 (MED) alone: {launches} {inst}")
    if img.shape != (cam.height, cam.width, 3) or not np.isfinite(img).all():
        raise SystemExit("VPT main path image is not finite / has the wrong shape")
    log(f"[7] medium_cbox ({scene.geom.num_prims} triangles, BVH built in {build_s:.1f} s; "
        f"{r._pack['nodes'].shape[0]} wide nodes, walk stack {r._pack.max_stack}, max leaf "
        f"{r._pack.max_leaf}): Renderer VOLUME_PT {cam.width}x{cam.height}x{spp}spp: "
        f"{wall:.2f} s wall ({wall * 1e3 / spp:.2f} ms per spp), launches {launches} {inst} "
        f"({launches['trace_megakernel'] / spp:g} per spp), image mean {float(img.mean()):.6f}")

    k = hold_main_path(mk, r, md, VPT_BLOCK, "7", "VPT",
                       f"incl. {mk.pack_bytes(r._pack, mk.MED_KEYS)} of the media row; the "
                       f"walk work incl. the transmittance walks")
    return {
        "name": "trace_megakernel (K4: has_media)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1386",
        "launches": launches["trace_megakernel"], **k, "library_ms": None,
        "wall_ms_per_spp": wall * 1e3 / spp, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims, "instantiations": inst,
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
    ap.add_argument("--kitchen-spp", type=int, default=16, help="phase-6 samples per pixel")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few main-path passes (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
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
    walk_k, kscene, kcam, build_s = phase_walk_kitchen(mk, tts, dev)
    res4 = phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T)
    res4_media = phase_kernel_media(mk, tts, dev, MaxDepthParams, T)
    k2, r = phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene, Renderer,
                       res4["cornell"]["mean_plain"])
    k3, rk = phase_kitchen(mk, dev, args, kscene, kcam, build_s, MaxDepthParams, RenderingConfig,
                           ParsedScene, Renderer)
    k4, rv = phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
                       Renderer)
    extra = {"profile": phase_profile(r), "profile_kitchen": phase_profile(rk),
             "profile_vpt": phase_profile(rv)} if args.profile else {}
    # the two result lines carry no time prefix: each is one JSON object
    print(json.dumps({"kernels": [k2, k3, k4], "card": card, "walk_check": walk,
                      "walk_check_kitchen": walk_k, "kernel_check": res4,
                      "kernel_check_media": res4_media, **extra}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
