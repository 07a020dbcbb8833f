"""GPU smoke test of the PyTorch + CUDA port (cuda_pt_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from cuda_pt_torch/csrc (one nvcc per
     translation unit, all started together, sm_90a) and print the seconds
     and ptxas' registers and spills per kernel instantiation (and what
     ptxas says of the wgmma products); with --parent, start the parent
     tree's build in the background;
  2. print the card's name and power limit (nvidia-smi);
  3. closest_hit_w8 against closest_hit_brute on 65536 random rays in the
     cornell box, and against the skip walk (accel/traverse.py) on 16384
     random rays in full-size kitchen_stress (98,790 triangles): prim ids
     equal except on exact ties; on the same kitchen rays, with every
     fifth lane dead, the traverse kernel K6 (the walk and the hit resolve)
     against its plain version (check_k6: prim ids equal, the hit planes
     bit-equal to resolve_hit of its own walk and within the per-lane
     contract of resolve_hit(traverse_plain); with --parent bit-equal to
     the parent's walk and resolve_hit);
  4. the megakernel against its plain PyTorch version (the fused kernel's
     estimator), 256x256, 4 spp, default depth caps, per-lane
     allclose(rtol=1e-4, atol=1e-5) on >= 98% of lanes and the image means
     within 5e-3, on cornell_box and its mirror / glass / GGX conductor /
     plastic / rough-dielectric tall boxes, cornell_box_lights (three
     emitters), the Oren-Nayar + Forward scene, the area-spot scene, the
     envmap furnace (its mean also within 0.05 of 1.0), the textured floor
     and kitchen_stress(grid=2, ns=6, nt=4) with all three K3 flags;
  4 (media). kernel K4, the volume path tracer's MED instantiations,
     against its plain version (the fused volume path tracer) under the
     phase-4 contract, 256x256, 4 spp: medium_box (HG), cornell_vpt (the
     camera in a medium), nested_media (media nested two deep), medium_box
     with a dual-HG and with a Rayleigh phase, and medium_box with an
     envmap (the K3 x MED instantiation);
  5. the main path on cornell_box (fewer than 512 boxes: the whole-path
     kernel K2): api.Renderer at 1024x1024, 64 spp, default depth caps,
     pcg, nee_candidates=1; the kernel's launch count must rise, every
     launch must be the STAGE build (the pack's tables in shared memory)
     and the image must be finite; then one spp of the main path's rays through
     the kernel and its plain version, held to the phase-4 contract; the
     same rays through the sorted-wavefront driver (kernel K5, auto_trace
     bypassed) held to the whole-path kernel bit for bit on every lane;
     the STAGE build against the plain build (the tables left in device
     memory) on the same rays, in turns, L bit-equal (stage_turns);
     the device launches (kernels and memsets) of one Renderer pass
     (torch.profiler), the parent's too with --parent; prints the kernel
     time per spp (CUDA events), paths/s, the plain version's time on the
     same rays and the bound; with --parent, the parent tree's K2 (one
     thread per path) against this tree's persistent grid on the same
     rays (ab_k2: lanes whose L or walk work differ bit for bit, which
     must be 0, then the ms in turns), as in phases 6 and 7 for K3 and K4
     called directly and in phase 11 for K2+BIN;
  6. the main path on full-size kitchen_stress (envmap, textures,
     dispersion; 76,784 boxes: the sorted-wavefront driver, K5's
     SEG+K3+ALL instantiation): api.Renderer at 1024x1024, 16 spp, the
     same settings, its pack in the reference's formats (w8 nodes, t9
     prims, bf16 attrs: the f32 pack is above the 2 MiB threshold of the
     format rule); launch counts (K5 only) and a finite image; one spp of
     its rays through the driver, a 65,536-lane Z-order block of that
     output held to the phase-4 contract against the driver on the plain
     versions; the driver's loop run piece by piece here (swf_loop, held
     bit for bit to the driver) for per spp K5's summed kernel time, the
     sort-and-gather glue, the other glue, the wall and the launches, the
     bound (the pack once plus the state planes K5 reads and writes,
     k5_bytes) and its share; with --parent, the parent tree's K5 on the
     same rays in turns (ab_k5: ms per spp, lanes whose L differs from
     this build's); and the whole-path kernel (K3, called directly) on the same rays: its time and a block held to
     its plain version, as before; then the same scene packed with f32
     attrs and prims: K5's and the whole-path kernel's time per spp and the
     image-mean gap between the two attr formats (f32_pass);
  7. the volume path tracer on full-size medium_cbox (36,888 triangles,
     media nested two deep; K5's SEG+ALL+MED): prints the BVH build
     seconds; api.Renderer(renderer=VOLUME_PT) at 1024x1024, 16 spp,
     default depth caps; the launch counts and a finite image; K5 held to
     its plain version on a 65,536-lane block and to the whole-path kernel
     K4 on every lane (untextured: the same estimator), with its timings
     as in phase 6; and K4 called directly: its time and a block held to
     its plain version; the pack in w8 nodes, t9 prims, bf16 attrs, and
     its f32 pass as in phase 6;
  8. grid media on grid_smoke with a density grid of 256^3 voxels (64 MiB,
     the size of a production smoke asset; the reference's grid-cbox .nvdb
     is absent): api.Renderer(renderer=VOLUME_PT) at 1024x1024, GRID_SPP
     spp (cut: spp, so that the phase's 64-step tracking loops stay under
     about a minute), default depth caps, through the split driver (K6 and
     K5's SEG+SHADE+ALL+MED+GRID); the launch counts and a finite image;
     the driver held to its plain version on a 65,536-lane block; K6
     (check_k6) on the first bounce of the main path's 1,048,576 rays and
     on a 65,536-lane block of them, every fifth lane dead; the timings of
     K5's shade phase and of K6 (the walk and the resolve, its bound with
     the g_hit columns read per hit lane and the hit planes written); K6
     per spp on one spp's recorded split states with its tables staged
     and left in device memory, in turns (ab_k6), and the device launches
     of its steps per spp; with --parent the parent's split step (its K6
     walk, then resolve_hit in PyTorch) on the same states, hit planes and
     the driver's L bit-equal to this tree's, the launches of its steps
     and of a whole driver pass of each tree, and its ms per spp and the
     driver's wall per spp in turns;
  9. kernel K1 (csrc/traverse.cu): full-size kitchen_stress forests in f32
     and in bf16 rows (forest_chunk 65536: two chunks; built in two worker
     processes while phases 4-8 run) and cornell's single-chunk forest,
     on the 1,048,576 camera rays of phase 6's camera (shadow limits half
     to one and a half times their closest t) and 65,536 random rays with
     finite t_far: per ray, prim ids and occlusion equal to the plain
     version, t, b1, b2 within the phase-4 tolerances, the bf16 rows' prim
     ids equal to the f32 rows'; the packet form (count_iters) on 16,384
     camera rays: tile_iters and prim ids equal to the plain packet walk;
     K1's time per 1M camera rays, closest and any hit (CUDA events), with
     its walk work (stats), bound and share, and per 32-lane group of
     the launch the largest and the mean node fetches per lane (the lane
     use a warp that waits for its longest walk reaches); with --parent,
     the parent tree's K1 against this tree's on the camera rays (ab_k1:
     rays whose hit or occlusion differ bit for bit, which must be 0, then
     the ms in turns); the sorted-lane walk alone
     (closest_hit_sorted, written for K5, which keeps the w8 walk) on the
     Renderer's kitchen pack against K1 on the camera rays (prim ids equal
     but on exact ties, counted) and bit-equal to the w8 walk, its stack
     depth and its time beside the w8 walk's;
  10. the wavefront main path: api.Renderer(renderer=WAVEFRONT_PT,
     traversal="pallas") on full-size kitchen_stress with its f32 forest,
     1024x1024, WF_SPP spp (cut: spp only), default depth caps: K1 and no
     other kernel launched, at most two launches per bounce, a finite
     image (its mean printed beside phase 6's K5 route's as a note: the
     two estimators agree in the mean only on textured scenes); K1's
     summed time, walk work, bound and per-group figures (as in phase 9)
     over one spp of the main path, and with --parent the same K1 calls
     replayed on the parent tree's K1 and on this one's (ab_k1_calls: rays
     differing bit for bit, which must be 0, then the ms in turns); a
     65,536-lane Z-order block of a pass's rays through the wavefront loop
     on K1 and on its plain walk, held to the phase-4 contract;
  4 (routes). the composed routes, SMALL x SMALL x 1 spp: the Renderer with
     traversal "pallas" against "xla" (the plain skip walk) per lane under
     the phase-4 contract on cornell (brute force on both: no K1 launch)
     and kitchen_stress(grid=2) with MEGAKERNEL_PT, and on full-size
     medium_cbox with VOLUME_PT.
  11. the reference's render_megakernel (make_pack(scene) in its rule's
     formats, then render_pack) at full size, launch counts set to 0 just
     before each and read just after: cornell 1024x1024 x RM_CORNELL_SPP on
     binary f32 nodes (the whole-path kernel, K2+BIN) and kitchen_stress
     1024x1024 x RM_KITCHEN_SPP on bf16 binary nodes, t9 prims and bf16
     attrs (K5, SEG+K3+ALL+BIN); per scene the kernel's time per spp on
     sample 0's rays, the walk work (node fetches, prim tests), bound and
     share, a 65,536-lane block held to the plain version, and the binary
     walk (closest_hit_w8 on f32 and bf16 rows) against K1 over the BVH as
     one chunk on the camera rays: prim ids equal;
  12. kernel S1 (csrc/node_bench.cu) on cornell's and kitchen_stress's
     binary f32 rows: S1_ITERS steps on S1_RAYS equal rays (the
     reference's) and on a block of random rays bit-equal to the plain
     version; c_node from its time at S1_ITERS and S1_ITERS / 2 steps, and
     S1's model share (node fetches x c_node over the measured time) of
     phase 11's two kernels; with --parent bit-equal to the parent's
     kernel on both sets of rays, its time and c_node in turns with it;
  13. kernel S2 (csrc/extract_ab.cu) on kitchen_stress's binary f32 rows:
     every tag bit-equal to its plain version on a tile of the reference's
     equal rays and a tile of random rays (8,192 lanes each, S2_HOLD_ITERS
     steps; each tile a cluster of blocks) and on 128 tiles
     (S2_CARD_HOLD_ITERS steps; a block per tile), with --parent to the
     parent's kernel too, v0 = v1 = v2 per lane, v0 on the equal rays =
     S1; with --parent each tag's c_node at 1 and 128 tiles in turns with
     the parent's kernel; the entry
     (extract_ab.main, launches counted from 0) on one tile over kitchen's
     and cornell's rows at 30,000 and 15,000 steps (the reference's shape),
     and over CARD_LANES lanes on kitchen's; c_node per tag and its bound;
  14. kernel S3 (csrc/lanegather.cu): every tag bit-equal to its plain
     version at (64, 128) x 512 and (8192, 128) x 16, the check gather equal
     to torch.take_along_dim; the gather warm and cold (L2 flushed before
     each launch) and an empty kernel on its grid (the launch floor) at
     both sizes; with --parent every tag and the gather bit-equal to the
     parent's kernel and the gather warm and cold in turns with it; the
     entry (lanegather.main, launches counted) at (64, 128) and (8192,
     128); per tag ns per iteration, per gather and per select; the
     gather against torch.take_along_dim;
  15. kernel S4 (csrc/mxuleaf.cu): scalar bit-equal to its plain version,
     mxu (3xTF32 wgmma) within the script's parity contract (>= 0.999
     agree and hit mask) against the plain product and against scalar, the
     1xTF32 A/B's hit mask >= 0.99, at 4,096 rays x 2,000 leaves and at
     CARD_LANES rays x S4_CARD_HOLD_LEAVES; HGMMA in both mxu builds' SASS
     (and the select chains' opcodes of phase 14); with --parent, the
     parent's mxu forms on the same inputs in turns; the entry
     (mxuleaf.main, launches counted) at 4,096 and CARD_LANES rays; the
     batched torch.matmul of the product alone;
  16. the light tracer's main path: api.Renderer(renderer=MEGAKERNEL_LT,
     traversal="pallas") on full-size kitchen_stress with its f32 forest,
     1024x1024, LT_SPP passes (cut: passes only), default depth caps: K1
     and no other kernel, at most 2 max_depth + 1 launches a pass (a
     closest and a connection walk per bounce and the vertex-0
     connection), a finite image with a positive mean; the wall and the
     launches per pass, and K1's summed time, walk work, bound and share
     over one pass (as in phase 10); 65,536 light paths (render_pass
     n_paths=BLOCK) on K1 and on its plain walk, held per pixel (float
     atomics do not fix the splat's order: over the pixels either touched,
     allclose(rtol 1e-4, atol 1e-6 x the largest pixel) on >= 98 %, image
     sums within 1e-4 relative); cornell 1024x1024 x LT_SPP through
     MEGAKERNEL_LT (brute force: no launch) and the fused MEGAKERNEL_PT,
     their image means' ratio in (0.8, 1.25); DEPTH and BVH_COST at SMALL
     on cornell and kitchen_stress(grid=2) held to the same Renderer on
     CPU tensors (DEPTH: the depth buffer, t_min and t_max within 4e-6
     relative, the image equal on >= 99 % of pixels; BVH_COST: the cost
     counts equal on >= 99.9 % of rays, mean_cost within 1e-3 relative),
     and each at 1024x1024 on cornell, its wall per pass; render_aovs(
     spp=1) under "pallas" on full-size kitchen_stress launching K1 alone,
     its coverage equal to the plain walk's and its depth within 1e-5
     relative on >= 99.9 % of pixels; denoise() of the fused cornell film
     at 4 passes against atrous_denoise on CPU copies of its mean, AOVs and
     variance (allclose rtol 1e-4, atol 1e-4).
The last two lines are a JSON object of kernel numbers and
{"ok": true, "device": {...}}. ``--size`` and ``--spp`` shrink phase 5
for quick checks and ``--kitchen-spp`` phase 6; phases 7 and 8 always run
at VPT_SPP and GRID_SPP samples per pixel and hold BLOCK lanes.
``--profile`` adds a torch.profiler breakdown of a few main-path passes
of each scene, of kitchen_stress and medium_cbox through the whole-path
kernel too, and of the wavefront and light-tracer main paths. ``--parent TREE`` (a git
archive of the parent commit unpacked under the git-ignored build/) holds
the parent's K2-K4, K1, K6 (its walk and resolve_hit), S1, S2 and S3 to
this tree's bit for bit and times them in turns (phases 3, 5-14), and
times the parent's K5 and S4 mxu against this tree's in phases 6, 7 and
15.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

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
# lanes of each main path (phases 6-8) held to the plain version (its run
# on this block stays under 30 s on an H100)
BLOCK = 65536
# samples per pixel of the volume main paths: medium_cbox (phase 7) and
# grid_smoke (phase 8) with its grid of GRID_N^3 voxels
VPT_SPP = 16
GRID_SPP = 8
GRID_N = 256
# kernel K1 (phases 9-10): prims per chunk of the kitchen forest, samples
# per pixel of the wavefront main path (cut: spp only), camera rays of the
# packet-form check, side of the composed-route holds (phase 4's style)
FOREST_CHUNK = 65536
WF_SPP = 2
PACKET_RAYS = 16384
SMALL = 128
# the light tracer's main path and the light-against-path check (phase 16;
# cut: passes only)
LT_SPP = 2
# render_megakernel at full size (phase 11; cut: spp only): samples per
# pixel on cornell and on kitchen_stress
RM_CORNELL_SPP = 16
RM_KITCHEN_SPP = 2
# kernel S1 (phase 12): rays and node steps per timed launch
S1_RAYS = 1 << 20
S1_ITERS = 1024
# kernels S2-S4 (phases 13-15): lanes of the card's scale, S2's hold steps
# (S1's; fewer at the card's scale, for the plain version's time), S4's
# hold leaves at the card's scale (the plain version's chunks shrink with
# the rays)
CARD_LANES = 1 << 20
S2_HOLD_ITERS = 1024
S2_CARD_HOLD_ITERS = 256
S4_CARD_HOLD_LEAVES = 16
PEAK_TF32_S = 495e12  # H100 SXM dense TF32 on the tensor cores
# f32 operations per lane and step of each S2 form (the slab test: OPS_SLAB)
OPS_S2 = {"e0": 1, "e1": 1, "e2": 1, "e3": 10, "v0": 22, "v1": 22, "v2": 22, "w2": 44,
          "v0_ilp2": 44, "v0_ilp4": 88, "v2_ilp2": 44}
# f32 operations per triangle and ray of S4's mxu epilogue (|det|, a select,
# the divide, 3 products, |det| again, 5 compares and an add, the update)
OPS_MXU_EPI = 14
# the device sleep before a kernel timed alone (swf_loop): 0.5 ms at the
# H100's highest SM clock (1.98 GHz), longer at lower clocks; it only has to
# outlast the host's launch latency
SETTLE_CYCLES = 1_000_000


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


def phase_build(cb) -> dict:
    """Build the library; print the seconds and, per kernel instantiation,
    ptxas' registers and spill bytes (the template flags in the order of
    each kernel's template: trace_kernel<K3,ALL,MED,BIN>,
    seg_kernel<K3,ALL,MED,SHADE,GRID,BIN,CPT>, ...) and what ptxas says of
    the wgmma products (a serialized wgmma is named there)."""
    secs = cb.build()
    log(f"[1] built megakernel in {secs:.1f} s")
    blog = cb.build_log()
    rows = cb.ptxas_report(blog)
    for name, regs, st, ld in rows:
        log(f"    {name}: {regs} registers, spill stores {st} B, spill loads {ld} B")
    notes = sorted({line.strip() for line in blog.splitlines() if "wgmma" in line.lower()})
    for line in notes:
        log(f"    ptxas: {line}")
    return {"build_s": secs, "ptxas": rows, "wgmma_notes": notes}


# the parent tree's build (--parent): its running build, then its library
_PARENT = {"job": None, "lib": None}


def start_parent(cb, args) -> None:
    """Start the build of the parent checkout's library (--parent: a git
    archive of the parent commit unpacked in a directory, e.g. under the
    git-ignored build/), timed against this tree's on the same inputs."""
    if args.parent:
        _PARENT["job"] = cb.start_tree_build(args.parent)


def parent_lib() -> str | None:
    """The library path of start_parent's build (None without --parent),
    waited for at the first call; prints its K2-K5, K1 and S4
    instantiations' registers and spills."""
    from cuda_pt_torch.ops import cuda_build as cb

    if _PARENT["job"] is not None and _PARENT["lib"] is None:
        _PARENT["lib"] = cb.finish_tree_build(_PARENT["job"])
        for kname, regs, st, ld in cb.ptxas_report(cb.build_log(_PARENT["lib"])):
            if kname.startswith(("seg_kernel", "leaf_mxu", "trace_kernel", "k1_kernel",
                                 "traverse_kernel", "extract_ab_kernel")):
                log(f"    [parent] {kname}: {regs} registers, spill stores {st} B, "
                    f"spill loads {ld} B")
    return _PARENT["lib"]


def start_sass(cb) -> dict:
    """The built library's SASS, dumped by cuobjdump in a process of its own
    while the phases run; "read"(patterns) waits for it and returns the
    opcode counts of the kernels whose symbols contain a pattern (phase
    15), "stop"() ends the process if it still runs."""
    from tools import sass_ops

    path = os.path.join(cb.BUILD_DIR, "sass_dump.txt")
    proc = sass_ops.start_dump(cb.library_path(), path)

    def read(patterns):
        if proc.wait() != 0:
            raise SystemExit(f"cuobjdump failed: {proc.stderr.read().decode()[-2000:]}")
        with open(path) as f:
            return sass_ops.opcodes_of(f.read(), patterns)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    return {"read": read, "stop": stop}


def phase_card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(out, flush=True)  # as nvidia-smi gives it, on a line of its own
    return out


def phase_walk(mk, tts, dev):
    scene, _, _ = tts.cornell_box(device=dev)
    pack = mk.make_pack(scene, node_fmt="w8")
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
    pack = mk.make_pack(scene, node_fmt="w8")
    rs = np.random.default_rng(11)
    B = 16384
    lo = scene.bvh.node_min[0].cpu().numpy()
    hi = scene.bvh.node_max[0].cpu().numpy()
    o_t = torch.as_tensor(rs.uniform(lo, hi, (B, 3)).astype(np.float32), device=dev)
    d = rs.normal(size=(B, 3)).astype(np.float32)
    d_t = torch.as_tensor(d / np.linalg.norm(d, axis=1, keepdims=True), device=dev)
    _, prim_k, _, _ = mk.closest_hit_w8(pack, o_t, d_t)
    h = traverse.closest_hit_bvh(scene.geom, scene.bvh, o_t, d_t)
    o_t, d_t = o_t.contiguous(), d_t.contiguous()
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
    k6 = check_k6(mk, pack, k6_state(mk, pack, o_t, d_t), B, "kitchen_stress random rays")
    return {"rays": B, "differ": int(differ.sum()), "exact_ties": ties, "k6": k6}, scene, cam, \
        build_s


def k6_state(mk, pack, o, d):
    """State planes of rays (B, 3) with every fifth lane dead."""
    st = mk.seg_init(pack, o, d, torch.zeros((o.shape[0], 2), dtype=torch.int64, device=o.device))
    st.view(torch.float32)[mk.S_ACT, ::5] = 0.0
    return st


# the parent tree's K6 entry (--parent): tables, state, stride, n, out,
# stats, max_leaf, tri_only, fmt, n_nodes, stream
PARENT_K6 = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + \
    [ctypes.c_int] * 4 + [ctypes.c_void_p]


def parent_walk(mk, pack, st, n, stats=None):
    """The parent tree's K6 walk (inside with_parent; its C entry
    mk_traverse) -> its (t, gid, u, v) planes (4, n)."""
    from cuda_pt_torch.ops import cuda_build as cb

    lib = cb.load()
    lib.mk_traverse.argtypes = PARENT_K6
    lib.mk_traverse.restype = ctypes.c_int
    out = torch.empty((4, n), dtype=torch.float32, device=st.device)
    rc = lib.mk_traverse(mk._tables(pack), st.data_ptr(), st.shape[1], n, out.data_ptr(),
                         stats.data_ptr() if stats is not None else None, *mk.walk_args(pack),
                         torch.cuda.current_stream(st.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the parent's mk_traverse: cudaError {rc}")
    return out


def parent_k6(mk, pack, st, n, trav=None, stats=None):
    """The parent tree's split step (inside with_parent): its K6 walk
    (parent_walk), then resolve_hit's row gather in PyTorch; the arguments
    and result of mk.traverse_resolve."""
    out = parent_walk(mk, pack, st, n, stats)
    if trav is not None:
        trav.copy_(out)
    return mk.resolve_hit(pack, out)


@contextlib.contextmanager
def parent_split(mk):
    """The parent tree's library while the block runs, and the split
    driver's K6 step its form: this tree's where the parent's library
    exports mk_traverse_resolve (the walk and the resolve in the kernel),
    else parent_k6."""
    from cuda_pt_torch.ops import cuda_build as cb

    real = mk.traverse_resolve
    prev = cb.use_library(parent_lib())
    if not hasattr(cb.load(), "mk_traverse_resolve"):
        mk.traverse_resolve = lambda pack, st, n, trav=None, stats=None: parent_k6(
            mk, pack, st, n, trav, stats)
    try:
        yield
    finally:
        cb.use_library(prev)
        mk.traverse_resolve = real


def check_k6(mk, pack, st, n: int, label: str) -> dict:
    """Kernel K6 (the walk and the hit resolve) on the first n lanes of the
    state planes st (every fifth dead): prim ids equal to the plain walk's
    on every lane, dead lanes without a hit; the hit planes bit-equal to
    resolve_hit of the same launch's (t, gid, u, v) output and within the
    per-lane contract of resolve_hit(traverse_plain); with --parent, bit-
    equal to the parent's resolve_hit(traverse_closest) on every lane."""
    trav = torch.empty((4, n), dtype=torch.float32, device=st.device)
    hit = mk.traverse_resolve(pack, st, n, trav)
    ref = mk.traverse_plain(pack, st, n)
    want = mk.resolve_hit(pack, ref)
    torch.cuda.synchronize()
    differ = int((trav[1] != ref[1]).sum())
    hits = int((trav[1] >= 0).sum())
    both = (trav[1] >= 0) & (ref[1] >= 0)
    err = float((trav[0][both] - ref[0][both]).abs().max()) if bool(both.any()) else 0.0
    own = bit_lanes(hit.T, mk.resolve_hit(pack, trav).T)
    frac = lane_mismatch(hit.T, want.T)
    plane_err = float(torch.where(hit == want, 0.0, (hit - want).abs()).max())
    row = {"rays": n, "differ": differ, "hits": hits, "max_abs_err_t": err,
           "planes": hit.shape[0], "planes_lanes_differ_own": own,
           "planes_lanes_outside_contract": frac, "planes_max_abs_err": plane_err}
    if parent_lib() is not None:
        with parent_split(mk):
            p_hit = mk.traverse_resolve(pack, st, n)
        row["planes_lanes_differ_parent"] = bit_lanes(hit.T, p_hit.T)
    log(f"[K6] walk + resolve vs the plain walk on {n} {label} (every fifth dead): {differ} prim "
        f"ids differ; hits {hits}; {hit.shape[0]} hit planes: lanes not bit-equal to resolve_hit "
        f"of its own walk {own}, outside the contract against resolve_hit(traverse_plain) "
        f"{frac:.7f}" + (f", not bit-equal to the parent's {row['planes_lanes_differ_parent']}"
                         if "planes_lanes_differ_parent" in row else ""))
    if differ or not bool((trav[1, ::5] == -1).all()) or own or frac > MAX_LANE_FRAC \
            or row.get("planes_lanes_differ_parent", 0):
        raise SystemExit(f"K6 check failed on {label}: {row}")
    return row


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
        pack = mk.make_pack(scene, node_fmt="w8")
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
        pack = mk.make_pack(scene, node_fmt="w8", vpt=True)
        want = ("K3+ALL+MED" if pack.has_env else "ALL+MED") + (
            "+STAGE" if mk.stages(pack) else "")
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
    inst = dict(mk.INSTANTIATION_LAUNCHES)
    if launches["trace_megakernel"] <= 0:
        raise SystemExit("main path did not launch the megakernel")
    want_inst = "K2+STAGE" if mk.stages(r._pack) else "K2"
    if inst != {want_inst: launches["trace_megakernel"]}:
        raise SystemExit(f"main path launched {inst}, not {want_inst} alone")
    if img.shape != (size, size, 3) or not np.isfinite(img).all():
        raise SystemExit("main path image is not finite / has the wrong shape")
    mean = float(img.mean())
    log(f"[5] Renderer {size}x{size}x{spp}spp: {wall:.2f} s wall, launches {launches} {inst}, "
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
    # the sorted-wavefront driver on the same rays, auto_trace bypassed: the
    # same estimator as the whole-path kernel, lane for lane
    L_s = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    frac_s, dmean_s = check_contract("cornell rays, K5 vs the whole-path kernel", L_s, L_k)
    log(f"[5] K5 (driver, key pos_dir) vs K2 on the same {B} rays: {frac_s:.7f} lanes differ, "
        f"{int((L_s != L_k).any(dim=-1).sum())} not bit-equal, means differ by {dmean_s:.3g}")
    if (L_s != L_k).any():
        raise SystemExit("cornell rays: K5 and the whole-path kernel differ bit for bit")
    # the second lever on its own: the same launch with the tables left in
    # device memory (the plain build), in turns with the STAGE build
    stage_ab = stage_turns(mk, pack, md, o, d, rng_bits, L_k)
    # device launches of one pass (the work counter resets in the kernel:
    # no memset beside the trace launch)
    launches_pass = {"this": device_launches(r.render_raw)}
    ab = None
    if parent_lib() is not None:
        launches_pass["parent"] = with_parent(lambda: device_launches(r.render_raw))
        ab = ab_k2(mk, pack, md, o, d, rng, "5", "K2 cornell (w8, f32 tables)")
    log(f"[5] device launches (kernels and memsets) per Renderer pass: {launches_pass} "
        f"(trace_megakernel {launches['trace_megakernel'] / spp:g} per pass)")
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
        "k5_vs_k2_lanes_differ": frac_s, "device_launches_per_pass": launches_pass,
        "instantiations": inst, "stage": stage_ab,
        **({"parent": ab, "parent_ms": ab["parent_ms"]} if ab else {}),
    }, r


def slabs_per_node(pack) -> int:
    """Slab tests per counted node: a w8 node's 8 children, a binary node's
    one box."""
    return 8 if pack.node_fmt == "w8" else 1


def node_word(pack) -> str:
    return "wide nodes" if pack.node_fmt == "w8" else "node fetches"


def bound_of(stats, B: int, pack_bytes: int, per_node: int = 8) -> tuple:
    """(bound ms, what bounds it, nodes, prim tests, bytes): rays, pcg
    states and L once plus the pack, against this run's walk work (nodes
    of per_node slab tests each)."""
    nodes = int(stats[:, 0].sum(dtype=torch.int64))
    prims = int(stats[:, 1].sum(dtype=torch.int64))
    nbytes = B * (6 * 4 + 2 * 4 + 3 * 4) + pack_bytes
    return (*bound(nbytes, nodes, prims, per_node), nodes, prims, nbytes)


def bound(nbytes: int, nodes: int, prims: int, per_node: int = 8) -> tuple:
    """(bound ms, what bounds it) of nbytes moved and a walk of nodes
    nodes of per_node slab tests each (8: w8 wide nodes) and prims prim
    tests."""
    ops = nodes * per_node * OPS_SLAB + prims * OPS_TRI
    t_b, t_o = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations"


def counted_path(mk, run, cam, label: str, want: dict) -> tuple:
    """run() (a main path: it returns the image) with every launch count set
    to 0 just before and read just after; fails unless the path launched
    exactly the kernels (LAUNCHES keys, each > 0) and instantiations of
    want ({"launches": [...], "instantiations": [...]}), and the image is
    finite, cam.height x cam.width x 3. Returns (wall s, launches,
    instantiation launches, image mean)."""
    torch.cuda.synchronize()
    mk.reset_launches()
    t0 = time.perf_counter()
    img = torch.as_tensor(run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in mk.LAUNCHES.items() if v}
    inst = dict(mk.INSTANTIATION_LAUNCHES)
    if sorted(launches) != sorted(want["launches"]) or sorted(inst) != sorted(want["instantiations"]):
        raise SystemExit(f"{label} main path launched {launches} {inst}, not {want}")
    if tuple(img.shape) != (cam.height, cam.width, 3) or not bool(torch.isfinite(img).all()):
        raise SystemExit(f"{label} main path image is not finite / has the wrong shape")
    return wall, launches, inst, float(img.mean())


def render_main_path(mk, r, spp: int, label: str, want: dict) -> tuple:
    """The Renderer's spp passes, counted (counted_path)."""
    return counted_path(mk, lambda: r.render(spp), r.camera, label, want)


def main_rays(mk, r, blk: int):
    """The main path's rays of sample 0 (Z-order lanes) and the blk-lane
    block of them that holds the image centre: (o, d, rng, slice)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    cam = r.camera
    perm, inv = mk.tile_swizzle(cam.width, cam.height, r.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(cam, perm, rng)
    k0 = int(inv[(cam.height // 2) * cam.width + cam.width // 2]) // blk * blk
    return o, d, rng, slice(k0, k0 + blk)


def swf_loop(mk, pack, md, o, d, rng, timing: bool = False, count: bool = False) -> dict:
    """The sorted-wavefront driver's loop (mk.trace_megakernel_swf on the
    kernels, key "pos_dir") run here piece by piece, so that the package
    carries no measurement code. timing: CUDA events around each phase,
    summed per phase into "ms": "seg" (the K5 launches) and "traverse"
    (K6: the walk and the hit resolve), each kernel alone (it starts after
    a device sleep of SETTLE_CYCLES that covers the host's launch latency;
    the sleep belongs to no phase), "sort" (key, argsort, state gather, live count) and
    "glue" (grid passes, texels, the envmap epilogue, the un-permute),
    each from its first to its last operation, gaps while the device waits
    for the host included. count: the walk work of K5 and K6 per slot
    ("stats", "stats_t") and, per launch, the lanes whose envmap miss
    record K5 wrote ("misses") and K6's lanes with a hit ("hits"). Returns
    those, L and the live lanes of each launch."""
    dev = o.device
    B = o.shape[0]
    ms, open_ = {}, [None]

    def mark(name, settle: bool = False):
        if not timing:
            return
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if open_[0] is not None:
            ms.setdefault(open_[0][0], []).append((open_[0][1], ev))
        if settle:
            torch.cuda._sleep(SETTLE_CYCLES)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        open_[0] = (name, ev) if name else None

    stats = torch.zeros((B, 2), dtype=torch.int32, device=dev) if count else None
    stats_t = torch.zeros((B, 2), dtype=torch.int32, device=dev) if count else None
    env = mk.seg_layout(pack).env
    st = mk.seg_init(pack, o, d, rng)
    pix = torch.arange(B, device=dev)
    lanes, misses, hits = [], [], []
    for bounce in range(md.max_depth):
        mark("sort")
        st, pix, n = mk.swf_sort(st, pix, "pos_dir")
        if n == 0:
            break
        lanes.append(n)
        hit = flight = None
        if pack.has_grid:
            mark("traverse", settle=True)
            hit = mk.traverse_resolve(pack, st, n, stats=stats_t)
            mark("glue")
            if count:
                hits.append(int((hit[1] > 0.5).sum()))
            flight = mk.grid_flight(pack, st, n, hit[0]).contiguous()
        env0 = st[env:env + 6, :n].clone() if count and env >= 0 else None
        mark("seg", settle=True)
        mk.trace_megakernel_seg(pack, md, st, n, bounce, 1, hit, flight, stats)
        mark("glue")
        if env0 is not None:
            misses.append(int((st[env:env + 6, :n] != env0).any(dim=0).sum()))
        mk.swf_resolve(pack, st, n)
    mark("glue")
    L = mk.swf_result(pack, st, pix)
    mark(None)
    torch.cuda.synchronize()
    return {"L": L, "live_lanes": lanes, "misses": misses, "hits": hits, "stats": stats,
            "stats_t": stats_t,
            "ms": {k: sum(a.elapsed_time(b) for a, b in v) for k, v in ms.items()}}


def k6_bytes(mk, pack, lanes: list, hits: list) -> tuple:
    """(bytes, per live lane, per hit lane) that K6 moves over the launches
    of a driver run: per live lane the state planes it reads (act, o, d)
    and the hit planes it writes; per hit lane the g_hit columns the
    resolve reads (the normals, the geometric normal, eid, bid, inv_area,
    the sphere's centre and flag unless tri_only, the uvs if textured, the
    medium planes with media); a miss reads row 0, counted once, as are
    the nodes and prims."""
    cols = 9 + 3 + 3 + (0 if pack.tri_only else 4) + (6 if pack.textured else 0) \
        + (2 if pack.has_media else 0)
    per_lane = 7 * 4 + mk.hit_planes(pack) * 4
    nbytes = sum(lanes) * per_lane + sum(hits) * cols * 4 + 32 * 4 \
        + mk.pack_bytes(pack, ("nodes", "prims"))
    return nbytes, per_lane, cols * 4


def k5_bytes(pack, lanes: list, misses: list) -> tuple:
    """(bytes, reads per lane, writes per lane) that K5 moves over the
    launches of a driver run, as csrc/seg.cuh reads and writes the planes:
    each launched lane (all live: the driver launches the live prefix)
    reads planes 0-20, the medium stack (MED) and, in the SHADE form, the
    hit planes it uses and the flight planes; it writes planes 0-20, the
    medium stack, the texture record (textured) and the grid NEE record
    (GRID); the envmap miss record only on a miss (misses: lanes per
    launch). The pack counts once per run in the caller."""
    med = 5 if pack.has_media else 0
    shade = 0
    if pack.has_grid:
        shade = (10 + (0 if pack.tri_only else 1) + 1 + (2 if pack.textured else 0) + 1) + 5
    reads = (21 + med + shade) * 4
    writes = (21 + med + (6 if pack.textured else 0) + (9 if pack.has_grid else 0)) * 4
    return sum(lanes) * (reads + writes) + sum(misses) * 24, reads, writes


def ab_k5(mk, pack, md, o, d, rng, L, phase: str, label: str) -> dict:
    """The parent tree's K5 (parent_lib) on the same rays as this build's,
    in turns (parent, this, this, parent) after an untimed run of the
    parent's (its first launches load its kernels): the mean ms per spp of
    each (swf_loop's "seg") and the lanes whose L differs from this
    build's L, bit for bit."""
    from cuda_pt_torch.ops import cuda_build as cb

    path = parent_lib()

    def parent_run(**kw):
        prev = cb.use_library(path)
        try:
            return swf_loop(mk, pack, md, o, d, rng, **kw)
        finally:
            cb.use_library(prev)

    parent_run()
    ms = {"parent": [], "this": []}
    differ = 0
    for who in ("parent", "this", "this", "parent"):
        if who == "this":
            run = swf_loop(mk, pack, md, o, d, rng, timing=True)
        else:
            run = parent_run(timing=True)
            differ = max(differ, int((run["L"] != L).any(dim=-1).sum()))
        ms[who].append(run["ms"]["seg"])
    row = {"parent_ms": float(np.mean(ms["parent"])), "this_ms": float(np.mean(ms["this"])),
           "runs_ms": ms, "lanes_differ": differ}
    log(f"[{phase}] K5 {label}: the parent {row['parent_ms']:.3f} ms against this tree's "
        f"{row['this_ms']:.3f} ms per spp, in turns on the same rays (this / parent "
        f"{row['this_ms'] / row['parent_ms']:.4f}; runs {ms}); lanes whose L differs from "
        f"this tree's: {differ}")
    return row


def with_parent(fn):
    """fn() with the wrappers launching the parent tree's library."""
    from cuda_pt_torch.ops import cuda_build as cb

    prev = cb.use_library(parent_lib())
    try:
        return fn()
    finally:
        cb.use_library(prev)


def bit_lanes(a: torch.Tensor, b: torch.Tensor) -> int:
    """Lanes (rows) of two same-shaped outputs that differ in any bit."""
    a = a.view(torch.int32) if a.dtype == torch.float32 else a
    b = b.view(torch.int32) if b.dtype == torch.float32 else b
    return int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())


def in_turns(run, phase: str, label: str, unit: str = "ms per launch") -> dict:
    """run() (-> device ms) on the parent tree's library and on this one's in
    turns (parent, this, this, parent): the mean of each and the runs."""
    ms = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        ms[who].append(with_parent(run) if who == "parent" else run())
    row = {"parent_ms": float(np.mean(ms["parent"])), "this_ms": float(np.mean(ms["this"])),
           "runs_ms": ms}
    log(f"[{phase}] {label}: the parent {row['parent_ms']:.4f} against this tree's "
        f"{row['this_ms']:.4f} {unit}, in turns on the same inputs (this / parent "
        f"{row['this_ms'] / row['parent_ms']:.4f}; runs {ms})")
    return row


def ab_k2(mk, pack, md, o, d, rng, phase: str, label: str) -> dict:
    """The parent tree's whole-path kernel (parent_lib: one thread per path)
    against this tree's persistent grid on the same rays: the lanes whose L
    or walk work (count_stats) differ bit for bit (must be 0), then the ms
    per launch in turns (events_ms, 5 launches a turn)."""
    rng_bits = mk.rng_bits(rng)

    def outs():
        out = mk.trace_megakernel(pack, md, o, d, rng_bits, count_stats=True)
        torch.cuda.synchronize()
        return out

    L_t, st_t = outs()
    L_p, st_p = with_parent(outs)
    differ = bit_lanes(L_t, L_p)
    stats_differ = bit_lanes(st_t, st_p)
    row = in_turns(lambda: events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 5),
                   phase, f"{label}, {o.shape[0]} paths")
    row.update({"lanes_differ": differ, "stats_lanes_differ": stats_differ})
    log(f"[{phase}] {label}: lanes whose L differs from the parent's bit for bit: {differ}; "
        f"whose walk work differs: {stats_differ}")
    if differ or stats_differ:
        raise SystemExit(f"{label}: the persistent grid's output differs from the parent's")
    return row


@contextlib.contextmanager
def no_stage(mk):
    """The whole-path kernel's plain build on any pack while the block runs:
    the table sizes its STAGE rule reads (ops/megakernel._tables, the last
    len(STAGE_KEYS) entries) are withheld."""
    real = mk._tables

    def unsized(pack):
        t = real(pack)
        for k in range(len(t) - len(mk.STAGE_KEYS), len(t)):
            t[k] = 0
        return t

    mk._tables = unsized
    try:
        yield
    finally:
        mk._tables = real


def stage_turns(mk, pack, md, o, d, rng_bits, L) -> dict:
    """The STAGE build (the pack's tables in shared memory) against the
    plain build on the same rays, in turns (stage, plain, plain, stage;
    events_ms, 10 launches a turn): ms of each, and the lanes whose L
    differs bit for bit (must be 0)."""
    def run():
        return mk.trace_megakernel(pack, md, o, d, rng_bits)

    with no_stage(mk):
        differ = bit_lanes(run(), L)
    ms = {"stage": [], "plain": []}
    for who in ("stage", "plain", "plain", "stage"):
        if who == "plain":
            with no_stage(mk):
                ms[who].append(events_ms(run, 10))
        else:
            ms[who].append(events_ms(run, 10))
    row = {"stage_ms": float(np.mean(ms["stage"])), "plain_ms": float(np.mean(ms["plain"])),
           "runs_ms": ms, "lanes_differ": differ, "staged": mk.stages(pack),
           "stage_bytes": sum(pack[k].numel() * pack[k].element_size() for k in mk.STAGE_KEYS)}
    log(f"[5] K2's tables in shared memory ({row['stage_bytes']} bytes, staged: {row['staged']}) "
        f"{row['stage_ms']:.4f} ms against {row['plain_ms']:.4f} ms left in device memory, in "
        f"turns (runs {ms}); lanes whose L differs: {differ}")
    if differ:
        raise SystemExit("K2: the STAGE build's L differs from the plain build's")
    return row


def ab_k1(tk, forest, o, d, t_far, phase: str, label: str) -> dict:
    """The parent tree's K1 (one thread per ray) against this tree's
    persistent grid on the same rays, closest and any hit: the rays whose
    t, prim, b1, b2 or occlusion differ bit for bit (must be 0), then the ms
    per launch of each in turns (events_ms, 10 launches a turn)."""
    def outs():
        k = tk.traverse_forest(forest, o, d)
        occ = tk.traverse_forest(forest, o, d, t_far, occlusion=True)["occluded"]
        torch.cuda.synchronize()
        return torch.stack([k["t"].view(torch.int32), k["prim"].int(), k["b1"].view(torch.int32),
                            k["b2"].view(torch.int32), occ.int()], 1)

    differ = bit_lanes(outs(), with_parent(outs))
    row = {"closest": in_turns(lambda: events_ms(lambda: tk.traverse_forest(forest, o, d), 10),
                               phase, f"K1 closest, {label}"),
           "anyhit": in_turns(lambda: events_ms(lambda: tk.traverse_forest(
               forest, o, d, t_far, occlusion=True), 10), phase, f"K1 any hit, {label}"),
           "rays_differ": differ}
    log(f"[{phase}] K1 {label}: rays whose hit or occlusion differs from the parent's bit for "
        f"bit: {differ}")
    if differ:
        raise SystemExit(f"K1 {label}: the persistent grid's hits differ from the parent's")
    return row


def replay_k1(tk, calls: list) -> float:
    """Summed device ms of recorded K1 calls (k1_calls' "args"), each
    launched after a device sleep that covers the host's launch latency."""
    evs = []
    for forest, o, d, t_far, occlusion, max_leaf in (c["args"] for c in calls):
        torch.cuda._sleep(SETTLE_CYCLES)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        tk.traverse_forest(forest, o, d, t_far, max_leaf, occlusion)
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs)


def ab_k1_calls(tk, calls: list, phase: str, label: str) -> dict:
    """The recorded K1 calls of a main-path pass (k1_calls with record) on
    the parent tree's K1 and on this tree's: the rays whose outputs differ
    bit for bit (must be 0), then the summed ms in turns (replay_k1)."""
    def outs():
        res = []
        for forest, o, d, t_far, occlusion, max_leaf in (c["args"] for c in calls):
            r = tk.traverse_forest(forest, o, d, t_far, max_leaf, occlusion)
            res.append(r["occluded"][:, None].int() if occlusion else torch.stack(
                [r["t"].view(torch.int32), r["prim"].int(), r["b1"].view(torch.int32),
                 r["b2"].view(torch.int32)], 1))
        torch.cuda.synchronize()
        return res

    differ = sum(bit_lanes(a, b) for a, b in zip(outs(), with_parent(outs)))
    row = in_turns(lambda: replay_k1(tk, calls), phase, f"K1 {label}, {len(calls)} calls",
                   "ms summed")
    row["rays_differ"] = differ
    log(f"[{phase}] K1 {label}: rays whose outputs differ from the parent's bit for bit: "
        f"{differ}")
    if differ:
        raise SystemExit(f"K1 {label}: the persistent grid's outputs differ from the parent's")
    return row


def warp_figures(stats: torch.Tensor) -> dict:
    """Per 32-lane group of a launch (in launch order) of its stats plane's
    node fetches per lane: the group's largest and mean summed over groups,
    their ratio (the lane use of a warp that waits for its longest walk)
    and the group count."""
    f = stats[:, 0].double()
    pad = (-f.numel()) % 32
    g = torch.cat([f, f.new_zeros(pad)]).view(-1, 32)
    n = torch.cat([torch.ones_like(f), f.new_zeros(pad)]).view(-1, 32).sum(1)
    mx, mean = float(g.max(1).values.sum()), float((g.sum(1) / n).sum())
    return {"warp_max_sum": mx, "warp_mean_sum": mean, "warps": g.shape[0],
            "warp_max": mx / g.shape[0], "warp_mean": mean / g.shape[0], "lane_use": mean / mx}


def log_warp_figures(phase: str, label: str, figs: dict) -> None:
    log(f"[{phase}] {label}, node fetches per lane over {figs['warps']} 32-lane groups: "
        f"largest {figs['warp_max']:.3f}, mean {figs['warp_mean']:.3f} on average; lane use "
        f"{figs['lane_use']:.4f}")


def device_launches(run) -> int:
    """Device-side launches (kernels and memsets) of one run(), counted by
    torch.profiler (CUPTI), after one warm-up profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def hold_swf(mk, r, md, blk: int, phase: str, label: str, ab: bool = False) -> dict:
    """Kernel K5 (and K6 in the split form) under the sorted-wavefront
    driver on one spp of the main path's rays: a blk-lane block of the
    output held to the phase-4 contract against the driver on the plain
    versions on the same lanes; the driver's loop run here (swf_loop) held
    bit for bit to the driver's output; per spp (three runs) K5's summed
    kernel time, K6's, the sort-and-gather glue, the other glue, the wall
    of an untimed driver run and the launches; the walk work and the
    bound: the pack once plus what K5 moves (k5_bytes); with ab and
    --parent, the parent tree's K5 on the same rays (ab_k5)."""
    pack = r._pack
    o, d, rng, blk_sl = main_rays(mk, r, blk)
    B = o.shape[0]
    ob, db, rb = (x[blk_sl].contiguous() for x in (o, d, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_swf_reference(pack, md, ob, db, rb, key_mode="pos_dir")
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    torch.cuda.synchronize()
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{label} main path rays: non-finite K5 output")
    L_kb = L_k[blk_sl]
    frac, dmean = check_contract(f"{label} K5 on {B} rays, block of {blk}", L_kb, L_p)
    cnt = swf_loop(mk, pack, md, o, d, rng, count=True)
    if not torch.equal(cnt["L"], L_k):
        raise SystemExit(f"{label}: the measured loop is not the driver (its L differs)")
    runs = []
    for _ in range(3):
        tm = swf_loop(mk, pack, md, o, d, rng, timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
        torch.cuda.synchronize()
        runs.append({"wall_ms": (time.perf_counter() - t0) * 1e3, **tm["ms"]})
    lanes, misses = cnt["live_lanes"], cnt["misses"]
    state_bytes, reads, writes = k5_bytes(pack, lanes, misses)
    nbytes = mk.pack_bytes(pack) + state_bytes
    nodes = int(cnt["stats"][:, 0].sum(dtype=torch.int64))
    prims = int(cnt["stats"][:, 1].sum(dtype=torch.int64))
    bound_ms, bound_by = bound(nbytes, nodes, prims, slabs_per_node(pack))
    mean = {k: float(np.mean([run[k] for run in runs])) for k in runs[0]}
    seg_ms = mean["seg"]
    split = pack.has_grid
    log(f"[{phase}] K5 {label}: {frac:.7f} of the block's {blk} lanes differ from the plain "
        f"driver ({plain_ms:.1f} ms on the block), means differ by {dmean:.3g}; per spp (mean of "
        f"3): K5 {seg_ms:.3f} ms over {len(lanes)} launches (live lanes {lanes}), sort+gather "
        f"{mean['sort']:.3f} ms, other glue {mean['glue']:.3f} ms"
        + (f", K6 {mean['traverse']:.3f} ms" if split else "")
        + f", wall {mean['wall_ms']:.3f} ms; per live lane per launch {reads} B read, {writes} B "
        f"written (+24 B on a miss: {sum(misses)} misses); bound {bound_ms:.4f} ms ({bound_by}: "
        f"{nodes} {node_word(pack)}, {prims} prim tests, {nbytes} bytes of which {state_bytes} "
        f"state); {bound_ms / seg_ms:.4f} of bound; pack formats {pack_formats(pack)}")
    out = {"max_abs_err": float((L_kb - L_p).abs().max()), "ms": seg_ms, "plain_ms": plain_ms,
           "plain_lanes": blk, "bound_ms": bound_ms, "bound_by": bound_by,
           "lanes_differ": frac, "mean_differ": dmean, "wide_nodes": nodes, "prim_tests": prims,
           "state_read_bytes_per_lane_launch": reads, "state_write_bytes_per_lane_launch": writes,
           "env_misses": sum(misses), "state_bytes": state_bytes,
           "launches_per_spp": len(lanes), "live_lanes": lanes, "sort_gather_ms": mean["sort"],
           "glue_ms": mean["glue"], "swf_wall_ms": mean["wall_ms"], "runs": runs, "L": L_k,
           **pack_formats(pack)}
    if ab and parent_lib() is not None:
        out["parent"] = ab_k5(mk, pack, md, o, d, rng, L_k, phase, label)
        out["parent_ms"] = out["parent"]["parent_ms"]
    if split:
        t_nodes = int(cnt["stats_t"][:, 0].sum(dtype=torch.int64))
        t_prims = int(cnt["stats_t"][:, 1].sum(dtype=torch.int64))
        t_bytes, t_per_lane, t_per_hit = k6_bytes(mk, pack, lanes, cnt["hits"])
        t_bound, t_by = bound(t_bytes, t_nodes, t_prims)
        out["k6"] = {"ms": mean["traverse"], "bound_ms": t_bound, "bound_by": t_by,
                     "wide_nodes": t_nodes, "prim_tests": t_prims, "bytes": t_bytes,
                     "bytes_per_lane": t_per_lane, "g_hit_bytes_per_hit": t_per_hit,
                     "hit_lanes": sum(cnt["hits"]), "staged": mk.k6_stages(pack)}
        log(f"[{phase}] K6 {label} (walk + hit resolve; nodes, prims and g_hit staged: "
            f"{mk.k6_stages(pack)}): "
            f"{mean['traverse']:.3f} ms per spp, bound {t_bound:.4f} ms ({t_by}: {t_nodes} wide "
            f"nodes, {t_prims} prim tests, {t_bytes} bytes: {t_per_lane} B per live lane, "
            f"{t_per_hit} B of g_hit per hit lane over {sum(cnt['hits'])} hits); "
            f"{t_bound / max(mean['traverse'], 1e-9):.4f} of bound")
    return out


def phase_kitchen(mk, dev, args, scene, cam, build_s, MaxDepthParams, RenderingConfig,
                  ParsedScene, Renderer):
    """The surface main path at scale: the Renderer on full-size
    kitchen_stress through the sorted-wavefront driver (K5), and K3 (the
    whole-path kernel, called directly) on the same rays."""
    spp = args.kitchen_spp
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not (info["has_env"] and info["textured"] and info["has_disp"]) or info["driver"] != "swf":
        raise SystemExit(f"kitchen_stress: not the K3 flags or not the swf driver: {info}")
    wall, launches, inst, mean = render_main_path(
        mk, r, spp, "kitchen", {"launches": ["trace_megakernel_seg"],
                                "instantiations": ["SEG+K3+ALL+CPT"]})
    log(f"[6] Renderer kitchen_stress {cam.width}x{cam.height}x{spp}spp ({mk.pack_boxes(r._pack)} "
        f"boxes: driver {info['driver']}): {wall:.2f} s wall ({wall * 1e3 / spp:.2f} ms per spp), "
        f"launches {launches} {inst}, image mean {mean:.6f}, flags {r._pack.flags}, pack "
        f"{pack_formats(r._pack)} (f32 size {mk.fused_pack_bytes(r.scene)} B, the format rule's "
        f"threshold {mk.AUTO_COMPACT_BYTES} B)")
    want = ("w8", "t9", "bf16")
    if (r._pack.node_fmt, r._pack.prim_fmt, r._pack.attr_fmt) != want:
        raise SystemExit(f"kitchen: the Renderer's pack is not in the reference's formats {want}")
    k5 = hold_swf(mk, r, md, BLOCK, "6", "kitchen", ab=True)
    k3 = hold_main_path(mk, r, md, BLOCK, "6", "kitchen",
                        f"incl. {mk.pack_bytes(r._pack, mk.K3_KEYS)} of uvs, texels and K3 tables",
                        ab=True)
    dmean = abs(float(k5.pop("L").mean()) - float(k3.pop("L").mean()))
    log(f"[6] kitchen, one spp: K5 {k5['ms']:.3f} ms (driver wall {k5['swf_wall_ms']:.3f} ms) "
        f"against the whole-path kernel's {k3['ms']:.3f} ms on the same rays; image means "
        f"differ by {dmean:.3g} (inline against deferred texturing: the same estimator in the "
        f"mean only)")
    if dmean > MEAN_TOL:
        raise SystemExit("kitchen: K5 and the whole-path kernel disagree in the mean")
    k5["f32"] = f32_pass(mk, r, md, "6", "kitchen")
    k3["f32_ms"] = k5["f32"]["whole_path_ms"]
    k5.update({"wall_ms_per_spp": wall * 1e3 / spp, "launches": launches["trace_megakernel_seg"],
               "instantiations": inst, "whole_path_ms": k3["ms"], "mean_vs_whole_path": dmean,
               "image_mean": mean})
    return k5, {
        "name": "trace_megakernel (K3: has_env, textured, has_disp; the CPT build: t9 prims, "
                "bf16 attrs; f32_ms: the f32 build of megakernel.cu)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel_cpt.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1445",
        "launches": 0, **k3, "library_ms": None, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims,
        "note": "off the main path since K5 takes scenes of 512 boxes or more; called directly",
    }, r


def hold_main_path(mk, r, md, blk: int, phase: str, label: str, bytes_note: str = "",
                   ab: bool = False) -> dict:
    """The main path's rays of sample 0 through the kernel at the full grid;
    one blk-lane Z-order block of its output (the one holding the image
    centre) held to the phase-4 contract against the plain version on the
    same lanes (lanes are independent); the kernel's time per spp (CUDA
    events) and on the block alone; its walk work and bound; with ab and
    --parent, the parent tree's kernel on the same rays (ab_k2)."""
    pack = r._pack
    o, d, rng, blk_sl = main_rays(mk, r, blk)
    B = o.shape[0]
    ob, db, rb = (x[blk_sl].contiguous() for x in (o, d, rng))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(pack, md, ob, db, rb)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    L_k = mk.trace_megakernel(pack, md, o, d, rng)
    torch.cuda.synchronize()
    if not torch.isfinite(L_k).all():
        raise SystemExit(f"{label} main path rays: non-finite kernel output")
    L_kb = L_k[blk_sl]
    frac, dmean = check_contract(f"{label} main path {B} rays, block of {blk}", L_kb, L_p)
    block_ms = events_ms(lambda: mk.trace_megakernel(pack, md, ob, db, mk.rng_bits(rb)), 5)

    rng_bits = mk.rng_bits(rng)
    k_ms = events_ms(lambda: mk.trace_megakernel(pack, md, o, d, rng_bits), 5)
    _, stats = mk.trace_megakernel(pack, md, o, d, rng, count_stats=True)
    torch.cuda.synchronize()
    bound_ms, bound_by, nodes, prims, nbytes = bound_of(stats, B, mk.pack_bytes(pack),
                                                        slabs_per_node(pack))
    log(f"[{phase}] kernel {k_ms:.3f} ms/spp, {B / (k_ms * 1e-3):.4g} paths/s; block of {blk} "
        f"lanes of the {B}-ray launch vs the plain version ({plain_ms:.1f} ms on the block): "
        f"{frac:.7f} lanes differ, means differ by {dmean:.3g}; the kernel launched on the "
        f"block alone {block_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: {nodes} "
        f"{node_word(pack)}, {prims} prim tests, {nbytes} bytes {bytes_note}); "
        f"{bound_ms / k_ms:.4f} of bound; pack formats {pack_formats(pack)}")
    out = {"L": L_k, "max_abs_err": float((L_kb - L_p).abs().max()), "ms": k_ms,
           "plain_ms": plain_ms,
           "plain_lanes": blk, "block_kernel_ms": block_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "paths_per_s": B / (k_ms * 1e-3), "lanes_differ": frac,
           "mean_differ": dmean, "wide_nodes": nodes, "prim_tests": prims,
           **pack_formats(pack)}
    if ab and parent_lib() is not None:
        out["parent"] = ab_k2(mk, pack, md, o, d, rng, phase, label)
        out["parent_ms"] = out["parent"]["parent_ms"]
    return out


def pack_formats(pack) -> dict:
    """The pack's table formats and its bytes (the tables the kernels read)."""
    from cuda_pt_torch.ops import megakernel as mk

    return {"node_fmt": pack.node_fmt, "prim_fmt": pack.prim_fmt, "attr_fmt": pack.attr_fmt,
            "pack_bytes": mk.pack_bytes(pack)}


def f32_pass(mk, r, md, phase: str, label: str) -> dict:
    """The Renderer's scene packed with f32 attrs and prims (w8 nodes, as the
    Renderer packs below the format rule's threshold), on the main path's
    rays of sample 0: K5's time per spp (swf_loop, mean of 3 runs), the
    whole-path kernel's (CUDA events), and the gap of K5's image mean to
    that of the Renderer's pack (bf16 attrs, t9 prims) on the same rays."""
    pack = r._pack
    pf = mk.make_pack(r.scene, node_fmt="w8", attr_fmt="f32", prim_fmt="f32",
                      vpt=pack.has_media)
    o, d, rng, _ = main_rays(mk, r, BLOCK)
    runs = [swf_loop(mk, pf, md, o, d, rng, timing=True) for _ in range(3)]
    seg_ms = float(np.mean([run["ms"]["seg"] for run in runs]))
    L_b = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
    gap = abs(float(runs[0]["L"].mean()) - float(L_b.mean()))
    rng_bits = mk.rng_bits(rng)
    wp_ms = events_ms(lambda: mk.trace_megakernel(pf, md, o, d, rng_bits), 5)
    bin_bytes = mk.pack_bytes(mk.make_pack(r.scene, vpt=pack.has_media))
    log(f"[{phase}] {label}, f32 attrs and prims ({mk.pack_bytes(pf)} bytes against "
        f"{mk.pack_bytes(pack)} in {pack.attr_fmt} attrs, {pack.prim_fmt} prims; "
        f"make_pack(scene), binary nodes: {bin_bytes}): K5 "
        f"{seg_ms:.3f} ms per spp, the whole-path kernel {wp_ms:.3f} ms; image means (K5, one "
        f"spp) f32 {float(runs[0]['L'].mean()):.6f}, {pack.attr_fmt} attrs "
        f"{float(L_b.mean()):.6f}: gap {gap:.3g}")
    if gap > MEAN_TOL:
        raise SystemExit(f"{label}: f32 and {pack.attr_fmt} attrs disagree in the mean by {gap}")
    return {"k5_ms": seg_ms, "whole_path_ms": wp_ms, "mean_gap_vs_compact": gap,
            "pack_bytes": mk.pack_bytes(pf), "binary_pack_bytes": bin_bytes}


def phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
              Renderer):
    """The volume path tracer's main path: the Renderer on full-size
    medium_cbox through the driver (K5), held to its plain version and to
    K4 (the whole-path kernel, called directly) lane for lane; K4 held to
    its plain version."""
    t0 = time.perf_counter()
    scene, cam, _ = tts.medium_cbox(1024, 1024, device=dev)
    build_s = time.perf_counter() - t0
    spp = VPT_SPP
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if not info["has_media"] or info["driver"] != "swf":
        raise SystemExit(f"medium_cbox: no media in the pack or not the swf driver: {info}")
    want = ("w8", "t9", "bf16")
    if (r._pack.node_fmt, r._pack.prim_fmt, r._pack.attr_fmt) != want:
        raise SystemExit(f"medium_cbox: the Renderer's pack is not in the reference's formats "
                         f"{want}")
    wall, launches, inst, mean = render_main_path(
        mk, r, spp, "VPT", {"launches": ["trace_megakernel_seg"],
                            "instantiations": ["SEG+ALL+MED+CPT"]})
    log(f"[7] medium_cbox ({scene.geom.num_prims} triangles, BVH built in {build_s:.1f} s; "
        f"{r._pack['nodes'].shape[0]} wide nodes, walk stack {r._pack.max_stack}, max leaf "
        f"{r._pack.max_leaf}): Renderer VOLUME_PT {cam.width}x{cam.height}x{spp}spp: "
        f"{wall:.2f} s wall ({wall * 1e3 / spp:.2f} ms per spp), launches {launches} {inst} "
        f"({launches['trace_megakernel_seg'] / spp:g} per spp), image mean {mean:.6f}, pack "
        f"{pack_formats(r._pack)} (f32 size {mk.fused_pack_bytes(r.scene)} B)")
    k5 = hold_swf(mk, r, md, BLOCK, "7", "medium_cbox", ab=True)
    k4 = hold_main_path(mk, r, md, BLOCK, "7", "VPT",
                        f"incl. {mk.pack_bytes(r._pack, mk.MED_KEYS)} of the media row; the "
                        f"walk work incl. the transmittance walks", ab=True)
    L_w, L_s = k4.pop("L"), k5.pop("L")
    frac_w, dmean_w = check_contract("medium_cbox, K5 vs the whole-path kernel K4", L_s, L_w)
    log(f"[7] medium_cbox, one spp: K5 {k5['ms']:.3f} ms (driver wall {k5['swf_wall_ms']:.3f} ms) "
        f"against K4's {k4['ms']:.3f} ms on the same rays; per lane {frac_w:.7f} differ, "
        f"{int((L_s != L_w).any(dim=-1).sum())} not bit-equal, means differ by {dmean_w:.3g}")
    k5.update({"wall_ms_per_spp": wall * 1e3 / spp, "launches": launches["trace_megakernel_seg"],
               "instantiations": inst, "whole_path_ms": k4["ms"],
               "lanes_differ_vs_whole_path": frac_w, "f32": f32_pass(mk, r, md, "7", "medium_cbox")})
    k4["f32_ms"] = k5["f32"]["whole_path_ms"]
    return k5, {
        "name": "trace_megakernel (K4: has_media; the CPT build: t9 prims, bf16 attrs; f32_ms: "
                "the f32 build of megakernel_med.cu)", "route": "cuda",
        "source": "cuda_pt_torch/csrc/megakernel_cpt.cu",
        "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:1386",
        "launches": 0, **k4, "library_ms": None, "bvh_build_s": build_s,
        "num_prims": scene.geom.num_prims,
        "note": "off the main path since K5 takes scenes of 512 boxes or more; called directly",
    }, r


def phase_grid(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
               Renderer):
    """Grid media: the Renderer on grid_smoke (a 256^3 density grid) through
    the split driver, K6 and K5's shade phase, held to the plain versions."""
    t0 = time.perf_counter()
    scene, cam, _ = tts.grid_smoke(1024, 1024, n=GRID_N, device=dev)
    build_s = time.perf_counter() - t0
    md = MaxDepthParams()
    parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                     seed=0))
    r = Renderer(parsed, renderer=RendererType.VOLUME_PT, nee_candidates=1)  # device=None -> cuda
    info = r.info()
    if info["driver"] != "swf_split" or not info["has_grid"]:
        raise SystemExit(f"grid_smoke: not the split driver: {info}")
    wall, launches, inst, mean = render_main_path(
        mk, r, GRID_SPP, "grid", {"launches": ["trace_megakernel_seg", "traverse_resolve"],
                                  "instantiations": ["SEG+SHADE+ALL+MED+GRID"]})
    grid_mib = r._pack["gr_density"].numel() * 4 / 2 ** 20
    log(f"[8] grid_smoke (a {GRID_N}^3 density grid, {grid_mib:.0f} MiB; scene built in "
        f"{build_s:.1f} s): Renderer VOLUME_PT {cam.width}x{cam.height}x{GRID_SPP}spp: "
        f"{wall:.2f} s wall ({wall * 1e3 / GRID_SPP:.2f} ms per spp), launches {launches} {inst}, "
        f"image mean {mean:.6f}")
    pack = r._pack
    o, d, rng, _ = main_rays(mk, r, BLOCK)
    o, d = o.contiguous(), d.contiguous()
    B = o.shape[0]
    k6_check = check_k6(mk, pack, k6_state(mk, pack, o, d), B, "grid_smoke camera rays")
    o_b, d_b = o[:BLOCK].contiguous(), d[:BLOCK].contiguous()
    st = k6_state(mk, pack, o_b, d_b)
    k6_block_check = check_k6(mk, pack, st, BLOCK, "grid_smoke camera rays, the first block")
    k5 = hold_swf(mk, r, md, BLOCK, "8", "grid_smoke")
    L = k5.pop("L")
    k6 = k5.pop("k6")
    ab = ab_k6(mk, pack, md, o, d, rng, L)
    _, k6_plain = host_ms(lambda: mk.resolve_hit(pack, mk.traverse_plain(pack, st, BLOCK)))
    k6_block = events_ms(lambda: mk.traverse_resolve(pack, st, BLOCK), 10)
    k5.update({"wall_ms_per_spp": wall * 1e3 / GRID_SPP,
               "launches": launches["trace_megakernel_seg"], "instantiations": inst})
    k6.update({"launches": launches["traverse_resolve"], "plain_ms": k6_plain,
               "plain_lanes": BLOCK, "block_kernel_ms": k6_block, "walk_check": k6_check,
               "block_check": k6_block_check,
               "max_abs_err": max(k6_check["max_abs_err_t"], k6_check["planes_max_abs_err"]),
               "ab": ab, **({"parent_ms": ab["parent"]["parent_ms"]} if "parent" in ab else {})})
    log(f"[8] K6 on the {BLOCK}-lane block: kernel {k6_block:.4f} ms, plain walk and "
        f"resolve_hit {k6_plain:.1f} ms")
    return k5, k6


def split_states(mk, pack, md, o, d, rng) -> list:
    """The split driver's loop on the kernels (key "pos_dir"): each bounce's
    live state planes (n_state, n) as its K6 step reads them."""
    st = mk.seg_init(pack, o, d, rng)
    pix = torch.arange(o.shape[0], device=o.device)
    states = []
    for bounce in range(md.max_depth):
        st, pix, n = mk.swf_sort(st, pix, "pos_dir")
        if n == 0:
            break
        states.append(st[:, :n].contiguous())
        hit = mk.traverse_resolve(pack, st, n)
        flight = mk.grid_flight(pack, st, n, hit[0]).contiguous()
        mk.trace_megakernel_seg(pack, md, st, n, bounce, 1, hit, flight)
        mk.swf_resolve(pack, st, n)
    torch.cuda.synchronize()
    return states


def k6_spp_ms(mk, pack, states: list) -> float:
    """Summed device ms of the split step mk.traverse_resolve (this tree's
    K6, or under parent_split the parent's K6 and resolve_hit) over the
    recorded bounces, each after a device sleep of SETTLE_CYCLES, between
    CUDA events: the median of 3 passes."""
    passes = []
    for _ in range(3):
        evs = []
        for st in states:
            torch.cuda._sleep(SETTLE_CYCLES)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            mk.traverse_resolve(pack, st, st.shape[1])
            ev[1].record()
            evs.append(ev)
        torch.cuda.synchronize()
        passes.append(sum(a.elapsed_time(b) for a, b in evs))
    return float(np.median(passes))


def ab_k6(mk, pack, md, o, d, rng, L) -> dict:
    """K6 per spp on one spp's recorded split states (split_states): the
    kernel with its tables staged against the same launches with the table
    sizes withheld (no_stage), in turns, hit planes bit-equal; the device
    launches of the split steps over the spp (profiler); with --parent,
    the parent's split step (its K6 walk, then resolve_hit in PyTorch:
    parent_split) on the same states, hit planes bit-equal on every lane,
    the driver's L bit-equal to this tree's L, the device launches of its
    split steps and of a whole driver pass of each tree (about 300,000,
    minutes under the profiler: --parent only), and the ms per spp and the
    driver's wall per spp in turns (parent, this, this, parent)."""
    states = split_states(mk, pack, md, o, d, rng)
    hits = [mk.traverse_resolve(pack, st, st.shape[1]) for st in states]
    with no_stage(mk):
        differ_stage = sum(bit_lanes(h.T, mk.traverse_resolve(pack, st, st.shape[1]).T)
                           for h, st in zip(hits, states))
    ms = {"stage": [], "plain": []}
    for who in ("stage", "plain", "plain", "stage"):
        if who == "plain":
            with no_stage(mk):
                ms[who].append(k6_spp_ms(mk, pack, states))
        else:
            ms[who].append(k6_spp_ms(mk, pack, states))

    def driver():
        mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")

    def split_steps():
        for st in states:
            mk.traverse_resolve(pack, st, st.shape[1])

    row = {"live_lanes": [st.shape[1] for st in states], "stage_ms": float(np.mean(ms["stage"])),
           "unstaged_ms": float(np.mean(ms["plain"])), "stage_runs_ms": ms,
           "stage_lanes_differ": differ_stage, "staged": mk.k6_stages(pack),
           "device_launches_per_spp": {"this": device_launches(split_steps)}}
    log(f"[8] K6 per spp on the recorded split states (live lanes {row['live_lanes']}): nodes, "
        f"prims and g_hit staged ({row['staged']}) {row['stage_ms']:.4f} ms against {row['unstaged_ms']:.4f} ms "
        f"left in device memory, in turns (runs {ms}); lanes differing {differ_stage}")
    if differ_stage:
        raise SystemExit("K6: the staged build's planes differ from the unstaged build's")
    if parent_lib() is not None:
        with parent_split(mk):
            p_hits = [mk.traverse_resolve(pack, st, st.shape[1]) for st in states]
            L_p = mk.trace_megakernel_swf(pack, md, o, d, rng, key_mode="pos_dir")
            torch.cuda.synchronize()
            row["device_launches_per_spp"]["parent"] = device_launches(split_steps)
            row["device_launches_per_pass"] = {"parent": device_launches(driver)}
        row["device_launches_per_pass"]["this"] = device_launches(driver)
        planes_differ = sum(bit_lanes(h.T, p.T) for h, p in zip(hits, p_hits))
        l_differ = bit_lanes(L, L_p)
        runs = {"parent": [], "this": []}
        walls = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent"):
            with parent_split(mk) if who == "parent" else contextlib.nullcontext():
                runs[who].append(k6_spp_ms(mk, pack, states))
                walls[who].append(host_ms(driver)[1])
        row["parent"] = {"parent_ms": float(np.mean(runs["parent"])),
                         "this_ms": float(np.mean(runs["this"])), "runs_ms": runs,
                         "driver_wall_ms": walls, "planes_lanes_differ": planes_differ,
                         "L_lanes_differ": l_differ}
        log(f"[8] K6 + resolve per spp: the parent's walk and resolve_hit "
            f"{row['parent']['parent_ms']:.4f} ms against this tree's "
            f"{row['parent']['this_ms']:.4f} ms, in turns on the same states (runs {runs}); the "
            f"split driver's wall per spp (host clock, 1,048,576 rays) in the same turns {walls}; "
            f"hit planes differing {planes_differ}, driver L differing {l_differ} of "
            f"{L.shape[0]}")
        if planes_differ or l_differ:
            raise SystemExit("K6: this tree's split step differs from the parent's")
    log(f"[8] device launches of the split step (K6, the parent's K6 and resolve_hit) per spp: "
        f"{row['device_launches_per_spp']}; per split driver pass (1,048,576 rays, with "
        f"--parent): {row.get('device_launches_per_pass')}")
    return row


def _forest_job(geom, fmt: str):
    """Build kernel K1's forest of geom (CPU tensors) in a worker process;
    returns (forest, seconds)."""
    from cuda_pt_torch.ops import traverse_kernel as tk

    t0 = time.perf_counter()
    forest = tk.build_forest(geom, chunk_prims=FOREST_CHUNK, node_fmt=fmt)
    return forest, time.perf_counter() - t0


def k1_ray_bytes(t_far_given: bool, occlusion: bool) -> int:
    """Bytes one ray moves through K1: o and d read (24 B), t_far read only
    where the caller passes it (4 B), t/prim/b1/b2 written (16 B) or the
    occlusion flag (4 B)."""
    return 24 + (4 if t_far_given else 0) + (4 if occlusion else 16)


def k1_bound(forest, ray_bytes: int, nodes: int, prims: int) -> tuple:
    """(bound ms, what bounds it, bytes) of K1 over one launch or several:
    ray_bytes the rays' reads and writes in all (k1_ray_bytes), the forest
    read once; ops nodes x 22 + prim tests x 45."""
    nbytes = ray_bytes + (forest.nodes.numel() + forest.prims.numel()) * 4
    t_b, t_o = nbytes / PEAK_BYTES_S, (nodes * OPS_SLAB + prims * OPS_TRI) / PEAK_F32_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b > t_o else "operations", nbytes


def hold_k1(tk, forest, o, d, t_far, label: str) -> dict:
    """K1 against its plain version on rays (B, 3), closest and any hit:
    prim ids and occlusion equal, t, b1, b2 within the phase-4 tolerances.
    Returns the counts, the largest t error and the plain closest hit."""
    k = tk.traverse_forest(forest, o, d)
    occ = tk.traverse_forest(forest, o, d, t_far, occlusion=True)["occluded"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tk.traverse_forest_reference(forest, o, d)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    p_occ = tk.traverse_forest_reference(forest, o, d, t_far, occlusion=True)["occluded"]
    differ = int((k["prim"] != p["prim"]).sum())
    occ_differ = int((occ != p_occ).sum())
    h = p["hit"] & k["hit"]
    errs = [float((k[key][h] - p[key][h]).abs().max()) if bool(h.any()) else 0.0
            for key in ("t", "b1", "b2")]
    close = all(torch.allclose(k[key][h], p[key][h], rtol=RTOL, atol=ATOL)
                for key in ("t", "b1", "b2"))
    log(f"[9] K1 {label}, {o.shape[0]} rays: {differ} prim ids differ, {occ_differ} occlusion "
        f"flags differ; hits {float(p['hit'].float().mean()):.4f}, occluded "
        f"{float(p_occ.float().mean()):.4f}; max |err| t {errs[0]:.3g} b1 {errs[1]:.3g} "
        f"b2 {errs[2]:.3g}; plain closest walk {plain_ms:.1f} ms")
    if differ or occ_differ or not close:
        raise SystemExit(f"K1 check failed on {label}: {differ} prim ids, {occ_differ} "
                         f"occlusion flags differ, t/b1/b2 within tolerance: {close}")
    return {"rays": o.shape[0], "prim_differ": differ, "occluded_differ": occ_differ,
            "max_abs_err_t": errs[0], "max_abs_err_b": max(errs[1:]), "plain_ms": plain_ms,
            "hit_frac": float(p["hit"].float().mean()),
            "occluded_frac": float(p_occ.float().mean()), "prim": k["prim"], "t": p["t"]}


def check_sorted_walk(mk, pack, scene, o, d, k1_prim) -> dict:
    """The sorted-lane walk alone (closest_hit_sorted) on the Renderer's
    kitchen pack against K1 on the same camera rays: prim ids
    equal but on exact ties (both prims hit at one t); against the w8 walk
    (closest_hit_w8, the same visit order): t and prim ids bit-equal; the
    most entries each ray's stack held (the share beyond the SW_SS entries
    kept in shared memory), and the two walks' times (CUDA events)."""
    from cuda_pt_torch.ops import intersect as isect

    t_s, prim_s, _, _, depth = mk.closest_hit_sorted(pack, o, d)
    t_w, prim_w, _, _ = mk.closest_hit_w8(pack, o, d)
    torch.cuda.synchronize()
    differ = prim_s != k1_prim
    # an exact tie: both prims hit at one t, each intersected by the plain
    # arithmetic (ops/intersect)
    idx = torch.nonzero(differ & (prim_s >= 0) & (k1_prim >= 0))[:, 0]
    t_of, hit_of, _, _ = isect.intersect_gather(
        scene.geom, o[idx], d[idx], torch.stack([prim_s[idx], k1_prim[idx]], 1),
        torch.ones((idx.numel(), 2), dtype=torch.bool, device=o.device))
    ties = int((hit_of.all(dim=1) & (t_of[:, 0] == t_of[:, 1])).sum())
    bad = int(differ.sum()) - ties
    vs_w8 = int((prim_s != prim_w).sum()) + bit_differ(t_s, t_w)
    dep = depth.float()
    ss = 16  # SW_SS, csrc/walk.cuh
    ms_s = events_ms(lambda: mk.closest_hit_sorted(pack, o, d), 10)
    ms_w = events_ms(lambda: mk.closest_hit_w8(pack, o, d), 10)
    out = {"rays": o.shape[0], "differ_k1": int(differ.sum()), "exact_ties": ties,
           "differ_w8_walk": vs_w8, "depth_max": int(depth.max()),
           "depth_mean": float(dep.mean()), "depth_over_shared": float((depth > ss).float().mean()),
           "ms": ms_s, "w8_walk_ms": ms_w, "hits": int((prim_s >= 0).sum())}
    log(f"[9] the sorted-lane walk against K1 on the {o.shape[0]} kitchen camera rays "
        f"(pack {pack_formats(pack)}): {out['differ_k1']} prim ids differ, {ties} on exact ties, "
        f"{bad} otherwise; against the w8 walk {vs_w8} prim ids or t differ; stack depth max "
        f"{out['depth_max']}, mean {out['depth_mean']:.2f}, {out['depth_over_shared']:.5f} of "
        f"rays beyond the {ss} shared entries; walk alone {ms_s:.4f} ms, the w8 walk {ms_w:.4f} ms")
    if bad or vs_w8:
        raise SystemExit(f"sorted-lane walk check failed: {out}")
    return out


def phase_k1(tk, tts, dev, kscene, kcam, forests: dict, T, mk=None, kpack=None) -> dict:
    """Kernel K1 on full-size kitchen_stress forests (f32 and bf16 rows,
    forest_chunk 65536) and on cornell's single-chunk forest, against its
    plain version; the packet form's tile_iters; K1's time per 1M rays;
    with mk and kpack (the Renderer's kitchen pack), the sorted-lane walk
    against K1 on the camera rays (check_sorted_walk)."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    f32, bf16 = forests["f32"], forests["bf16"]
    W, H = kcam.width, kcam.height
    lane = torch.arange(W * H, device=dev)
    o, d, _ = cam_mod.generate_rays(kcam, lane, qmc.make_state("pcg", 0, lane, 0))
    o, d = o.contiguous(), d.contiguous()
    rs = np.random.default_rng(13)
    # camera rays' shadow limits: half to one and a half times the plain
    # closest t (1e8 on a miss), so about half the hits are occluded
    t_cam = tk.traverse_forest_reference(f32, o, d)["t"]
    u = torch.as_tensor(rs.uniform(0.5, 1.5, W * H).astype(np.float32), device=dev)
    tf_cam = torch.where(torch.isfinite(t_cam), t_cam * u, 1e8).contiguous()
    lo = kscene.bvh.node_min[0].cpu().numpy()
    hi = kscene.bvh.node_max[0].cpu().numpy()
    n_r = BLOCK
    o_r = torch.as_tensor(rs.uniform(lo, hi, (n_r, 3)).astype(np.float32), device=dev)
    d_r = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_r, 3)).astype(np.float32), device=dev), dim=1).contiguous()
    tf_r = torch.as_tensor(rs.uniform(0.05, 8.0, n_r).astype(np.float32), device=dev)
    res = {"forest": {fmt: {"nodes": list(f.nodes.shape), "prims": list(f.prims.shape),
                            "n_nodes": f.n_nodes.tolist()} for fmt, f in forests.items()}}
    prims = {}
    for fmt, forest in (("f32", f32), ("bf16", bf16)):
        for rays, (o_, d_, tf_) in (("camera", (o, d, tf_cam)), ("random", (o_r, d_r, tf_r))):
            row = hold_k1(tk, forest, o_, d_, tf_, f"kitchen {fmt} forest, {rays} rays")
            prims[(fmt, rays)] = row.pop("prim")
            row.pop("t")
            res[f"{fmt}_{rays}"] = row
    if mk is not None:
        res["sorted_walk"] = check_sorted_walk(mk, kpack, kscene, o, d, prims[("f32", "camera")])
    for rays in ("camera", "random"):
        bf_differ = int((prims[("bf16", rays)] != prims[("f32", rays)]).sum())
        log(f"[9] bf16 against f32 rows, {rays} rays: {bf_differ} prim ids differ")
        if bf_differ:
            raise SystemExit(f"K1: the bf16 forest's prim ids differ from the f32 forest's "
                             f"on {bf_differ} {rays} rays")
    cscene, _, _ = tts.cornell_box(device=dev)
    cforest = tk.single_chunk_forest(cscene.geom, cscene.bvh)
    o_c = torch.as_tensor(rs.uniform(0.05, 0.95, (n_r, 3)).astype(np.float32), device=dev)
    d_c = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_r, 3)).astype(np.float32), device=dev), dim=1).contiguous()
    tf_c = torch.as_tensor(rs.uniform(0.05, 1.5, n_r).astype(np.float32), device=dev)
    row = hold_k1(tk, cforest, o_c, d_c, tf_c, "cornell single-chunk forest, random rays")
    row.pop("prim"), row.pop("t")
    res["cornell_random"] = row
    # the packet form on PACKET_RAYS camera rays around the image centre
    c0 = (H // 2) * W - PACKET_RAYS // 2
    sl = slice(c0, c0 + PACKET_RAYS)
    k = tk.traverse_forest(f32, o[sl], d[sl], count_iters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = tk.traverse_forest_reference(f32, o[sl], d[sl], count_iters=True)
    torch.cuda.synchronize()
    packet_plain_ms = (time.perf_counter() - t0) * 1e3
    same = torch.equal(k["tile_iters"], p["tile_iters"]) and torch.equal(k["prim"], p["prim"]) \
        and torch.equal(k["prim"], prims[("f32", "camera")][sl])
    iters = k["tile_iters"].long()
    log(f"[9] K1 packet form, {PACKET_RAYS} camera rays in tiles of {tk.TILE}: tile_iters and "
        f"prim ids equal to the plain packet walk and to the per-ray form: {same}; node "
        f"fetches per tile {int(iters.min())}-{int(iters.max())} (mean {float(iters.float().mean()):.0f}) "
        f"against {int(f32.nodes.shape[0] * f32.nodes.shape[1] * tk.SLOTS)} padded slots; "
        f"plain {packet_plain_ms:.0f} ms")
    if not same:
        raise SystemExit("K1 packet form: tile_iters or prim ids differ from the plain version")
    res["packet"] = {"rays": PACKET_RAYS, "tile": tk.TILE, "tile_iters_mean": float(
        iters.float().mean()), "plain_ms": packet_plain_ms}
    # time per 1M camera rays, closest and any hit, f32 and bf16 rows; the
    # walk work by stats
    B = o.shape[0]
    timing = {}
    for fmt, forest in (("f32", f32), ("bf16", bf16)):
        for mode, occl in (("closest", False), ("anyhit", True)):
            tf_ = tf_cam if occl else None
            ms = events_ms(lambda: tk.traverse_forest(forest, o, d, tf_, occlusion=occl), 10)
            st = torch.zeros((B, 2), dtype=torch.int32, device=dev)
            tk.traverse_forest(forest, o, d, tf_, occlusion=occl, stats=st)
            nodes = int(st[:, 0].sum(dtype=torch.int64))
            prim_tests = int(st[:, 1].sum(dtype=torch.int64))
            ray_b = B * k1_ray_bytes(tf_ is not None, occl)
            bound_ms, bound_by, nbytes = k1_bound(forest, ray_b, nodes, prim_tests)
            key = mode if fmt == "f32" else f"{mode}_bf16"
            timing[key] = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                           "nodes": nodes, "prim_tests": prim_tests, "bytes": nbytes,
                           "warps": warp_figures(st)}
            log_warp_figures("9", f"K1 {mode}, camera rays, {fmt} forest", timing[key]["warps"])
            log(f"[9] K1 {mode}, {B} camera rays, {fmt} forest: {ms:.4f} ms "
                f"({B / (ms * 1e-3):.4g} rays/s); bound {bound_ms:.4f} ms ({bound_by}: {nodes} "
                f"node fetches, {prim_tests} prim tests, {nbytes} bytes of which "
                f"{nbytes - ray_b} forest); {bound_ms / ms:.4f} of bound")
    res["timing"] = timing
    if parent_lib() is not None:
        res["parent"] = ab_k1(tk, f32, o, d, tf_cam, "9", f"{B} camera rays, f32 forest")
    return res


@contextlib.contextmanager
def plain_walk(tk):
    """K1's wrapper swapped for its plain version while the block runs, so
    the same path code walks without the kernel."""
    real = tk.traverse_forest
    tk.traverse_forest = (lambda forest, o, d, t_far=None, max_leaf=4, occlusion=False, **_:
                          tk.traverse_forest_reference(forest, o, d, t_far, max_leaf, occlusion))
    try:
        yield
    finally:
        tk.traverse_forest = real


@contextlib.contextmanager
def k1_calls(tk, timing: bool = False, count: bool = False, record: bool = False):
    """Each K1 call of the block recorded: its lanes, the bytes its rays
    move (k1_ray_bytes), and
    with timing its device time (CUDA events, the kernel started after a
    device sleep that covers the host's launch latency), with count its
    walk work (a stats plane), with record its inputs ("args": forest, o,
    d, t_far, occlusion, max_leaf, copied) for replay_k1."""
    real = tk.traverse_forest
    calls = []

    def wrapped(forest, o, d, t_far=None, max_leaf=4, occlusion=False, **kw):
        row = {"lanes": o.shape[0], "bytes": o.shape[0] * k1_ray_bytes(t_far is not None,
                                                                       occlusion)}
        if record:
            row["args"] = (forest, o.clone(), d.clone(),
                           None if t_far is None else t_far.clone(), occlusion, max_leaf)
        if count:
            kw["stats"] = torch.zeros((o.shape[0], 2), dtype=torch.int32, device=o.device)
        if timing:
            torch.cuda._sleep(SETTLE_CYCLES)
            row["ev"] = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            row["ev"][0].record()
        out = real(forest, o, d, t_far, max_leaf, occlusion, **kw)
        if timing:
            row["ev"][1].record()
        if count:
            row["stats"] = kw["stats"]
        calls.append(row)
        return out

    tk.traverse_forest = wrapped
    try:
        yield calls
    finally:
        tk.traverse_forest = real
        torch.cuda.synchronize()


def k1_main_path(tk, forest, run, phase: str, label: str) -> dict:
    """K1 over the calls of run() (a pass of a composed main path on
    forest), run once timed and once counted (k1_calls): the summed device
    time, the walk work, the bound and its share, the per-group figures,
    and the counted calls (recorded, for ab_k1_calls)."""
    with k1_calls(tk, timing=True) as timed:
        run()
    with k1_calls(tk, count=True, record=True) as counted:
        run()
    timed = [c for c in timed if c["lanes"]]  # a call on no live lane launches nothing
    counted = [c for c in counted if c["lanes"]]
    k1_ms = sum(c["ev"][0].elapsed_time(c["ev"][1]) for c in timed)
    nodes = sum(int(c["stats"][:, 0].sum(dtype=torch.int64)) for c in counted)
    prim_tests = sum(int(c["stats"][:, 1].sum(dtype=torch.int64)) for c in counted)
    lanes = [c["lanes"] for c in counted]
    bound_ms, bound_by, nbytes = k1_bound(forest, sum(c["bytes"] for c in counted), nodes,
                                          prim_tests)
    log(f"[{phase}] K1 on the main path, {label}: {len(timed)} launches (lanes {lanes}), "
        f"{k1_ms:.3f} ms summed; bound {bound_ms:.4f} ms ({bound_by}: {nodes} node fetches, "
        f"{prim_tests} prim tests, {nbytes} bytes); {bound_ms / k1_ms:.4f} of bound")
    figs = [warp_figures(c["stats"]) for c in counted]
    mx, mean = sum(f["warp_max_sum"] for f in figs), sum(f["warp_mean_sum"] for f in figs)
    n_w = sum(f["warps"] for f in figs)
    warps = {"warp_max_sum": mx, "warp_mean_sum": mean, "warps": n_w, "warp_max": mx / n_w,
             "warp_mean": mean / n_w, "lane_use": mean / mx}
    log_warp_figures(phase, f"K1 over the {len(counted)} calls of {label}", warps)
    return {"ms": k1_ms, "bound_ms": bound_ms, "bound_by": bound_by, "nodes": nodes,
            "prim_tests": prim_tests, "bytes": nbytes, "lanes": lanes, "launches": len(timed),
            "warps": warps, "calls": counted}


def phase_wavefront(mk, tk, dev, kscene, kcam, f32, k5_mean: float, MaxDepthParams,
                    RendererType, RenderingConfig, ParsedScene, Renderer):
    """The wavefront path tracer's main path: the Renderer with
    WAVEFRONT_PT and traversal "pallas" on full-size kitchen_stress with
    its two-chunk f32 forest (K1 for every closest and shadow walk, no
    other kernel); a 65,536-lane Z-order block of one pass's rays through
    the wavefront loop on K1 and on its plain version; K1's time and walk
    work per spp on the main path."""
    import dataclasses

    from cuda_pt_torch.core import qmc
    from cuda_pt_torch.models import path_tracer as pt
    from cuda_pt_torch.models import wavefront

    md = MaxDepthParams()
    scene = dataclasses.replace(kscene, forest=f32)
    parsed = ParsedScene(scene, kcam, RenderingConfig(width=kcam.width, height=kcam.height,
                                                      md=md, seed=0))
    r = Renderer(parsed, renderer=RendererType.WAVEFRONT_PT, traversal="pallas")
    info = r.info()
    if (info["driver"], info["traversal"]) != ("composed", "pallas"):
        raise SystemExit(f"wavefront: not the composed route on K1: {info}")
    wall, launches, _, mean = render_main_path(
        mk, r, WF_SPP, "wavefront", {"launches": ["traverse_forest"], "instantiations": []})
    n_launch = launches["traverse_forest"]
    if n_launch > 2 * md.max_depth * WF_SPP:
        raise SystemExit(f"wavefront: {n_launch} K1 launches, more than two per bounce")
    log(f"[10] Renderer WAVEFRONT_PT traversal=pallas, kitchen_stress {kcam.width}x{kcam.height}"
        f"x{WF_SPP}spp (forest {list(f32.nodes.shape)}): {wall:.2f} s wall "
        f"({wall * 1e3 / WF_SPP:.2f} ms per spp), launches {launches}, image mean {mean:.6f} "
        f"(phase 6, K5 route: {k5_mean:.6f}; textured: the estimators agree in the mean only)")
    # K1 over the main path's first spp (wavefront.render_sample, the
    # Renderer's pass), once timed and once counted
    k1_run = k1_main_path(tk, f32, lambda: wavefront.render_sample(r.scene, r.camera, md, 0, 0,
                                                                   compact=True),
                          "10", "one wavefront spp")
    ab = ab_k1_calls(tk, k1_run["calls"], "10", "one wavefront spp") \
        if parent_lib() is not None else None
    # the block: the wavefront loop on K1 and on its plain version
    o, d, rng, sl = main_rays(mk, r, BLOCK)
    perm, _ = mk.tile_swizzle(kcam.width, kcam.height, dev)
    ob, db, rb = (x[sl].contiguous() for x in (o, d, rng))
    wl = pt.wl_stratum_u(0, 0, perm[sl])

    def run():
        L, pix = wavefront.trace_paths_wavefront(r.scene, md, ob, db, rb, compact=True, wl_u=wl)
        return torch.zeros_like(L).index_add_(0, pix, L)

    L_k = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with plain_walk(tk):
        L_p = run()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    frac, dmean = check_contract("wavefront block, K1 against its plain version", L_k, L_p)
    log(f"[10] wavefront loop on a {BLOCK}-lane Z-order block: K1 against its plain walk "
        f"{frac:.7f} lanes differ, {int((L_k != L_p).any(dim=-1).sum())} not bit-equal, means "
        f"differ by {dmean:.3g}; the loop on the plain walk {plain_ms:.0f} ms")
    return {"launches": n_launch, "main_path_ms_per_spp": k1_run["ms"],
            "main_path_bound_ms": k1_run["bound_ms"], "main_path_bound_by": k1_run["bound_by"],
            "main_path_nodes": k1_run["nodes"], "main_path_prim_tests": k1_run["prim_tests"],
            "main_path_lanes": k1_run["lanes"], "main_path_warps": k1_run["warps"],
            **({"main_path_parent": ab, "main_path_parent_ms": ab["parent_ms"]} if ab else {}),
            "wall_ms_per_spp": wall * 1e3 / WF_SPP, "image_mean": mean,
            "k5_route_mean": k5_mean, "block_lanes_differ": frac, "block_mean_differ": dmean,
            "block_max_abs_err": float((L_k - L_p).abs().max()),
            "block_plain_loop_ms": plain_ms}, r


def _shrunk(cam, size: int):
    """The camera at size x size: the focal length scales with the width
    (by a power of two here, so exactly)."""
    import dataclasses

    return dataclasses.replace(cam, width=size, height=size,
                               focal=cam.focal * (size / cam.width))


def phase_routes(mk, tk, tts, dev, vscene, vcam, MaxDepthParams, RendererType, RenderingConfig,
                 ParsedScene, Renderer) -> dict:
    """Phase 4's hold for the composed routes: the Renderer with traversal
    "pallas" (K1) against the same Renderer with "xla" (the plain skip
    walk), SMALL x SMALL, one spp, per lane: cornell (32 prims: the brute
    force on both, no K1 launch) and kitchen_stress(grid=2) under
    MEGAKERNEL_PT, full-size medium_cbox under VOLUME_PT (its BVH as one
    chunk)."""
    md = MaxDepthParams()
    cases = {
        "cornell": (lambda: tts.cornell_box(SMALL, SMALL, device=dev)[:2],
                    RendererType.MEGAKERNEL_PT),
        "kitchen_small": (lambda: tts.kitchen_stress(SMALL, SMALL, grid=2, ns=6, nt=4,
                                                     device=dev)[:2], RendererType.MEGAKERNEL_PT),
        "medium_cbox": (lambda: (vscene, _shrunk(vcam, SMALL)), RendererType.VOLUME_PT),
    }
    res = {}
    for name, (make, rtype) in cases.items():
        scene, cam = make()
        parsed = ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height,
                                                         md=md, seed=0))
        imgs, ms, launched = {}, {}, {}
        for trav in ("pallas", "xla"):
            r = Renderer(parsed, renderer=rtype, traversal=trav)
            torch.cuda.synchronize()
            mk.reset_launches()
            t0 = time.perf_counter()
            imgs[trav] = r.render_raw().reshape(-1, 3)
            torch.cuda.synchronize()
            ms[trav] = (time.perf_counter() - t0) * 1e3
            launched[trav] = {k: v for k, v in mk.LAUNCHES.items() if v}
        frac, dmean = check_contract(f"{name} traversal pallas against xla", imgs["pallas"],
                                     imgs["xla"])
        want = set() if name == "cornell" else {"traverse_forest"}
        if set(launched["pallas"]) != want or launched["xla"]:
            raise SystemExit(f"{name}: launched {launched}, K1 expected only under pallas")
        log(f"[4] {name} {rtype.value} {SMALL}x{SMALL}x1spp, traversal pallas against xla: "
            f"{frac:.7f} lanes differ, means differ by {dmean:.3g}; K1 launches "
            f"{launched['pallas'].get('traverse_forest', 0)}; pass {ms['pallas']:.0f} ms "
            f"(pallas) / {ms['xla']:.0f} ms (xla)")
        res[name] = {"lanes_differ": frac, "mean_differ": dmean,
                     "k1_launches": launched["pallas"].get("traverse_forest", 0),
                     "pass_ms_pallas": ms["pallas"], "pass_ms_xla": ms["xla"]}
    return res


def hold_walk_k1(mk, tk, scene, o, d, label: str) -> dict:
    """The binary walk (closest_hit_w8 on binary packs of scene, f32 and
    bf16 rows) against kernel K1's per-ray form over the scene's BVH as one
    chunk, on the same rays: prim ids equal on every ray."""
    forest = tk.single_chunk_forest(scene.geom, scene.bvh)
    k1 = tk.traverse_forest(forest, o, d)
    out = {"rays": o.shape[0], "hits": int((k1["prim"] >= 0).sum())}
    for node_fmt in ("f32", "bf16"):
        _, prim, _, _ = mk.closest_hit_w8(mk.make_pack(scene, node_fmt=node_fmt), o, d)
        torch.cuda.synchronize()
        out[f"{node_fmt}_differ"] = int((prim != k1["prim"]).sum())
    log(f"[11] binary walk against K1 over the one-chunk forest, {label}, {o.shape[0]} camera "
        f"rays: prim ids differing {out['f32_differ']} (f32 rows), {out['bf16_differ']} (bf16 "
        f"rows); hits {out['hits']}")
    if out["f32_differ"] or out["bf16_differ"]:
        raise SystemExit(f"binary walk check failed on {label}: {out}")
    return out


def held_splats(label: str, img_k: torch.Tensor, img_p: torch.Tensor) -> dict:
    """Two splat images of the same paths (H*W, 3): the kernel's walk and
    the plain walk. Float atomics do not fix the order of a pixel's adds,
    so they are held per pixel: over the pixels either touched,
    allclose(rtol 1e-4, atol 1e-6 x the largest pixel) on >= 98 %, and the
    image sums within 1e-4 relative."""
    if not (bool(torch.isfinite(img_k).all()) and bool(torch.isfinite(img_p).all())):
        raise SystemExit(f"{label}: non-finite splats")
    touched = (img_k != 0).any(dim=-1) | (img_p != 0).any(dim=-1)
    atol = 1e-6 * float(img_p.abs().max())
    close = torch.isclose(img_k[touched], img_p[touched], rtol=1e-4, atol=atol).all(dim=-1)
    frac = float(close.float().mean()) if bool(touched.any()) else 0.0
    s_k, s_p = float(img_k.double().sum()), float(img_p.double().sum())
    rel = abs(s_k / s_p - 1.0) if s_p else float("inf")
    if frac < 0.98 or rel > 1e-4:
        raise SystemExit(f"{label}: {frac} of {int(touched.sum())} touched pixels agree, sums "
                         f"differ by {rel} relative")
    return {"pixels_touched": int(touched.sum()), "pixels_agree": frac, "sum_rel_differ": rel,
            "not_bit_equal": int((img_k != img_p).any(dim=-1).sum())}


def walls_per_pass(r, passes: int) -> float:
    """Wall ms per pass of the Renderer r over passes passes (synchronized)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(passes)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / passes


def phase_light(mk, tk, tts, dev, kscene, kcam, f32, T, MaxDepthParams, RendererType,
                RenderingConfig, ParsedScene, Renderer) -> tuple:
    """Phase 16: the light tracer's main path (MEGAKERNEL_LT, traversal
    "pallas", full-size kitchen_stress on its f32 forest: K1 only) with a
    65,536-path block held to the plain walk, light against path tracing on
    cornell, DEPTH and BVH_COST held to the CPU, render_aovs on K1 held to
    the plain walk, and denoise held to the CPU's filter. Returns (K1's
    numbers for its kernels entry, the phase's own entry, the light
    tracer's Renderer)."""
    import dataclasses

    from cuda_pt_torch.accel import traverse
    from cuda_pt_torch.core import film as film_mod
    from cuda_pt_torch.models import debug_renderers, denoise, light_tracer

    md = MaxDepthParams()

    def parsed(scene, cam):
        return ParsedScene(scene, cam, RenderingConfig(width=cam.width, height=cam.height, md=md,
                                                       seed=0))

    # 1. the main path
    r = Renderer(parsed(dataclasses.replace(kscene, forest=f32), kcam),
                 renderer=RendererType.MEGAKERNEL_LT, traversal="pallas")
    info = r.info()
    if (info["driver"], info["traversal"]) != ("composed", "pallas"):
        raise SystemExit(f"light tracer: not the composed route on K1: {info}")
    wall, launches, _, mean = render_main_path(
        mk, r, LT_SPP, "light tracer", {"launches": ["traverse_forest"], "instantiations": []})
    n_launch = launches["traverse_forest"]
    if n_launch > (2 * md.max_depth + 1) * LT_SPP or mean <= 0.0:
        raise SystemExit(f"light tracer: {n_launch} K1 launches in {LT_SPP} passes (at most "
                         f"{2 * md.max_depth + 1} a pass), image mean {mean}")
    log(f"[16] Renderer MEGAKERNEL_LT traversal=pallas, kitchen_stress {kcam.width}x"
        f"{kcam.height}x{LT_SPP} passes: {wall * 1e3 / LT_SPP:.2f} ms wall per pass, "
        f"{n_launch / LT_SPP:g} K1 launches per pass, image mean {mean:.6f}")
    k1_run = k1_main_path(tk, f32, lambda: light_tracer.render_pass(
        r.scene, r.camera, md, 0, 0, True), "16", "one light-tracing pass")
    # 2. a block of paths on K1 and on its plain walk
    t0 = time.perf_counter()
    blk_k = light_tracer.render_pass(r.scene, r.camera, md, 3, 0, True, n_paths=BLOCK)
    torch.cuda.synchronize()
    blk_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with plain_walk(tk):
        blk_p = light_tracer.render_pass(r.scene, r.camera, md, 3, 0, True, n_paths=BLOCK)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    blk = held_splats("light tracer block, K1 against its plain walk", blk_k, blk_p)
    log(f"[16] {BLOCK} light paths on K1 against the plain walk: {blk['pixels_agree']:.6f} of "
        f"{blk['pixels_touched']} touched pixels agree ({blk['not_bit_equal']} not bit-equal), "
        f"sums differ by {blk['sum_rel_differ']:.3g}; {blk_ms:.0f} ms on K1, {plain_ms:.0f} ms "
        f"on the plain walk")
    # 3. light against path tracing on cornell
    cscene, ccam = tts.cornell_box(kcam.width, kcam.height, device=dev)[:2]
    rl = Renderer(parsed(cscene, ccam), renderer=RendererType.MEGAKERNEL_LT)
    rp = Renderer(parsed(cscene, ccam), renderer=RendererType.MEGAKERNEL_PT)
    mk.reset_launches()
    lt_cornell_ms = walls_per_pass(rl, LT_SPP)
    if any(mk.LAUNCHES.values()):
        raise SystemExit(f"cornell light tracer (brute force) launched {dict(mk.LAUNCHES)}")
    rp.render(LT_SPP)
    ratio = float(rl.film.mean.mean()) / float(rp.film.mean.mean())
    if not 0.8 < ratio < 1.25:
        raise SystemExit(f"cornell: light-traced / path-traced mean {ratio}, not in (0.8, 1.25)")
    log(f"[16] cornell {ccam.width}x{ccam.height}x{LT_SPP}: MEGAKERNEL_LT (brute force) "
        f"{lt_cornell_ms:.2f} ms wall per pass, mean {float(rl.film.mean.mean()):.6f}; fused "
        f"MEGAKERNEL_PT mean {float(rp.film.mean.mean()):.6f}; ratio {ratio:.4f}")
    # 4. DEPTH and BVH_COST on the card against the CPU
    debug = {}
    for name, make in (("cornell", lambda d: tts.cornell_box(SMALL, SMALL, device=d)[:2]),
                       ("kitchen_small", lambda d: tts.kitchen_stress(
                           SMALL, SMALL, grid=2, device=d)[:2])):
        scene, cam = make(dev)
        scene_c, cam_c = T.to_device(scene, "cpu"), cam.to("cpu")
        for rtype in (RendererType.DEPTH, RendererType.BVH_COST):
            rd = Renderer(parsed(scene, cam), renderer=rtype)
            img = rd.render_raw()
            img_c = Renderer(parsed(scene_c, cam_c), renderer=rtype, device="cpu").render_raw()
            px = float((img.cpu() == img_c).all(dim=-1).float().mean())
            if rtype == RendererType.DEPTH:
                _, aux = debug_renderers.render_depth(scene, cam, use_bvh=rd.use_bvh)
                _, aux_c = debug_renderers.render_depth(scene_c, cam_c, use_bvh=rd.use_bvh)
                rel = max(float(((aux[k].cpu() - aux_c[k]).abs()
                                 / aux_c[k].abs().clamp(min=1e-30)).max())
                          for k in ("depth", "t_min", "t_max"))
                row = {"pixels_equal": px, "max_rel_differ": rel}
                ok = px >= 0.99 and rel <= 4e-6
            else:
                o, d = debug_renderers._primary_rays(cam, 0)
                cnt = traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d, count_cost=True)
                cnt_c = traverse.closest_hit_bvh(scene_c.geom, scene_c.bvh, o.cpu(), d.cpu(),
                                                 count_cost=True)
                rays = min(float((cnt[k].cpu() == cnt_c[k]).float().mean())
                           for k in ("node_cnt", "prim_cnt"))
                _, aux = debug_renderers.render_bvh_cost(scene, cam)
                _, aux_c = debug_renderers.render_bvh_cost(scene_c, cam_c)
                rel = abs(float(aux["mean_cost"]) / float(aux_c["mean_cost"]) - 1.0)
                row = {"pixels_equal": px, "rays_equal": rays, "mean_cost_rel_differ": rel}
                ok = rays >= 0.999 and rel <= 1e-3
            log(f"[16] {rtype.value} on {name} {SMALL}x{SMALL}, card against CPU: {row}")
            if not ok:
                raise SystemExit(f"{rtype.value} on {name}: the card disagrees with the CPU: {row}")
            debug[f"{rtype.value}_{name}"] = row
    for rtype in (RendererType.DEPTH, RendererType.BVH_COST):
        debug[f"{rtype.value}_cornell_wall_ms_per_pass"] = walls_per_pass(
            Renderer(parsed(cscene, ccam), renderer=rtype), LT_SPP)
        log(f"[16] {rtype.value} cornell {ccam.width}x{ccam.height}: "
            f"{debug[f'{rtype.value}_cornell_wall_ms_per_pass']:.2f} ms wall per pass")
    # 5. AOVs on K1 and on the plain walk; denoise against the CPU's filter
    torch.cuda.synchronize()
    mk.reset_launches()
    aov = r.render_aovs(spp=1)
    aov_launches = {k: v for k, v in mk.LAUNCHES.items() if v}
    if set(aov_launches) != {"traverse_forest"}:
        raise SystemExit(f"render_aovs under pallas launched {aov_launches}, not K1 alone")
    with plain_walk(tk):
        aov_p = r.render_aovs(spp=1)
    dep_ok = float(np.mean(np.isclose(aov["depth"], aov_p["depth"], rtol=1e-5, atol=0.0)))
    if not np.array_equal(aov["coverage"], aov_p["coverage"]) or dep_ok < 0.999:
        raise SystemExit(f"render_aovs on K1 against the plain walk: coverage equal "
                         f"{np.array_equal(aov['coverage'], aov_p['coverage'])}, depth "
                         f"within 1e-5 on {dep_ok}")
    rp.render(4 - LT_SPP)  # the fused cornell film at 4 passes
    den = rp.denoise()
    a_cpu = {k: v.cpu() for k, v in debug_renderers.render_aovs(
        rp.scene, rp.camera, spp=4, seed=rp.seed + 7919, use_bvh=rp.use_bvh).items()}
    var = (film_mod.variance(rp.film) / rp.film.count).cpu()
    den_c = denoise.atrous_denoise(rp.film.mean.cpu(), a_cpu, variance=var).numpy()
    den_err = float(np.abs(den - den_c).max())
    if rp.film.count != 4 or not np.allclose(den, den_c, rtol=1e-4, atol=1e-4):
        raise SystemExit(f"denoise on the card against the CPU's filter: max |err| {den_err}")
    log(f"[16] render_aovs kitchen {kcam.width}x{kcam.height} on K1: launches {aov_launches}, "
        f"coverage equal to the plain walk's, depth within 1e-5 on {dep_ok:.6f}; denoise of "
        f"the fused cornell film at 4 passes against the CPU's filter: max |err| {den_err:.3g}")
    k1_entry = {"lt_ms_per_pass": k1_run["ms"], "lt_launches_per_pass": n_launch / LT_SPP,
                "lt_bound_ms": k1_run["bound_ms"], "lt_bound_by": k1_run["bound_by"],
                "lt_nodes": k1_run["nodes"], "lt_prim_tests": k1_run["prim_tests"],
                "lt_warps": k1_run["warps"]}
    entry = {"lt_wall_ms_per_pass": wall * 1e3 / LT_SPP, "lt_image_mean": mean,
             "lt_k1_launches": n_launch, "lt_k1_ms_per_pass": k1_run["ms"],
             "lt_k1_bound_ms": k1_run["bound_ms"], "lt_k1_lanes": k1_run["lanes"],
             "block": {**blk, "k1_ms": blk_ms, "plain_ms": plain_ms},
             "cornell_lt_wall_ms_per_pass": lt_cornell_ms, "cornell_lt_over_pt": ratio,
             "debug": debug, "aov_launches": aov_launches, "aov_depth_within": dep_ok,
             "denoise_max_abs_err": den_err}
    return k1_entry, entry, r


def phase_render_megakernel(mk, tk, tts, dev, kscene, kcam, ref_mean: float,
                            MaxDepthParams) -> tuple:
    """The reference's render_megakernel at full size, in the formats of its
    rule: cornell 1024x1024 x RM_CORNELL_SPP on binary f32 nodes (the
    whole-path kernel's K2+BIN) and full-size kitchen_stress 1024x1024 x
    RM_KITCHEN_SPP on bf16 binary nodes, t9 prims and bf16 attrs (K5's
    SEG+K3+ALL+BIN); per scene the kernel's time per spp on the rays of
    sample 0, its walk work, bound and share, a 65,536-lane block held to
    the plain version, and the binary walk against K1 on the camera rays."""
    import types

    md = MaxDepthParams()
    cscene, ccam, _ = tts.cornell_box(1024, 1024, device=dev)
    out = {}
    for label, scene, cam, spp, want, fmts in (
            ("cornell", cscene, ccam, RM_CORNELL_SPP,
             {"launches": ["trace_megakernel"], "instantiations": ["K2+BIN"]},
             ("f32", "f32", "f32")),
            ("kitchen", kscene, kcam, RM_KITCHEN_SPP,
             {"launches": ["trace_megakernel_seg"], "instantiations": ["SEG+K3+ALL+BIN"]},
             ("bf16", "t9", "bf16"))):
        t0 = time.perf_counter()
        pack = mk.make_pack(scene)
        pack_s = time.perf_counter() - t0
        if (pack.node_fmt, pack.prim_fmt, pack.attr_fmt) != fmts:
            raise SystemExit(f"{label}: make_pack(scene) gave {pack_formats(pack)}, not {fmts}")
        wall, launches, inst, mean = counted_path(
            mk, lambda: mk.render_megakernel(scene, cam, md, spp, seed=0), cam,
            f"render_megakernel {label}", want)
        n_launch = sum(launches.values())
        log(f"[11] render_megakernel {label} {cam.width}x{cam.height}x{spp}spp: {wall:.2f} s wall "
            f"({wall * 1e3 / spp:.2f} ms per spp, incl. make_pack {pack_s:.2f} s), launches "
            f"{launches} {inst}, image mean {mean:.6f}, pack {pack_formats(pack)} "
            f"({mk.pack_boxes(pack)} boxes: driver {mk.driver_of(pack)})")
        if label == "cornell" and abs(mean - ref_mean) > 0.02 * ref_mean:
            raise SystemExit("render_megakernel cornell: image mean disagrees with the plain "
                             "version's")
        view = types.SimpleNamespace(_pack=pack, camera=cam, device=dev)
        if label == "cornell":
            row = hold_main_path(mk, view, md, BLOCK, "11", "render_megakernel cornell",
                                 ab=True)
        else:
            row = hold_swf(mk, view, md, BLOCK, "11", "render_megakernel kitchen")
            row.pop("runs", None)
        row.pop("L")
        o, d, _, _ = main_rays(mk, view, BLOCK)
        row["walk_check"] = hold_walk_k1(mk, tk, scene, o.contiguous(), d.contiguous(), label)
        row["node_fetches"] = row["wide_nodes"]  # binary nodes: the count is of node fetches
        row.update({"launches": n_launch, "instantiations": inst,
                    "wall_ms_per_spp": wall * 1e3 / spp, "make_pack_s": pack_s,
                    "image_mean": mean, "spp": spp})
        out[label] = row
    return out["cornell"], out["kitchen"]


def phase_s1(mk, nb, tk, dev, scenes: dict) -> dict:
    """Kernel S1 (csrc/node_bench.cu) on the binary f32 rows of each scene:
    S1_ITERS steps on S1_RAYS rays (the reference's, every ray equal) and on
    a block of random rays, bit-equal to the plain version; its time at
    S1_ITERS and S1_ITERS / 2 steps (CUDA events) gives c_node, one step of
    the launch, and per node fetch (over the rays)."""
    torch.cuda.synchronize()
    mk.reset_launches()  # every count, S1's included (one dict)
    o, d = nb.reference_rays(S1_RAYS, dev)
    res = {}
    for label, scene in scenes.items():
        nodes = torch.as_tensor(tk.pack_nodes(scene.bvh), device=dev)
        out = nb.node_bench(nodes, o, d, S1_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = nb.node_bench_reference(nodes, o, d, S1_ITERS)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        rs = np.random.default_rng(29)
        lo = scene.bvh.node_min[0].cpu().numpy()
        hi = scene.bvh.node_max[0].cpu().numpy()
        o_r = torch.as_tensor(rs.uniform(lo, hi, (BLOCK, 3)).astype(np.float32), device=dev)
        d_r = torch.nn.functional.normalize(torch.as_tensor(
            rs.normal(size=(BLOCK, 3)).astype(np.float32), device=dev), dim=1).contiguous()
        out_r = nb.node_bench(nodes, o_r, d_r, S1_ITERS)
        ref_r = nb.node_bench_reference(nodes, o_r, d_r, S1_ITERS)
        torch.cuda.synchronize()
        differ = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
        differ_r = int((out_r.view(torch.int32) != ref_r.view(torch.int32)).sum())
        err = float(torch.where(out == ref, 0.0, (out - ref).abs()).max())
        if differ or differ_r:
            raise SystemExit(f"S1 {label}: {differ} + {differ_r} rays differ from the plain version")
        parent = {}
        if parent_lib() is not None:
            p_out = with_parent(lambda: nb.node_bench(nodes, o, d, S1_ITERS))
            p_out_r = with_parent(lambda: nb.node_bench(nodes, o_r, d_r, S1_ITERS))
            parent["rays_differ"] = bit_differ(out, p_out) + bit_differ(out_r, p_out_r)
            log(f"[12] S1 {label}: rays whose output differs from the parent's kernel bit for "
                f"bit: {parent['rays_differ']}")
            if parent["rays_differ"]:
                raise SystemExit(f"S1 {label}: rays differ from the parent's kernel")
            parent["ms"] = in_turns(lambda: events_ms(
                lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5), "12",
                f"S1 {label}, {S1_RAYS} rays x {S1_ITERS} steps")
            parent["c_node_us"] = in_turns(lambda: s1_c_node(nb, nodes, o, d), "12",
                                           f"S1 {label}, c_node", "us per step")
        t_n = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5)
        t_h = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS // 2), 5)
        step_ms = (t_n - t_h) / (S1_ITERS - S1_ITERS // 2)
        fetch_ns = step_ms * 1e6 / S1_RAYS
        nbytes = nodes.numel() * 4 + S1_RAYS * (24 + 4)
        bound_ms, bound_by = bound(nbytes, S1_ITERS * S1_RAYS, 0, 1)
        res[label] = {"rows": nodes.shape[0], "ms": t_n, "half_ms": t_h, "plain_ms": plain_ms,
                      "c_node_step_ms": step_ms, "c_node_ns_per_fetch": fetch_ns,
                      "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
                      "rays": S1_RAYS, "iters": S1_ITERS, "parent": parent}
        log(f"[12] S1 {label} ({nodes.shape[0]} f32 node rows), {S1_RAYS} rays x {S1_ITERS} "
            f"steps: bit-equal to the plain version (and on {BLOCK} random rays); {t_n:.4f} ms "
            f"({S1_ITERS // 2} steps: {t_h:.4f} ms): c_node {step_ms * 1e3:.4f} us per step of "
            f"the launch, {fetch_ns:.5f} ns per node fetch; bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / t_n:.4f} of bound; plain {plain_ms:.1f} ms")
    res["launches"] = nb.LAUNCHES["node_bench"]
    return res


def s1_c_node(nb, nodes, o, d) -> float:
    """S1's c_node in us per step of the launch: its time at S1_ITERS steps
    less its time at half of them, per step (events_ms, 5 launches each)."""
    t_n = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS), 5)
    t_h = events_ms(lambda: nb.node_bench(nodes, o, d, S1_ITERS // 2), 5)
    return (t_n - t_h) / (S1_ITERS - S1_ITERS // 2) * 1e3


def model_share(row: dict, c_fetch_ns: float, label: str) -> float:
    """S1's model of a kernel's time: its node fetches times c_node per
    fetch, over its measured time."""
    share = row["wide_nodes"] * c_fetch_ns * 1e-6 / row["ms"]
    log(f"[12] S1 model, {label}: {row['wide_nodes']} node fetches x {c_fetch_ns:.5f} ns = "
        f"{row['wide_nodes'] * c_fetch_ns * 1e-6:.4f} ms of the measured {row['ms']:.3f} ms: "
        f"{share:.4f}")
    return share


def bit_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def host_ms(fn) -> tuple:
    """(fn()'s result, its wall ms, synchronized on both ends): the plain
    versions' time, many launches each."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def counted_entry(mk, launches: dict, key: str, run) -> tuple:
    """run() (an entry's main()) with every launch count set to 0 just
    before and read just after; fails unless the entry launched its
    kernel. Returns (its rows, the launches)."""
    torch.cuda.synchronize()
    mk.reset_launches()
    rows = run()
    torch.cuda.synchronize()
    n = launches[key]
    if n == 0:
        raise SystemExit(f"{key}: the entry launched no kernel")
    return rows, n


def phase_s2(mk, ab, nb, tk, dev, kscene, cscene) -> dict:
    """Kernel S2 (csrc/extract_ab.cu): every tag bit-equal to its plain
    version on kitchen_stress's binary f32 rows, S2_HOLD_ITERS steps on two
    tiles of 8,192 lanes (the reference's equal rays, random rays around the
    scene); v0 = v1 = v2 per lane and v0 on the equal rays = S1; then the
    entry (ab.main) on one tile (the reference's shape) over kitchen's and
    cornell's rows, launches counted, and on CARD_LANES lanes over
    kitchen's."""
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    nodes = {name: torch.as_tensor(tk.pack_nodes(sc.bvh), device=dev)
             for name, sc in (("kitchen", kscene), ("cornell", cscene))}
    nk = nodes["kitchen"]
    lo = kscene.bvh.node_min[0].cpu().numpy() - 1.0
    hi = kscene.bvh.node_max[0].cpu().numpy() + 1.0
    o, d = s2_rays(nb, ab.TILE, ab.TILE, lo, hi, 31, dev)
    o_eq, d_eq = o[:ab.TILE], d[:ab.TILE]
    outs, plain, err = {}, {}, 0.0
    for tag in ab.TAGS:
        outs[tag] = ab.extract_ab(tag, nk, o, d, S2_HOLD_ITERS)
        ref, plain[tag] = host_ms(lambda: ab.extract_ab_reference(tag, nk, o, d, S2_HOLD_ITERS))
        err = max(err, float(torch.where(outs[tag] == ref, 0.0, (outs[tag] - ref).abs()).max()))
        if bit_differ(outs[tag], ref):
            raise SystemExit(f"S2 {tag}: {bit_differ(outs[tag], ref)} lanes differ from the "
                             "plain version")
    if bit_differ(outs["v0"], outs["v1"]) or bit_differ(outs["v0"], outs["v2"]):
        raise SystemExit("S2: v0, v1 and v2 differ per lane")
    s1 = nb.node_bench(nk, o_eq, d_eq, S2_HOLD_ITERS)
    if bit_differ(outs["v0"][:ab.TILE], s1):
        raise SystemExit("S2: v0 on equal rays differs from S1")
    hits = int((outs["v0"][ab.TILE:] != 0).sum())
    hold_ms = launch_ms(lambda: ab.extract_ab("v0", nk, o, d, S2_HOLD_ITERS), 3)
    # 128 tiles (one block per tile): a tile of equal rays, then random ones
    o_c, d_c = s2_rays(nb, ab.TILE, CARD_LANES - ab.TILE, lo, hi, 37, dev)
    sizes = {2: ab.cluster_size(2), CARD_LANES // ab.TILE: ab.cluster_size(CARD_LANES // ab.TILE)}
    parent_differ = {}
    for tag in ab.TAGS:
        out_c = ab.extract_ab(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS)
        ref_c = ab.extract_ab_reference(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS)
        if bit_differ(out_c, ref_c):
            raise SystemExit(f"S2 {tag}, {CARD_LANES // ab.TILE} tiles: {bit_differ(out_c, ref_c)} "
                             "lanes differ from the plain version")
        if parent_lib() is not None:
            p2 = with_parent(lambda: ab.extract_ab(tag, nk, o, d, S2_HOLD_ITERS))
            pc = with_parent(lambda: ab.extract_ab(tag, nk, o_c, d_c, S2_CARD_HOLD_ITERS))
            parent_differ[tag] = bit_differ(outs[tag], p2) + bit_differ(out_c, pc)
    log(f"[13] S2 on kitchen's {nk.shape[0]} f32 node rows, 2 tiles x {ab.TILE} lanes x "
        f"{S2_HOLD_ITERS} steps (a cluster of {sizes[2]} blocks per tile): all {len(ab.TAGS)} tags "
        f"bit-equal to the plain version (random tile: {hits} lanes with box hits); v0 = v1 = v2 "
        f"per lane; v0 = S1 on the equal rays; v0 {hold_ms:.3f} ms, plain {plain['v0']:.1f} ms; "
        f"{CARD_LANES // ab.TILE} tiles x {S2_CARD_HOLD_ITERS} steps (cluster size "
        f"{sizes[CARD_LANES // ab.TILE]}): every tag bit-equal to the plain version"
        + (f"; lanes differing from the parent's kernel, both shapes: {parent_differ}"
           if parent_differ else ""))
    if any(parent_differ.values()):
        raise SystemExit(f"S2: lanes differ from the parent's kernel: {parent_differ}")
    turns = {}
    if parent_lib() is not None:
        for tiles in (1, CARD_LANES // ab.TILE):
            o_t, d_t = nb.reference_rays(tiles * ab.TILE, dev)
            for tag in ab.MAIN_TAGS:
                turns.setdefault(str(tiles), {})[tag] = in_turns(
                    lambda: s2_c_node(ab, tag, nk, o_t, d_t), "13",
                    f"S2 {tag}, {tiles} tile(s) of equal rays, c_node", "ns per step")
    rows, launches = counted_entry(mk, ab.LAUNCHES, "extract_ab", lambda: ab.main(
        ["--tiles", "1", "--reps", "3"], nodes=nodes))
    card = ab.main(["--tiles", str(CARD_LANES // ab.TILE), "--reps", "3", "--scene", "kitchen"],
                   nodes=nodes)
    res = {"launches": launches, "max_abs_err": err, "hold_plain_ms": plain, "hold_ms": hold_ms,
           "hold_lanes": 2 * ab.TILE, "hold_iters": S2_HOLD_ITERS, "random_tile_hit_lanes": hits,
           "card_hold_iters": S2_CARD_HOLD_ITERS, "cluster_sizes": sizes,
           "parent_lanes_differ": parent_differ, "turns": turns}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, rs_ in (("reference", rows), ("card_scale", card)):
        lanes = ab.TILE * (1 if label == "reference" else CARD_LANES // ab.TILE)
        for r in rs_:
            if "variant" not in r:
                continue
            rows_b = nodes[r["scene"]].numel() * 4 + lanes * 28
            b_ms, b_by = bound(rows_b, ab.ITERS * lanes, 0, OPS_S2[r["variant"]] / OPS_SLAB)
            r.update(bound_ms=b_ms, bound_by=b_by, lanes=lanes)
            res.setdefault(label, {}).setdefault(r["scene"], {})[r["variant"]] = r
        for sc, tags in res[label].items():
            log(f"[13] S2 {label} ({lanes} lanes, {ab.ITERS} steps), {sc}: " + ", ".join(
                f"{t} {r['c_node_ns']:.1f} ns/step" for t, r in tags.items()))
    # worked out, not measured: one tile's operations at the card's peak on
    # one SM (a tile in one block) and on the SMs of its cluster
    for t, r in res["reference"]["kitchen"].items():
        one_sm = ab.ITERS * ab.TILE * OPS_S2[t] / (PEAK_F32_S / sms) * 1e3
        log(f"[13] S2 {t}, one tile: floor {one_sm:.4f} ms on one SM, {one_sm / r['cluster']:.4f} "
            f"ms on its cluster of {r['cluster']}, whole-card bound {r['bound_ms']:.4f} ms")
    return res


def s2_rays(nb, n_equal: int, n_random: int, lo, hi, seed: int, dev):
    """n_equal of the reference's equal rays, then n_random random rays with
    origins in [lo, hi] -> (o, d)."""
    o_eq, d_eq = nb.reference_rays(n_equal, dev)
    rs = np.random.default_rng(seed)
    o_r = torch.as_tensor(rs.uniform(lo, hi, (n_random, 3)).astype(np.float32), device=dev)
    d_r = torch.nn.functional.normalize(torch.as_tensor(
        rs.normal(size=(n_random, 3)).astype(np.float32), device=dev), dim=1)
    return torch.cat([o_eq, o_r]).contiguous(), torch.cat([d_eq, d_r]).contiguous()


def s2_c_node(ab, tag: str, nodes, o, d) -> float:
    """c_node of one S2 tag as its entry measures it: the launch at ab.ITERS
    steps less the launch at half of them, per step, in ns
    (utils/timing.events_ms, the median of 3 launches each)."""
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    t_n = launch_ms(lambda: ab.extract_ab(tag, nodes, o, d, ab.ITERS), 3)
    t_h = launch_ms(lambda: ab.extract_ab(tag, nodes, o, d, ab.ITERS // 2), 3)
    return (t_n - t_h) / (ab.ITERS - ab.ITERS // 2) * 1e6


def phase_s3(mk, lg, dev) -> dict:
    """Kernel S3 (csrc/lanegather.cu): every tag bit-equal to its plain
    version at the reference's (64, 128) x REPS and at (8192, 128) x 16; the
    check gather equal to torch.take_along_dim; with --parent every tag and
    the gather bit-equal to the parent's kernel, and the gather timed in
    turns with it, warm and cold; then the entry (lg.main) at 64 rows,
    launches counted, and at CARD_LANES / 128 rows; at both sizes the
    gather's time warm (its inputs left in L2 by the last launch) and cold
    (L2 flushed before each launch), an empty kernel on its grid (the
    launch floor), its plain version's and torch.take_along_dim's time
    (each launch timed alone, after a device sleep)."""
    from cuda_pt_torch.utils import timing

    flush = timing.flush_buffer(dev)
    res, err = {}, 0.0
    for label, rows, reps in (("reference", lg.ROWS, lg.REPS),
                              ("card_scale", CARD_LANES // lg.ROW, 16)):
        x, row, idx = lg.make_inputs(0, rows, dev)
        plain, parent_differ = {}, 0
        for tag in lg.TAGS:
            out = lg.lanegather(tag, x, row, idx, reps)
            ref, plain[tag] = host_ms(lambda: lg.lanegather_reference(tag, x, row, idx, reps))
            if bit_differ(out, ref):
                raise SystemExit(f"S3 {tag}, {rows} rows: {bit_differ(out, ref)} lanes differ "
                                 "from the plain version")
            if parent_lib() is not None:
                parent_differ += bit_differ(out, with_parent(
                    lambda: lg.lanegather(tag, x, row, idx, reps)))
        g = lg.gather(row, idx)
        idx64 = idx.long()
        rb = row.expand(rows, lg.ROW)
        lib = torch.take_along_dim(rb, idx64, dim=1)
        ref = lg.gather_reference(row, idx)
        if not torch.equal(g, lib) or not torch.equal(g, ref):
            raise SystemExit(f"S3 gather, {rows} rows: differs from torch.take_along_dim")
        err = max(err, float((g - ref).abs().max()))
        n = rows * lg.ROW
        b_ms, b_by = bound(n * 8 + lg.ROW * 4, 0, 0)
        gather = lambda: lg.gather(row, idx)  # noqa: E731
        res["hold_" + label] = h = {
            "lanes": n, "hold_reps": reps, "hold_plain_ms": plain,
            "gather_ms": timing.events_ms(gather, 5),
            "gather_cold_ms": timing.events_ms(gather, 5, flush=flush),
            "launch_floor_ms": timing.events_ms(lambda: lg.empty_launch(row, idx), 5),
            "gather_plain_ms": timing.events_ms(lambda: lg.gather_reference(row, idx), 5),
            "library_ms": timing.events_ms(lambda: torch.take_along_dim(rb, idx64, dim=1), 5),
            "library_cold_ms": timing.events_ms(
                lambda: torch.take_along_dim(rb, idx64, dim=1), 5, flush=flush),
            "bound_ms": b_ms, "bound_by": b_by}
        if parent_lib() is not None:
            parent_differ += bit_differ(g, with_parent(gather))
            log(f"[14] S3 at ({rows}, 128): lanes of the tags and the gather that differ from the "
                f"parent's kernel bit for bit: {parent_differ}")
            if parent_differ:
                raise SystemExit(f"S3, {rows} rows: lanes differ from the parent's kernel")
            h["parent"] = {
                "warm": in_turns(lambda: timing.events_ms(gather, 5), "14",
                                 f"S3 gather ({rows}, 128), warm"),
                "cold": in_turns(lambda: timing.events_ms(gather, 5, flush=flush), "14",
                                 f"S3 gather ({rows}, 128), cold")}
        log(f"[14] S3 at ({rows}, 128) x {reps}: every tag bit-equal to the plain version, "
            f"the gather equal to torch.take_along_dim; gather {h['gather_ms']:.6f} ms warm, "
            f"{h['gather_cold_ms']:.6f} cold, launch floor (an empty kernel on its grid) "
            f"{h['launch_floor_ms']:.6f}; plain {h['gather_plain_ms']:.6f}, take_along_dim "
            f"{h['library_ms']:.6f} warm, {h['library_cold_ms']:.6f} cold; bound {b_ms:.7f} ms "
            f"({b_by})")
    rows_ref, launches = counted_entry(mk, lg.LAUNCHES, "lanegather", lambda: lg.main([]))
    rows_card = lg.main(["--rows", str(CARD_LANES // lg.ROW)])
    for label, rows_, r_ in (("reference", rows_ref, lg.ROWS),
                             ("card_scale", rows_card, CARD_LANES // lg.ROW)):
        per = {r["tag"]: r["per_iter_ns"] for r in rows_ if "tag" in r}
        summary = next(r for r in rows_ if "summary" in r)
        res[label] = {"rows": r_, "per_iter_ns": per, "summary": summary}
        log(f"[14] S3 {label} ({r_}, 128) x {lg.REPS}: " + ", ".join(
            f"{t} {v:.2f}" for t, v in per.items()) + " ns/iter; per gather "
            f"{summary['g14_minus_e0_per']:.3f} ns (shuffle {summary['s14_minus_e0_per']:.3f}), "
            f"per select {summary['w112_minus_e0_per']:.3f} ns")
    res["launches"] = launches
    res["max_abs_err"] = err
    return res


def ab_s4(mx, path: str, dev) -> dict:
    """S4's mxu forms against the parent tree's (its library at path) on the
    same inputs, at 4,096 and at CARD_LANES rays x 2,000 leaves, in turns
    (parent, this, this, parent); each launch timed alone
    (utils/timing.events_ms). The parent's C entry takes a scratch argument
    where its library exports s4_mxuleaf_scratch (the wgmma kernel), none
    where it does not (the mma.sync kernel)."""
    import ctypes

    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    lib = cb.open_library(path)
    fn = lib.s4_mxuleaf
    scratch_floats = getattr(lib, "s4_mxuleaf_scratch", None)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I, P, I, P, P, P, I] + ([P] if scratch_floats else []) + [P]
    res = {}
    for label, rows in (("reference", mx.ROWS), ("card_scale", CARD_LANES // 128)):
        inp = mx.make_inputs(0, rows, mx.NLEAF, dev)
        o, d, coef = inp["o"], inp["d"], inp["coef"]
        n = o.shape[0]
        scratch = [] if scratch_floats is None else [
            torch.empty(scratch_floats(mx.NLEAF), dtype=torch.float32, device=dev)]
        row = {}
        for form in ("mxu", "mxu_1xtf32"):
            out = torch.empty(n, dtype=torch.float32, device=dev)

            def parent_run():
                rc = fn(mx.FORMS.index(form), coef.data_ptr(), mx.NLEAF, o.data_ptr(),
                        d.data_ptr(), out.data_ptr(), n, *[x.data_ptr() for x in scratch],
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise SystemExit(f"the parent's s4_mxuleaf failed: cudaError {rc}")

            ms = {"parent": [], "this": []}
            for who in ("parent", "this", "this", "parent"):
                run = parent_run if who == "parent" else (
                    lambda: mx.leaf_min_t(form, coef, o, d))
                ms[who].append(launch_ms(run, 3 if rows > mx.ROWS else 10))
            same = torch.equal(mx.leaf_min_t(form, coef, o, d).isfinite(), out.isfinite())
            row[form] = {"parent_ms": float(np.mean(ms["parent"])),
                         "ms": float(np.mean(ms["this"])), "runs_ms": ms,
                         "hit_mask_equal_parent": same}
            log(f"[15] S4 {form}, {n} rays x {mx.NLEAF} leaves: this tree {row[form]['ms']:.4f} "
                f"ms, the parent {row[form]['parent_ms']:.4f} ms, in turns (runs {ms}); hit "
                f"masks equal: {same}")
        res[label] = row
    return res


def phase_s4(mk, mx, dev, sass_job: dict) -> dict:
    """Kernel S4 (csrc/mxuleaf.cu): at the reference's 4,096 rays x 2,000
    leaves, scalar bit-equal to its plain version and mxu (3xTF32) within
    the script's parity contract (agree >= 0.999 on lanes finite in both,
    hit mask >= 0.999) against the plain product and against scalar; the
    1xTF32 A/B's hit mask >= 0.99; the same at CARD_LANES rays x
    S4_CARD_HOLD_LEAVES leaves; both mxu builds' SASS hold HGMMA (wgmma);
    with --parent, the parent's mxu forms timed on the same inputs (ab_s4);
    then the entry (mx.main) at 4,096 rays, launches counted, and at
    CARD_LANES rays; the batched torch.matmul of the product alone (f32,
    allow_tf32 False)."""
    from cuda_pt_torch.ops import cuda_build as cb
    from cuda_pt_torch.utils.timing import events_ms as launch_ms

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain product and the library call in f32
    res = {}
    for label, rays, nleaf in (("reference", mx.ROWS * 128, mx.NLEAF),
                               ("card_scale", CARD_LANES, S4_CARD_HOLD_LEAVES)):
        inp = mx.make_inputs(0, rays // 128, nleaf, dev)
        o, d = inp["o"], inp["d"]
        t_s = mx.leaf_min_t("scalar", inp["prow"], o, d)
        t_m = mx.leaf_min_t("mxu", inp["coef"], o, d)
        t_1 = mx.leaf_min_t("mxu_1xtf32", inp["coef"], o, d)
        ref_s, plain_s = host_ms(lambda: mx.scalar_reference(inp["prow"], o, d))
        ref_m, plain_m = host_ms(lambda: mx.mxu_reference(inp["coef"], o, d))
        if bit_differ(t_s, ref_s):
            raise SystemExit(f"S4 scalar, {rays} rays: {bit_differ(t_s, ref_s)} lanes differ "
                             "from the plain version")
        p_plain = mx.parity(ref_m.cpu().numpy(), t_m.cpu().numpy())
        p_scalar = mx.parity(t_s.cpu().numpy(), t_m.cpu().numpy())
        p_1x = mx.parity(ref_m.cpu().numpy(), t_1.cpu().numpy())
        for p in (p_plain, p_scalar):
            if p["agree_frac"] < 0.999 or p["hitmask_match"] < 0.999:
                raise SystemExit(f"S4 mxu, {rays} rays: outside the parity contract {p}")
        if p_1x["hitmask_match"] < 0.99:
            raise SystemExit(f"S4 mxu_1xtf32, {rays} rays: hit mask {p_1x}")
        fin = torch.isfinite(t_m) & torch.isfinite(ref_m)
        err = float((t_m[fin] - ref_m[fin]).abs().max()) if bool(fin.any()) else 0.0
        res["hold_" + label] = {"rays": rays, "nleaf": nleaf, "parity_plain": p_plain, "parity_scalar": p_scalar,
                     "parity_1xtf32": p_1x, "max_abs_err": err, "plain_scalar_ms": plain_s,
                     "plain_mxu_ms": plain_m, "hit_frac": float(torch.isfinite(t_s).float().mean())}
        log(f"[15] S4 {rays} rays x {nleaf} leaves: scalar bit-equal to the plain version; mxu "
            f"(3xTF32) agree {p_plain['agree_frac']:.6f} / hit mask {p_plain['hitmask_match']:.6f}"
            f" against the plain product, {p_scalar['agree_frac']:.6f} / "
            f"{p_scalar['hitmask_match']:.6f} against scalar, max |dt| {err:.3g}; 1xTF32 agree "
            f"{p_1x['agree_frac']:.6f}, hit mask {p_1x['hitmask_match']:.6f}; plain scalar "
            f"{plain_s:.1f} ms, mxu {plain_m:.1f} ms")
    sass = sass_job["read"](["leaf_mxu_kernel", "lanegather_kernelILi2E"])
    mma = {k: {op: v.get(op, 0) for op in ("HGMMA", "HMMA")} for k, v in sass.items()
           if k.startswith("leaf_mxu")}
    if not all(mma.get(f"leaf_mxu_kernel<{f}>", {}).get("HGMMA") for f in (0, 1)):
        raise SystemExit(f"S4: no HGMMA (wgmma) in mxu's SASS ({mma})")
    res["sass"] = {k: dict(v.most_common(8)) for k, v in sass.items()}
    log(f"[15] SASS: HGMMA and HMMA per kernel {mma}; the S3 select chains: " + "; ".join(
        f"{k} {dict(v.most_common(4))}" for k, v in sass.items() if k.startswith("lanegather")))
    parent = parent_lib()
    if parent is not None:
        res["parent"] = ab_s4(mx, parent, dev)
    rows_ref, launches = counted_entry(mk, mx.LAUNCHES, "mxuleaf", lambda: mx.main([]))
    rows_card = mx.main(["--rows", str(CARD_LANES // 128)])
    inp = mx.make_inputs(0, mx.ROWS, mx.NLEAF, dev)
    blocks = inp["coef"].reshape(mx.NLEAF, 32, 16)
    feat = mx.features(inp["o"], inp["d"])
    res["library_ms"] = launch_ms(lambda: torch.matmul(blocks, feat), 3)
    for label, rows_, rays in (("reference", rows_ref, mx.ROWS * 128),
                               ("card_scale", rows_card, CARD_LANES)):
        forms = {r["variant"]: r for r in rows_ if "variant" in r}
        work = rays * mx.NLEAF
        nbytes = mx.NLEAF * (128 + 32 * 16) * 4 + rays * 28
        t_b = nbytes / PEAK_BYTES_S
        t_f32 = work * mx.NP8 * OPS_MXU_EPI / PEAK_F32_S
        for form, t_ops in (("scalar", work * mx.NP8 * OPS_TRI / PEAK_F32_S),
                            ("mxu", max(t_f32, work * 3 * 2 * 32 * 16 / PEAK_TF32_S)),
                            ("mxu_1xtf32", max(t_f32, work * 2 * 32 * 16 / PEAK_TF32_S))):
            forms[form].update(bound_ms=max(t_b, t_ops) * 1e3, ms=forms[form]["sec"] * 1e3,
                               bound_by="bytes" if t_b > t_ops else "operations")
        res[label] = {"rays": rays, "forms": forms,
                      "parity": next(r for r in rows_ if r.get("check") == "parity"),
                      "parity_1xtf32": next(r for r in rows_ if r.get("check") == "parity_1xtf32")}
        log(f"[15] S4 {label} ({rays} rays x {mx.NLEAF} leaves): " + ", ".join(
            f"{f} {r['ms']:.4f} ms ({r['ns_per_leaf']:.2f} ns/leaf, bound {r['bound_ms']:.4f})"
            for f, r in forms.items()))
    log(f"[15] batched torch.matmul (2000, 32, 16) x (16, 4096) in f32, product only, no "
        f"epilogue: {res['library_ms']:.4f} ms")
    res["launches"] = launches
    return res


def s2_entry(s2: dict) -> dict:
    """The results line's S2 entry: v0 on kitchen's rows, one tile at the
    reference's steps; every tag and the card's scale beside it."""
    v0 = s2["reference"]["kitchen"]["v0"]
    pick = ("c_node_ns", "ms", "bound_ms", "cluster", "checksum")
    turns = {tiles: {tag: {k: r[k] for k in ("parent_ms", "this_ms")} for tag, r in tags.items()}
             for tiles, tags in s2["turns"].items()}
    v0_turns = s2["turns"].get("1", {}).get("v0")
    return {"name": "extract_ab (S2 v0, kitchen_stress f32 rows, one 8,192-lane tile)",
            "route": "cuda", "source": "cuda_pt_torch/csrc/extract_ab.cu",
            "replaces": "scripts/exp_extract_ab.py:232", "launches": s2["launches"],
            "max_abs_err": s2["max_abs_err"], "ms": v0["ms"], "plain_ms": s2["hold_plain_ms"]["v0"],
            "bound_ms": v0["bound_ms"], "bound_by": v0["bound_by"], "library_ms": None,
            "c_node_ns": v0["c_node_ns"], "hold_ms": s2["hold_ms"], "cluster": v0["cluster"],
            **({"parent_c_node_ns": v0_turns["parent_ms"], "this_c_node_ns": v0_turns["this_ms"]}
               if v0_turns else {}),
            "variants": {label: {sc: {t: {k: r[k] for k in pick} for t, r in tags.items()}
                                 for sc, tags in s2[label].items()}
                         for label in ("reference", "card_scale")},
            "turns_c_node_ns": turns, "cluster_sizes": s2["cluster_sizes"],
            "note": "ms: a launch of 30,000 steps; plain_ms and hold_ms: the plain version and "
                    "the kernel on the hold's 2 tiles x S2_HOLD_ITERS steps; launches: the "
                    "entry at the reference's shape; cluster: the blocks per tile the launch "
                    "took; turns_c_node_ns: ns per step of each tag, the parent's kernel and "
                    "this one in turns (--parent)"}


def s3_entry(s3: dict) -> dict:
    """The results line's S3 entry: the check gather at the reference's
    (64, 128) against torch.take_along_dim; the timed tags beside it."""
    ref, card = s3["hold_reference"], s3["hold_card_scale"]
    pick = ("gather_ms", "gather_cold_ms", "launch_floor_ms", "gather_plain_ms", "library_ms",
            "library_cold_ms", "bound_ms", "bound_by", "lanes")
    parent = {label: {w: {k: r[k] for k in ("parent_ms", "this_ms")} for w, r in h["parent"].items()}
              for label, h in (("reference", ref), ("card_scale", card)) if "parent" in h}
    return {"name": "lanegather (S3 gather, (64, 128))", "route": "cuda",
            "source": "cuda_pt_torch/csrc/lanegather.cu",
            "replaces": "scripts/exp_lanegather.py:57", "launches": s3["launches"],
            "max_abs_err": s3["max_abs_err"], "ms": ref["gather_ms"],
            "plain_ms": ref["gather_plain_ms"], "bound_ms": ref["bound_ms"],
            "bound_by": ref["bound_by"], "library_ms": ref["library_ms"],
            "cold_ms": ref["gather_cold_ms"], "launch_floor_ms": ref["launch_floor_ms"],
            "card_scale": {k: card[k] for k in pick}, "parent": parent,
            "per_iter_ns": {label: s3[label]["per_iter_ns"] for label in ("reference", "card_scale")},
            "summary": {label: s3[label]["summary"] for label in ("reference", "card_scale")},
            "note": "ms: one launch of the check form (kern_chk, :100), timed alone after a device "
                    "sleep, warm (its inputs in L2); cold_ms: L2 flushed before each launch; "
                    "launch_floor_ms: an empty kernel on the gather's grid; per_iter_ns: the "
                    "timed tags (:57), a launch over REPS; parent: the parent tree's gather "
                    "and this one's in turns (--parent)"}


def s4_entry(s4: dict) -> dict:
    """The results line's S4 entry: mxu (3xTF32) at the reference's 4,096
    rays x 2,000 leaves against the batched torch.matmul of its product;
    scalar, the 1xTF32 A/B and the card's scale beside it."""
    forms = s4["reference"]["forms"]
    held = s4["hold_reference"]
    pick = ("ms", "ns_per_leaf", "ns_per_prim_lane", "bound_ms", "bound_by")
    parent = s4.get("parent", {})
    return {"name": "mxuleaf (S4 mxu, 3xTF32 wgmma, 4,096 rays x 2,000 leaves)",
            "route": "cuda", "source": "cuda_pt_torch/csrc/mxuleaf.cu",
            "replaces": "scripts/exp_r5_mxuleaf.py:176", "launches": s4["launches"],
            "max_abs_err": held["max_abs_err"], "ms": forms["mxu"]["ms"],
            "plain_ms": held["plain_mxu_ms"], "bound_ms": forms["mxu"]["bound_ms"],
            "bound_by": forms["mxu"]["bound_by"], "library_ms": s4["library_ms"],
            "forms": {label: {f: {k: r[k] for k in pick} for f, r in s4[label]["forms"].items()}
                      for label in ("reference", "card_scale")},
            "parity": held["parity_plain"], "parity_scalar": held["parity_scalar"],
            "parity_1xtf32": held["parity_1xtf32"], "plain_scalar_ms": held["plain_scalar_ms"],
            "parent_ms": parent.get("reference", {}).get("mxu", {}).get("parent_ms"),
            "parent": parent,
            "note": "launches: wrapper calls, each two kernel launches (the split prologue, "
                    "then the product), both inside ms; library_ms: the batched torch.matmul "
                    "(2000, 32, 16) x (16, 4096) in f32 (allow_tf32 False), product only, no "
                    "epilogue; max_abs_err: mxu against the plain product on lanes finite in "
                    "both; parent: the parent tree's mxu on the same inputs, in turns "
                    "(--parent)"}


def whole_path_pass(mk, r, md):
    """A pass of the Renderer's scene through the whole-path kernel
    (auto_trace bypassed): sample 0's pcg streams and camera rays over the
    Z-order lanes (made once, as the Renderer caches them), then one
    trace_megakernel."""
    from cuda_pt_torch.core import camera as cam_mod
    from cuda_pt_torch.core import qmc

    perm, _ = mk.tile_swizzle(r.camera.width, r.camera.height, r.device)

    def run():
        rng = qmc.make_state("pcg", 0, perm, 0)
        o, d, rng = cam_mod.generate_rays(r.camera, perm, rng)
        mk.trace_megakernel(r._pack, md, o, d, rng)

    return run


def phase_profile(run, passes: int = 4) -> dict:
    """Device time by kernel over a few passes of run() (torch.profiler,
    CUPTI), after one warm-up profile; the device busy share is the summed
    kernel time over the wall of the same passes run without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(passes):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / passes
    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(passes):
                run()
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
    ap.add_argument("--parent", default=None,
                    help="another checkout (git archive of the parent commit) whose K1-K6, "
                         "S1-S3 and S4 mxu are held to and timed against this tree's on the same "
                         "inputs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chip_smoke: CUDA is not available")
        return 1
    from cuda_pt_torch.ops import cuda_build as cb

    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    build = phase_build(cb)
    start_parent(cb, args)
    sass_job = start_sass(cb)
    try:
        return run_phases(args, build, sass_job)
    finally:
        sass_job["stop"]()


def run_phases(args, build: dict, sass_job: dict) -> int:
    """Phases 2-16 and the result lines, after the build (phase 1)."""
    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
    from cuda_pt_torch.ops import extract_ab as ab
    from cuda_pt_torch.ops import lanegather as lg
    from cuda_pt_torch.ops import megakernel as mk
    from cuda_pt_torch.ops import mxuleaf as mx
    from cuda_pt_torch.ops import node_bench as nb
    from cuda_pt_torch.ops import traverse_kernel as tk
    from cuda_pt_torch.scene import testscenes as tts
    from cuda_pt_torch.scene import types as T
    from cuda_pt_torch.scene.builder import BSDFSpec
    from cuda_pt_torch.scene.xml_parser import ParsedScene

    dev = torch.device("cuda")
    card = phase_card()
    walk = phase_walk(mk, tts, dev)
    walk_k, kscene, kcam, build_s = phase_walk_kitchen(mk, tts, dev)
    # K1's kitchen forests build on the host in two worker processes while
    # phases 4-8 run on the card
    pool = ProcessPoolExecutor(max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    try:
        geom_cpu = T.to_device(kscene.geom, "cpu")
        forest_jobs = {fmt: pool.submit(_forest_job, geom_cpu, fmt) for fmt in ("f32", "bf16")}
        res4 = phase_kernel(mk, tts, dev, MaxDepthParams, BSDFSpec, T)
        res4_media = phase_kernel_media(mk, tts, dev, MaxDepthParams, T)
        k2, r = phase_main(mk, tts, dev, args, MaxDepthParams, RenderingConfig, ParsedScene,
                           Renderer, res4["cornell"]["mean_plain"])
        k5_kitchen, k3, rk = phase_kitchen(mk, dev, args, kscene, kcam, build_s, MaxDepthParams,
                                           RenderingConfig, ParsedScene, Renderer)
        k5_vpt, k4, rv = phase_vpt(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig,
                                   ParsedScene, Renderer)
        k5_grid, k6 = phase_grid(mk, tts, dev, MaxDepthParams, RendererType, RenderingConfig,
                                 ParsedScene, Renderer)
        forests, forest_s = {}, {}
        for fmt, job in forest_jobs.items():
            forest, forest_s[fmt] = job.result()
            forests[fmt] = T.to_device(forest, dev)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    log(f"[9] kitchen forests (chunks of {FOREST_CHUNK} prims) built in worker processes: "
        f"{forest_s['f32']:.1f} s (f32 rows), {forest_s['bf16']:.1f} s (bf16 rows)")
    k1 = phase_k1(tk, tts, dev, kscene, kcam, forests, T, mk, rk._pack)
    k1_wf, rw = phase_wavefront(mk, tk, dev, kscene, kcam, forests["f32"],
                                k5_kitchen["image_mean"], MaxDepthParams, RendererType,
                                RenderingConfig, ParsedScene, Renderer)
    routes = phase_routes(mk, tk, tts, dev, rv.parsed.scene, rv.parsed.camera, MaxDepthParams,
                          RendererType, RenderingConfig, ParsedScene, Renderer)
    rm_cornell, rm_kitchen = phase_render_megakernel(mk, tk, tts, dev, kscene, kcam,
                                                     res4["cornell"]["mean_plain"], MaxDepthParams)
    s1 = phase_s1(mk, nb, tk, dev, {"cornell": tts.cornell_box(device=dev)[0],
                                    "kitchen": kscene})
    rm_cornell["s1_model_share"] = model_share(
        rm_cornell, s1["cornell"]["c_node_ns_per_fetch"], "render_megakernel cornell, K2+BIN")
    rm_kitchen["s1_model_share"] = model_share(
        rm_kitchen, s1["kitchen"]["c_node_ns_per_fetch"], "render_megakernel kitchen, K5 "
        "SEG+K3+ALL+BIN (c_node of the f32 rows; the pass walks bf16 rows)")
    s2 = phase_s2(mk, ab, nb, tk, dev, kscene, tts.cornell_box(device=dev)[0])
    s3 = phase_s3(mk, lg, dev)
    s4 = phase_s4(mk, mx, dev, sass_job)
    k1_lt, light, rl = phase_light(mk, tk, tts, dev, kscene, kcam, forests["f32"], T,
                                   MaxDepthParams, RendererType, RenderingConfig, ParsedScene,
                                   Renderer)
    seg = {"route": "cuda", "source": "cuda_pt_torch/csrc/seg.cuh",
           "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:3360", "library_ms": None}
    closest = k1["timing"]["closest"]
    # registers and spills of K5's instantiations on the main paths (phase 1)
    regs = {name: {"registers": r_, "spill_stores": st_, "spill_loads": ld_}
            for name, r_, st_, ld_ in build["ptxas"]}
    k5_kitchen.update(regs.get("seg_kernel<1,1,0,0,0,0,1>", {}))
    k5_vpt.update(regs.get("seg_kernel<0,1,1,0,0,0,1>", {}))
    # and of K2 (STAGE), K3 (CPT), K4 (CPT), K2+BIN and K1's per-ray form
    for row, inst in ((k2, "trace_kernel<0,0,0,0,0,1>"), (k3, "trace_kernel<1,1,0,0,1,0>"),
                      (k4, "trace_kernel<0,1,1,0,1,0>"),
                      (rm_cornell, "trace_kernel<0,0,0,1,1,0>"), (k1, "k1_kernel<0,0,0>")):
        row.update(regs.get(inst, {}))
    kernels = [
        k2, k3, k4,
        {"name": "trace_megakernel_seg (K5, kitchen_stress: SEG+K3+ALL+CPT, t9 prims, bf16 "
                 "attrs)", **seg, "source": "cuda_pt_torch/csrc/megakernel_seg_cpt.cu",
         **k5_kitchen},
        {"name": "trace_megakernel_seg (K5, medium_cbox: SEG+ALL+MED+CPT, t9 prims, bf16 attrs)",
         **seg, "source": "cuda_pt_torch/csrc/megakernel_seg_cpt.cu", **k5_vpt},
        {"name": "trace_megakernel_seg (K5 shade, grid_smoke: SEG+SHADE+ALL+MED+GRID)", **seg,
         **k5_grid},
        {"name": "traverse_resolve (K6, grid_smoke: walk and hit resolve)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/megakernel_split.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:3390", "library_ms": None, **k6,
         "note": "ms: per spp summed over the driver's K6 launches, each timed alone; "
                 "plain_ms: resolve_hit(traverse_plain) on the block; parent_ms: the parent's "
                 "K6 walk and resolve_hit per spp on the same states, in turns"},
        {"name": "traverse_forest (K1, kitchen_stress forest)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/traverse.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/traverse_kernel.py:561",
         "max_abs_err": max(k1[c]["max_abs_err_t"] for c in ("f32_camera", "f32_random")),
         "ms": closest["ms"], "plain_ms": k1["f32_camera"]["plain_ms"],
         "bound_ms": closest["bound_ms"], "bound_by": closest["bound_by"], "library_ms": None,
         "rays": kcam.width * kcam.height, "anyhit_ms": k1["timing"]["anyhit"]["ms"],
         "anyhit_bound_ms": k1["timing"]["anyhit"]["bound_ms"],
         "bf16_ms": k1["timing"]["closest_bf16"]["ms"],
         "bf16_anyhit_ms": k1["timing"]["anyhit_bf16"]["ms"], "node_fetches": closest["nodes"],
         "prim_tests": closest["prim_tests"], "warps": closest["warps"],
         **{k: k1[k] for k in ("registers", "spill_stores", "spill_loads") if k in k1},
         **({"parent_ms": k1["parent"]["closest"]["parent_ms"],
             "anyhit_parent_ms": k1["parent"]["anyhit"]["parent_ms"]} if "parent" in k1 else {}),
         **k1_wf, **k1_lt,
         "note": "ms, plain_ms and bound_ms: one closest-hit launch on the 1,048,576 camera "
                 "rays of kitchen_stress; main_path_*: summed over one wavefront spp; lt_*: "
                 "the light tracer's main path, one pass (lt_launches_per_pass over LT_SPP)"},
        {"name": "trace_megakernel (K2+BIN: render_megakernel, cornell, binary f32 nodes)",
         "route": "cuda", "source": "cuda_pt_torch/csrc/megakernel_bin.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:802", "library_ms": None,
         **rm_cornell},
        {"name": "trace_megakernel_seg (K5 SEG+K3+ALL+BIN: render_megakernel, kitchen_stress, "
                 "bf16 nodes, t9 prims, bf16 attrs)", **seg,
         "source": "cuda_pt_torch/csrc/megakernel_seg_bin.cu",
         "replaces": "cuda_pt_tpu/ops/pallas/megakernel.py:802", **rm_kitchen},
        {"name": "node_bench (S1, kitchen_stress f32 rows)", "route": "cuda",
         "source": "cuda_pt_torch/csrc/node_bench.cu", "replaces": "scripts/roofline.py:116",
         "library_ms": None, "launches": s1["launches"], **s1["kitchen"],
         "cornell": s1["cornell"],
         **next((v for k, v in regs.items() if k.startswith("node_bench_kernel")), {}),
         **({"parent_ms": s1["kitchen"]["parent"]["ms"]["parent_ms"]}
            if s1["kitchen"]["parent"] else {}),
         "note": "launches: S1's own phase (no render path runs it); ms: S1_ITERS steps on "
                 "S1_RAYS equal rays; parent: the parent tree's kernel and this one in turns "
                 "(--parent), ms and c_node (us per step)"},
        s2_entry(s2), s3_entry(s3), s4_entry(s4),
    ]
    for k in kernels:
        k.pop("runs", None)
    extra = {"k1_check": {k: v for k, v in k1.items() if k != "timing"}, "routes_check": routes,
             "light_check": light, "build": build}
    if args.profile:
        md = MaxDepthParams()
        for key, run in (("profile", r.render_raw), ("profile_kitchen", rk.render_raw),
                         ("profile_kitchen_whole_path", whole_path_pass(mk, rk, md)),
                         ("profile_vpt", rv.render_raw),
                         ("profile_vpt_whole_path", whole_path_pass(mk, rv, md)),
                         ("profile_wavefront", rw.render_raw),
                         ("profile_light", rl.render_raw)):
            log(f"[profile] {key}")
            extra[key] = phase_profile(run)
    # the two result lines carry no time prefix: each is one JSON object
    print(json.dumps({"kernels": kernels, "card": card, "walk_check": walk,
                      "walk_check_kitchen": walk_k, "kernel_check": res4,
                      "kernel_check_media": res4_media, **extra}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
