"""Build variants of the megakernel library and time them on one CUDA card.

    python3 tools/kernel_variants.py [FMAD:BLOCKS ...]

Each variant is the library of cuda_pt_torch/ops/cuda_build with two
settings replaced (``cuda_build.start_variant_build``): nvcc's FMA
contraction (``-fmad=true|false``) and MK_MIN_BLOCKS, the resident
128-thread blocks per SM the trace kernel is built for (its register
cap). Default variants: ``false:8 false:6 true:8``. All variants build in
parallel (one nvcc each) into build/cuda_pt_torch/.

For each variant, two rounds in turn: the kernel time of one 1024x1024
spp (CUDA events, 5 launches after a warm-up) on cornell_box, cornell_box
with a GGX-conductor tall box and full-size kitchen_stress; and the share
of one 65,536-lane block of kitchen's rays outside the per-lane contract
(allclose rtol 1e-4, atol 1e-5) against the plain version. Prints ptxas'
register and spill lines per variant, then one line per variant and round.
"""

from __future__ import annotations

import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from cuda_pt_torch.core import camera as cam_mod  # noqa: E402
from cuda_pt_torch.core import qmc  # noqa: E402
from cuda_pt_torch.core.config import MaxDepthParams  # noqa: E402
from cuda_pt_torch.ops import cuda_build as cb  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.scene import testscenes as tts  # noqa: E402
from cuda_pt_torch.scene import types as T  # noqa: E402
from cuda_pt_torch.scene.builder import BSDFSpec  # noqa: E402

SIZE = 1024
BLOCK = 65536


def build_variants(specs):
    """{name: library path}, every nvcc started at once."""
    started = {}
    for spec in specs:
        fmad, blocks = spec.split(":")
        started[f"fmad_{fmad}_blocks_{blocks}"] = cb.start_variant_build(fmad == "true",
                                                                         int(blocks))
    libs = {}
    for name, (proc, path) in started.items():
        libs[name] = cb.finish_build(proc, path)
        regs = [ln.replace("ptxas info    :", "").strip()
                for ln in cb.build_log(path).splitlines() if "registers" in ln or "spill" in ln]
        print(name, regs, flush=True)
    return libs


def events_ms(fn, reps: int = 5) -> float:
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: CUDA is not available")
    libs = build_variants(sys.argv[1:] or ["false:8", "false:6", "true:8"])
    dev = torch.device("cuda")
    md = MaxDepthParams()
    gold = BSDFSpec(btype=T.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444), k=(3.983, 2.386, 1.603),
                    roughness_x=0.2, roughness_y=0.2)
    scenes = {"cornell": tts.cornell_box(SIZE, SIZE, device=dev),
              "gold": tts.cornell_box(SIZE, SIZE, tall_box_bsdf=gold, device=dev),
              "kitchen": tts.kitchen_stress(SIZE, SIZE, device=dev)}
    perm, inv = mk.tile_swizzle(SIZE, SIZE, dev)
    rays = {}
    for name, (scene, cam, _) in scenes.items():
        rng = qmc.make_state("pcg", 0, perm, 0)
        o, d, rng = cam_mod.generate_rays(cam, perm, rng)
        rays[name] = (mk.make_pack(scene, node_fmt="w8"), o, d, mk.rng_bits(rng), rng)
    pack, o, d, _, rng = rays["kitchen"]
    k0 = int(inv[(SIZE // 2) * SIZE + SIZE // 2]) // BLOCK * BLOCK
    ob, db, rb = (x[k0:k0 + BLOCK].contiguous() for x in (o, d, rng))
    t0 = time.perf_counter()
    L_p = mk.trace_megakernel_reference(pack, md, ob, db, rb)
    torch.cuda.synchronize()
    print(f"plain version, kitchen block of {BLOCK} lanes: {time.perf_counter() - t0:.1f} s",
          flush=True)
    for rnd in range(2):
        for name, path in libs.items():
            cb.use_library(path)  # the wrapper launches this variant
            row = [f"round {rnd} {name}"]
            for sn, (pk, o_, d_, r32, _) in rays.items():
                row.append(f"{sn} {events_ms(lambda: mk.trace_megakernel(pk, md, o_, d_, r32)):.3f} ms")
            L_k = mk.trace_megakernel(pack, md, ob, db, rb)
            close = torch.isclose(L_k, L_p, rtol=1e-4, atol=1e-5).all(dim=-1)
            row.append(f"kitchen block lanes differ {float((~close).float().mean()):.5f}, means "
                       f"differ by {abs(float(L_k.mean() - L_p.mean())):.3g}")
            print(" | ".join(row), flush=True)


if __name__ == "__main__":
    main()
