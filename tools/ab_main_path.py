"""Main-path timing of the surface Renderer for one package tree.

    python3 tools/ab_main_path.py TREE [cornell|kitchen]

TREE is the root of a checkout holding cuda_pt_torch/ (this repository, or
an unpacked parent commit to compare against). Renders cornell_box (the
default; 64-spp renders) or full-size kitchen_stress (16-spp renders) at
1024x1024 through api.Renderer on the CUDA card and prints one line: the
least wall ms per spp of four renders, the device ms and kernel launches
per pass from torch.profiler, and the kernel time of one spp of the main
path's rays (CUDA events, 20 launches). Run it for two trees in turns
inside one call (parent, change, change, parent) to compare them on one
card.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from cuda_pt_torch.api import Renderer  # noqa: E402
from cuda_pt_torch.core import camera as cam_mod  # noqa: E402
from cuda_pt_torch.core import qmc  # noqa: E402
from cuda_pt_torch.core.config import MaxDepthParams, RenderingConfig  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.scene import testscenes as tts  # noqa: E402
from cuda_pt_torch.scene.xml_parser import ParsedScene  # noqa: E402

SCENE = sys.argv[2] if len(sys.argv) > 2 else "cornell"
SIZE = 1024
SPP = {"cornell": 64, "kitchen": 16}[SCENE]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_main_path: CUDA is not available")
    if not mk.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mk.__file__}, not the tree at {ROOT}")
    md = MaxDepthParams()
    make = tts.cornell_box if SCENE == "cornell" else tts.kitchen_stress
    scene, cam, _ = make(SIZE, SIZE)
    r = Renderer(ParsedScene(scene, cam, RenderingConfig(width=SIZE, height=SIZE, md=md, seed=0)))
    r.render(2)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(SPP)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / SPP)
    for _ in range(2):  # the first profile pays CUPTI's start-up; keep the second
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                r.render_raw()
            torch.cuda.synchronize()
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    perm, _ = mk.tile_swizzle(SIZE, SIZE, r.device)
    o, d, rng = cam_mod.generate_rays(r.camera, perm, qmc.make_state("pcg", 0, perm, 0))
    rb = mk.rng_bits(rng)
    mk.trace_megakernel(r._pack, md, o, d, rb)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(20):
        mk.trace_megakernel(r._pack, md, o, d, rb)
    t1.record()
    torch.cuda.synchronize()
    print(f"{ROOT} {SCENE}: wall {min(walls):.3f} ms/spp (runs {[round(w, 3) for w in walls]}), device "
          f"{sum(u for u, _ in rows) / 4e3:.3f} ms/pass, {sum(n for _, n in rows) / 4:.0f} "
          f"launches/pass, kernel {t0.elapsed_time(t1) / 20:.4f} ms/spp", flush=True)


if __name__ == "__main__":
    main()
