"""Capture a profiler trace of a render (port of scripts/profile_render.py).

torch.profiler (CPU and, on the card, CUDA activities) around one
models/path_tracer.render call on the chosen walk, after a warm call:
--impl xla (the skip walk), wide (the 8-wide walk), pallas (kernel K1 over
the BVH as one chunk) or auto (accel/autotune's pick). Writes a Chrome
trace (trace.json under --out, by default a directory under the temporary
directory) and prints the device operations that took the most time.

  python -m cuda_pt_torch.scripts.profile_render [--scene cornell|bunny|whiskey]
      [--impl xla|wide|pallas|auto] [--spp 4] [--width 256] [--out DIR]
      [--device cpu]

bunny and whiskey are the reference's XMLs (REFERENCE_XML_DIR in
scripts/__init__.py). View the trace in chrome://tracing or Perfetto.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..utils.timing import device_of, force
from . import add_device_arg, reference_xml

TOP = 10  # device operations printed


def build(scene_name: str, impl: str, width: int, device):
    """(scene, camera) with the walk of impl pinned."""
    from ..models import path_tracer as pt
    from ..scene import testscenes
    from ..scene import types as T

    if scene_name == "cornell":
        scene, cam, _ = testscenes.cornell_box(width=width, height=width, device=device)
    else:
        from ..scene.xml_parser import load_xml

        ps = load_xml(reference_xml(f"{scene_name}.xml"), override_res=(width, width))
        scene, cam = T.to_device(ps.scene, device), ps.camera.to(device)
    if impl == "wide":
        from ..accel.wide_build import with_wide

        scene = with_wide(scene)
    elif impl == "auto":
        from ..accel.autotune import with_tuned_traversal

        scene = with_tuned_traversal(scene, cam)
    else:
        scene.traversal = impl
        if impl == "pallas":  # K1's rows packed once, as the Renderer packs them
            scene.forest = pt.pallas_forest(scene)
    return scene, cam


def profile(scene_name: str = "cornell", impl: str = "xla", sampler: str = "pcg", spp: int = 4,
            width: int = 256, out: str | None = None, device=None) -> dict:
    """Profile one render; returns {"ms", "trace", "top": [(name, device
    us, calls), ...]}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from ..core.config import MaxDepthParams
    from ..models import path_tracer as pt

    dev = torch.device(device or "cpu")
    scene, cam = build(scene_name, impl, width, dev)
    md = MaxDepthParams(max_depth=5)

    def fn(seed):
        with torch.no_grad():
            img = pt.render(scene, cam, md, spp=spp, seed=seed, use_bvh=True, sampler=sampler)
        force(img)
        return img

    print(f"[PROFILE] device={dev} scene={scene_name} impl={impl} {width}^2 x {spp} spp - "
          f"warm call...", flush=True)
    fn(0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn(1)
        dt = time.perf_counter() - t0
    out = out or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(out, exist_ok=True)
    trace = os.path.join(out, "trace.json")
    prof.export_chrome_trace(trace)
    kind = DeviceType.CUDA if dev.type == "cuda" else DeviceType.CPU
    rows = sorted(((e.self_device_time_total if dev.type == "cuda" else e.self_cpu_time_total,
                    e.key, e.count) for e in prof.key_averages() if e.device_type == kind),
                  reverse=True)
    top = [(k, us, n) for us, k, n in rows[:TOP] if us > 0]
    print(f"[PROFILE] {dt * 1e3:.1f} ms/frame; trace written to {trace}")
    for k, us, n in top:
        print(f"[PROFILE]   {us / 1e3:9.3f} ms  x{n:<6d} {k[:90]}")
    print(f"[PROFILE] view: load {trace} in chrome://tracing or Perfetto")
    return {"ms": dt * 1e3, "trace": trace, "top": top}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="cornell", choices=["cornell", "bunny", "whiskey"])
    ap.add_argument("--impl", default="xla", choices=["xla", "wide", "pallas", "auto"])
    ap.add_argument("--sampler", default="pcg", choices=["pcg", "sobol"])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "torch-trace"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    profile(args.scene, args.impl, args.sampler, args.spp, args.width, args.out, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
