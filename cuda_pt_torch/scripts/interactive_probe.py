"""Interactive-rate probe: sustained api.Renderer frames per second (port
of scripts/interactive_probe.py).

The reference's interactive loop renders 1 spp per frame with live edits
(its app/viewer.cu:150-220). This measures that loop on cornell_box
through the Renderer's default route (kernel K2 on the card): N
successive render_raw() calls, each fenced by the film readback the viewer
would do, reporting fps and ms per frame, then a camera edit
(update_camera, which resets the film) and the first frame after it.

Writes INTERACTIVE_PROBE_torch.json in the current directory unless --out
says otherwise.

  python -m cuda_pt_torch.scripts.interactive_probe [--width 512]
      [--frames 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from ..utils.timing import device_of
from . import add_device_arg


def probe(width: int = 512, frames: int = 30, device=None) -> dict:
    from ..api import Renderer
    from ..core import camera as cam_mod
    from ..core.config import RenderingConfig
    from ..scene import testscenes
    from ..scene.xml_parser import ParsedScene
    from ..utils import timing

    dev = device or "cpu"
    warm = timing.warm_readback(device=dev) if str(dev) != "cpu" else 0.0
    W = width
    scene, cam, _ = testscenes.cornell_box(width=W, height=W)
    r = Renderer(ParsedScene(scene, cam, RenderingConfig(width=W, height=W), None), device=dev)
    info = r.info()

    r.render_raw()  # the first pass pays the kernels' build
    r.film.mean.cpu()
    t0 = time.perf_counter()
    for _ in range(frames):
        r.render_raw()
        r.film.mean.cpu()  # the viewer reads a preview back every frame
    dt = (time.perf_counter() - t0) / frames

    # a live camera edit resets the film; the first frame after it
    cam2 = cam_mod.make_camera(origin=(0.4, 0.55, -1.2), target=(0.5, 0.5, 0.5), fov=40.0,
                               width=W, height=W)
    r.update_camera(cam2)
    t1 = time.perf_counter()
    r.render_raw()
    r.film.mean.cpu()
    edit_frame_s = time.perf_counter() - t1
    return {
        "backend": r.device.type,
        "traversal": info["traversal"],
        "width": W,
        "spp_per_frame": 1,
        "warm_s": round(warm, 1),
        "ms_per_frame": round(dt * 1e3, 1),
        "fps": round(1.0 / dt, 1),
        "frames": frames,
        "ms_first_frame_after_camera_edit": round(edit_frame_s * 1e3, 1),
        "film_mean": float(r.film.mean.mean()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default="INTERACTIVE_PROBE_torch.json")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    out = probe(args.width, args.frames, dev)
    print(json.dumps(out))
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
