"""Serial / animation rendering driver (port of scripts/serial_render.py,
the reference's scripts/serial_render.py).

Renders frame sequences by (a) swapping the grid-volume density and
emission sources between frames (volume animation, reference :59-79,
207-225), (b) sweeping a time-of-flight window across [t_min, t_max] (ToF
video, reference :227-240), or (c) rendering the scene as it is (static).
Each frame gets a fresh api.Renderer (seed_offset = seed + frame * 4201)
and writes a PNG and a film checkpoint (.npz); a frame whose PNG exists is
skipped, so a crashed run resumes at frame granularity (reference
:188-201).

  python -m cuda_pt_torch.scripts.serial_render --xml scene.xml --mode tof \\
      --frames 48 --tof-start 2 --tof-end 14 --tof-width 0.5 --spp 32
  python -m cuda_pt_torch.scripts.serial_render --xml scene.xml --mode volume \\
      --density-pattern '../volume/density-{:02d}.nvdb' --frames 10

On the card the frames take the Renderer's routes: static frames the
kernel routes (K2 below 512 boxes, K5 above), volume frames of a grid
scene K6 and K5's shade form (an emissive grid the composed route), ToF
frames the composed route.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..utils.timing import device_of
from . import add_device_arg


def _fit(vol: np.ndarray, shape) -> np.ndarray:
    """vol padded with zeros or cropped into shape (D, H, W)."""
    out = np.zeros(shape, np.float32)
    dz, dy, dx = vol.shape
    out[:dz, :dy, :dx] = vol[: shape[0], : shape[1], : shape[2]]
    return out


def volume_frame(ps, base_dir: str, density_pattern: str, emission_pattern: str, frame: int):
    """ps with grid 0's density (and emission) loaded from this frame's files
    (paths relative to base_dir), padded or cropped into the compiled grid's
    shape; majorant and avg_density from the padded density."""
    from ..media.nvdb import load_dense
    from ..scene.xml_parser import ParsedScene

    g = ps.scene.grids
    path = os.path.normpath(os.path.join(base_dir, density_pattern.format(frame)))
    pad = _fit(load_dense(path)[0], tuple(g.density.shape[1:]))
    density, majorant, avg = g.density.clone(), g.majorant.clone(), g.avg_density.clone()
    density[0] = torch.from_numpy(pad)
    majorant[0] = float(pad.max())
    avg[0] = float(pad.mean())
    grids = dataclasses.replace(g, density=density, majorant=majorant, avg_density=avg)
    if emission_pattern:
        epath = os.path.normpath(os.path.join(base_dir, emission_pattern.format(frame)))
        emission = g.emission.clone()
        emission[0] = torch.from_numpy(_fit(load_dense(epath)[0], pad.shape))
        grids = dataclasses.replace(grids, emission=emission)
    return ParsedScene(dataclasses.replace(ps.scene, grids=grids), ps.camera, ps.config,
                       ps.builder)


def tof_frame(ps, start: float, end: float, width: float, frame: int, frames: int):
    """ps with the ToF window of this frame: [t_lo, t_lo + width], t_lo
    swept from start to end - width."""
    from ..scene.xml_parser import ParsedScene

    t_lo = start + (end - start - width) * frame / max(frames - 1, 1)
    md = dataclasses.replace(ps.config.md, min_time=t_lo, max_time=t_lo + width)
    return ParsedScene(ps.scene, ps.camera, dataclasses.replace(ps.config, md=md), ps.builder)


def render_frames(xml: str, mode: str = "tof", frames: int = 16, spp: int = 16, width: int = 0,
                  height: int = 0, out_dir: str = "frames", seed: int = 0,
                  tof_start: float = 0.0, tof_end: float = 10.0, tof_width: float = 0.5,
                  density_pattern: str = "", emission_pattern: str = "", sampler: str = "pcg",
                  traversal: str | None = None, device=None) -> list:
    """Render the frames not on disk yet; returns the JSON record of each
    frame rendered. traversal: the Renderer's (None, its default route)."""
    from ..api import Renderer
    from ..scene.xml_parser import load_xml

    os.makedirs(out_dir, exist_ok=True)
    res = (width, height) if width and height else None
    ps = load_xml(xml, override_res=res)
    base_dir = os.path.dirname(os.path.abspath(xml))
    done = []
    for frame in range(frames):
        out_png = os.path.join(out_dir, f"frame_{frame:04d}.png")
        if os.path.exists(out_png):
            print(f"[SERIAL] frame {frame} exists, skipping (resume)")
            continue
        t0 = time.perf_counter()
        if mode == "tof":
            ps_frame = tof_frame(ps, tof_start, tof_end, tof_width, frame, frames)
        elif mode == "volume" and density_pattern:
            ps_frame = volume_frame(ps, base_dir, density_pattern, emission_pattern, frame)
        else:
            ps_frame = ps
        r = Renderer(ps_frame, seed_offset=seed + frame * 4201, sampler=sampler,
                     traversal=traversal, device=device)
        r.render(spp=spp)
        r.save(out_png)
        r.save_checkpoint(os.path.join(out_dir, f"frame_{frame:04d}.npz"))
        done.append({"frame": frame, "spp": spp, "sec": round(time.perf_counter() - t0, 2),
                     "out": out_png})
        print(json.dumps(done[-1]), flush=True)
    print(f"[SERIAL] done: {frames} frames in {out_dir}")
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--xml", required=True)
    ap.add_argument("--mode", choices=["tof", "volume", "static"], default="tof")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--out-dir", default="frames")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tof-start", type=float, default=0.0)
    ap.add_argument("--tof-end", type=float, default=10.0)
    ap.add_argument("--tof-width", type=float, default=0.5)
    ap.add_argument("--density-pattern", default="",
                    help="per-frame grid density path, e.g. 'density-{:02d}.nvdb'")
    ap.add_argument("--emission-pattern", default="")
    ap.add_argument("--sampler", choices=["pcg", "sobol"], default="pcg")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    render_frames(args.xml, args.mode, args.frames, args.spp, args.width, args.height,
                  args.out_dir, args.seed, args.tof_start, args.tof_end, args.tof_width,
                  args.density_pattern, args.emission_pattern, args.sampler, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
