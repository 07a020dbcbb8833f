"""Distributed rendering driver (port of scripts/distributed_render.py): an
XML scene rendered by parallel/distributed.render_distributed over an
(sp, dp) mesh of torch.distributed ranks, the film accumulated on every
rank, progress lines and the PNG from rank 0.

Launch one process per rank with torchrun (it sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT):

  torchrun --nproc-per-node 2 -m cuda_pt_torch.distributed_render \\
      --xml scene.xml --spp 64 --sp 2 --out render.png

Renders on CUDA (NCCL, one device per rank) unless ``--device cpu`` is
passed (gloo); without a GPU the default raises.

``--tensorboard DIR``: rank 0 writes the reference's scalars
(render/mean_variance, render/ms_per_pass) and the image (render/image,
CHW) at each report, through torch.utils.tensorboard, imported only when
the flag is given; where the tensorboard package is absent the entry
stops at once, naming the flag and the package.

``--multihost``: one process per GPU on several hosts, as torchrun's
multi-node launch starts them (``--nnodes N --node-rank R
--rdzv-endpoint HOST:PORT``): the entry requires torchrun's multi-node
variables LOCAL_RANK, LOCAL_WORLD_SIZE and GROUP_RANK, raises naming any
that is missing, and renders on the GPU of LOCAL_RANK.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .core import film as film_mod
from .parallel import distributed as pdist
from .scene import types as T
from .scene.xml_parser import load_xml
from .utils.image import save_png


# torchrun's multi-node variables, which --multihost requires
MULTIHOST_VARS = ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK")


def _summary_writer():
    """torch.utils.tensorboard.SummaryWriter, or SystemExit naming the flag
    and the package where tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise SystemExit(f"--tensorboard needs the tensorboard package, which is not installed "
                         f"({e})") from None
    return SummaryWriter


def _device(arg: str | None) -> torch.device:
    if arg is not None:
        return torch.device(arg)
    if not torch.cuda.is_available():
        raise RuntimeError("distributed_render renders on CUDA, which is not available; pass "
                           "--device cpu to render on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--xml", required=True, help="scene xml path")
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--sp", type=int, default=1, help="sample-parallel axis size")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="render.png")
    ap.add_argument("--report-interval", type=int, default=16)
    ap.add_argument("--sampler", choices=["pcg", "sobol"], default="pcg",
                    help="sobol = Owen-scrambled QMC (lower equal-spp error)")
    ap.add_argument("--denoise", action="store_true",
                    help="variance-guided a-trous denoise of the final image")
    ap.add_argument("--tensorboard", default="",
                    help="log dir for TensorBoard image and variance curves (rank 0)")
    ap.add_argument("--multihost", action="store_true",
                    help="torchrun multi-node launch: needs LOCAL_RANK, LOCAL_WORLD_SIZE, "
                         "GROUP_RANK")
    ap.add_argument("--device", default=None, help="cpu: render on the CPU (default: CUDA)")
    args = ap.parse_args(argv)

    writer_cls = _summary_writer() if args.tensorboard else None
    if args.multihost:
        missing = [k for k in MULTIHOST_VARS if k not in os.environ]
        if missing:
            raise RuntimeError(f"--multihost needs torchrun's multi-node variables; missing "
                               f"{', '.join(missing)} (launch with torchrun --nnodes ...)")
    dev = _device(args.device)
    own_group = not dist.is_initialized()
    if own_group:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        _render(args, dev, writer_cls)
    finally:
        if own_group:
            dist.destroy_process_group()
    return 0


def _render(args, dev: torch.device, writer_cls=None) -> None:
    rank0 = dist.get_rank() == 0
    tb = writer_cls(args.tensorboard) if (writer_cls is not None and rank0) else None
    res = (args.width, args.height) if args.width and args.height else None
    ps = load_xml(args.xml, override_res=res)
    scene = T.to_device(ps.scene, dev)
    cam = ps.camera.to(dev)
    mesh = pdist.make_mesh(sp=args.sp, device_type=dev.type)
    sp = mesh.size(0)
    if rank0:
        print(f"[DIST] ranks={dist.get_world_size()} mesh=sp{sp}xdp{mesh.size(1)} "
              f"device={dev} scene prims={scene.geom.num_prims}", flush=True)

    film = film_mod.make_film(cam.height, cam.width, dev)
    t0 = time.perf_counter()
    passes = max(args.spp // max(args.sp, 1), 1)
    for i in range(passes):
        img = pdist.render_distributed(scene, cam, ps.config.md, sp, mesh, seed=args.seed,
                                       sampler=args.sampler, sample_base0=i * sp)
        film = film_mod.accumulate(film, img)
        if rank0 and ((i + 1) % args.report_interval == 0 or i == passes - 1):
            dt = time.perf_counter() - t0
            var = float(film_mod.variance(film).mean())
            print(json.dumps({"pass": i + 1, "elapsed_s": round(dt, 2),
                              "ms_per_pass": round(dt / (i + 1) * 1e3, 1),
                              "mean_variance": var}), flush=True)
            img8 = film_mod.export_numpy(film, ps.config.gamma)
            save_png(args.out, img8)
            if tb is not None:
                tb.add_scalar("render/mean_variance", var, i + 1)
                tb.add_scalar("render/ms_per_pass", dt / (i + 1) * 1e3, i + 1)
                tb.add_image("render/image", np.transpose(img8, (2, 0, 1)), i + 1)
    if tb is not None:
        tb.close()
    if args.denoise:
        from .models import debug_renderers
        from .models import denoise as dn
        from .models import path_tracer as pt

        aovs = debug_renderers.render_aovs(scene, cam, spp=4, seed=args.seed + 7919,
                                           use_bvh=scene.geom.num_prims
                                           > pt.BRUTE_FORCE_MAX_PRIMS)
        var = film_mod.variance(film) / max(film.count, 1)
        img = dn.atrous_denoise(film.mean, aovs, variance=var)
        out_dn = args.out.rsplit(".", 1)[0] + "_denoised.png"
        if rank0:
            save_png(out_dn, (film_mod.to_srgb(img, ps.config.gamma).cpu().numpy() * 255)
                     .astype("uint8"))
            print(f"[DIST] wrote {out_dn}", flush=True)
    if rank0:
        print(f"[DIST] wrote {args.out}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
