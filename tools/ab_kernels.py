"""Whole-path kernel time of one package tree on w8 packs with f32 tables.

    python3 tools/ab_kernels.py TREE

TREE is the root of a checkout holding cuda_pt_torch/ (this repository, or
an unpacked earlier commit under the git-ignored build/). On the CUDA card
it packs cornell_box, full-size kitchen_stress and full-size medium_cbox
(the volume path tracer's pack) at 1024x1024 with w8 nodes and f32 attrs
and prims, the formats every tree takes, and prints one JSON line: per
scene the whole-path kernel's mean ms over 10 launches on one spp of the
camera rays (CUDA events, after a warm-up). Run it for two trees in turns
inside one call (parent, change, change, parent) to compare their kernel
code on one card.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from cuda_pt_torch.core import camera as cam_mod  # noqa: E402
from cuda_pt_torch.core import qmc  # noqa: E402
from cuda_pt_torch.core.config import MaxDepthParams  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.scene import testscenes as tts  # noqa: E402

SIZE = 1024
REPS = 10


def kernel_ms(pack, cam, md) -> float:
    perm, _ = mk.tile_swizzle(cam.width, cam.height, pack.device)
    rng = qmc.make_state("pcg", 0, perm, 0)
    o, d, rng = cam_mod.generate_rays(cam, perm, rng)
    bits = mk.rng_bits(rng)
    mk.trace_megakernel(pack, md, o, d, bits)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        mk.trace_megakernel(pack, md, o, d, bits)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: CUDA is not available")
    if not mk.__file__.startswith(ROOT):
        raise SystemExit(f"imported {mk.__file__}, not the tree at {ROOT}")
    dev = torch.device("cuda")
    md = MaxDepthParams()
    out = {"tree": ROOT}
    for name, make, vpt in (("cornell", tts.cornell_box, False),
                            ("kitchen", tts.kitchen_stress, False),
                            ("medium_cbox", tts.medium_cbox, True)):
        scene, cam, _ = make(SIZE, SIZE, device=dev)
        pack = mk.make_pack(scene, node_fmt="w8", attr_fmt="f32", prim_fmt="f32", vpt=vpt)
        out[name] = kernel_ms(pack, cam, md)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
