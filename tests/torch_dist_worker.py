"""One rank of tests/test_torch_distributed.py's gloo group on the CPU:
every case of parallel/distributed.py, its results in OUT/rank<r>.npz.

    python tests/torch_dist_worker.py RANK WORLD PORT OUT

Imports no JAX: the test holds these results to the single-process port
and to the reference."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from cuda_pt_torch.core.config import MaxDepthParams  # noqa: E402
from cuda_pt_torch.ops import megakernel as mk  # noqa: E402
from cuda_pt_torch.parallel import distributed as pdist  # noqa: E402
from cuda_pt_torch.scene import testscenes as ts  # noqa: E402

# an odd lane count (15 x 13 = 195), so the dp bands carry a padded lane
W, H, SPP, SEED = 15, 13, 4, 0
MD = MaxDepthParams(max_depth=3)
VPT_MD = MaxDepthParams(max_depth=4, max_volume=5)


def scenes():
    """(cornell, its camera, its fused pack, medium_box, its camera)."""
    scene, cam, _ = ts.cornell_box(W, H)
    vscene, vcam, _ = ts.medium_box(W, H)
    return scene, cam, mk.make_pack(scene, node_fmt="w8"), vscene, vcam


def cases(rank: int) -> dict:
    scene, cam, pack, vscene, vcam = scenes()
    out = {}
    for sp in (1, 2):
        mesh = pdist.make_mesh(sp=sp, device_type="cpu")
        for r in ("pt", "wfpt", "fused"):
            out[f"{r}_sp{sp}"] = pdist.render_distributed(scene, cam, MD, SPP, mesh, seed=SEED,
                                                          renderer=r, fused_pack=pack)
        out[f"vpt_sp{sp}"] = pdist.render_distributed(vscene, vcam, VPT_MD, SPP, mesh,
                                                      seed=SEED, renderer="vpt")
        loss, grads = pdist.render_train_step(scene, cam, MD, torch.zeros((H, W, 3)), mesh,
                                              spp=2, seed=SEED, remat=sp == 2)
        out[f"loss_sp{sp}"] = loss
        out.update({f"grad_sp{sp}_{k}": g for k, g in grads.items()})
        try:
            pdist.render_distributed(scene, cam, MD, 3, mesh) if sp == 2 else None
        except ValueError as e:
            out["spp_error"] = torch.tensor("divide evenly" in str(e))
    mesh = pdist.make_mesh(sp=1, device_type="cpu")
    for base in (0, 2):
        out[f"window{base}"] = pdist.render_distributed(scene, cam, MD, 2, mesh, seed=SEED,
                                                        sampler="sobol", sample_base0=base)
    out["window_full"] = pdist.render_distributed(scene, cam, MD, 4, mesh, seed=SEED,
                                                  sampler="sobol")
    try:
        pdist.render_distributed(scene, cam, MD, 2, mesh, renderer="fused", fused_pack=pack,
                                 sampler="sobol")
    except ValueError as e:
        out["sobol_fused_error"] = torch.tensor("pcg" in str(e))
    return out


def main(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        out = cases(rank)
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: v.detach().numpy() for k, v in out.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
