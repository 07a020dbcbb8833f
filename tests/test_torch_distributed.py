"""parallel/distributed.py on torch.distributed, held on the CPU: one spawn
of two gloo ranks (tests/torch_dist_worker.py) runs every case once, and
each test reads its results.

- dp = 2 (sp 1) is bit-equal to the single-process render of the same
  streams for "pt", "wfpt", "vpt" (compacted) and "fused" (the kernel's
  plain version on the CPU): each lane renders alone, and the sums run in
  the same order; sp = 2 (dp 1) sums two sample windows first, so it is
  held to rtol 1e-5, atol 1e-7. Both ranks hold the same image.
- "pt" with dp = 2 against the reference's render_distributed on its
  8-device mesh: per lane allclose (rtol 1e-4, atol 1e-5) on >= 95 % of
  pixels, means within 1e-3 relative.
- sample_base0 windows [0, 2) and [2, 4) average to the [0, 4) render
  (atol 2e-4, the reference's bound).
- render_train_step: loss and gradients equal on both ranks and, within
  rtol 1e-4 (atol 1e-7), to the single-process gradients of the same
  loss; remat gives the plain step's.
- the spp % sp and sobol + fused errors; make_mesh without a group or
  without CUDA; the torchrun entry on one rank, 8x8."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_dist_worker as wk
from cuda_pt_torch.core import camera as cam_mod
from cuda_pt_torch.core import qmc
from cuda_pt_torch.models import path_tracer as t_pt
from cuda_pt_torch.models import volume_pt as t_vpt
from cuda_pt_torch.models import wavefront as t_wf
from cuda_pt_torch.ops import megakernel as t_mk
from cuda_pt_torch.parallel import distributed as pdist
from cuda_pt_tpu.core.config import MaxDepthParams as JMD
from cuda_pt_tpu.parallel import distributed as j_dist
from cuda_pt_tpu.scene import testscenes as j_ts

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two ranks started (one spawn): (processes, their logs, the output
    directory); stopped at the module's end if they still run."""
    out = str(tmp_path_factory.mktemp("dist"))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    # each rank's output to a file: a full pipe would stall a rank inside a collective
    logs = [os.path.join(out, f"rank{r}.log") for r in range(2)]
    procs = []
    try:
        for r, path in enumerate(logs):
            with open(path, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), str(r), "2",
                     str(port), out], env=env, stdout=f, stderr=subprocess.STDOUT))
        yield procs, logs, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(spawned, single, jax_mesh):
    """The two ranks' results (dicts of arrays). It asks for the module's
    single-process and JAX references first, so that they are computed here
    while the ranks run."""
    procs, logs, out = spawned
    for p in procs:
        p.wait(timeout=300)
    for p, path in zip(procs, logs):
        with open(path) as f:
            assert p.returncode == 0, f.read()[-3000:]
    return [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]


@pytest.fixture(scope="module")
def jax_mesh():
    """The reference's render_distributed on its 8-device mesh (1 x 8: 195
    lanes padded to 200), the ranks' streams."""
    sj, cj, _ = j_ts.cornell_box(width=wk.W, height=wk.H)
    return np.asarray(j_dist.render_distributed(sj, cj, JMD(max_depth=wk.MD.max_depth), wk.SPP,
                                                j_dist.make_mesh(sp=1), seed=wk.SEED))


@pytest.fixture(scope="module")
def single():
    """The single-process renders of the same streams, by renderer."""
    scene, cam, pack, vscene, vcam = wk.scenes()
    md, spp, seed = wk.MD, wk.SPP, wk.SEED
    B = cam.width * cam.height
    lane = torch.arange(B)
    fused = torch.zeros((B, 3))
    for i in range(spp):
        o, d, rng = cam_mod.generate_rays(cam, lane, qmc.make_state("pcg", seed, lane, i))
        fused = fused + t_mk.trace_megakernel(pack, md, o, d, rng)
    return {"pt": t_pt.render(scene, cam, md, spp, seed=seed),
            "wfpt": t_wf.render(scene, cam, md, spp, seed=seed, compact=True),
            "vpt": t_vpt.render(vscene, vcam, wk.VPT_MD, spp, seed=seed, compact=True),
            "fused": (fused / spp).reshape(cam.height, cam.width, 3)}


@pytest.mark.parametrize("renderer", ["pt", "wfpt", "vpt", "fused"])
def test_dp_and_sp_match_single_process(ranks, single, renderer):
    want = single[renderer].numpy()
    assert want.mean() > 0.01
    for r in ranks:
        np.testing.assert_array_equal(r[f"{renderer}_sp1"], want)
        np.testing.assert_allclose(r[f"{renderer}_sp2"], want, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ranks[0][f"{renderer}_sp2"], ranks[1][f"{renderer}_sp2"])


def test_dp_matches_jax_mesh(ranks, jax_mesh):
    """The reference's render_distributed on its 8-device mesh (jax_mesh)
    against the port's two dp bands."""
    want = jax_mesh
    got = ranks[0]["pt_sp1"]
    close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
    assert close.mean() >= 0.95, close.mean()
    assert abs(got.mean() - want.mean()) <= 1e-3 * want.mean()


def test_sample_windows_average_to_full_render(ranks):
    a, b, both = (ranks[0][k] for k in ("window0", "window2", "window_full"))
    assert np.abs(a - b).max() > 1e-3
    np.testing.assert_allclose((a + b) / 2, both, atol=2e-4)
    np.testing.assert_array_equal(ranks[1]["window_full"], both)


def test_train_step_grads_match_single_process(ranks):
    """The global MSE loss's gradients, on both ranks, against the
    single-process autograd of the same render and loss."""
    scene, cam = wk.scenes()[:2]
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in pdist.diff_params(scene).items()}
    img = t_pt.render(pdist.with_params(scene, params), cam, wk.MD, 2, seed=wk.SEED,
                      differentiable=True)
    loss = torch.mean(img ** 2)
    loss.backward()
    for sp in (1, 2):
        for r in ranks:
            np.testing.assert_allclose(r[f"loss_sp{sp}"], float(loss.detach()), rtol=1e-5)
            for k, p in params.items():
                want = p.grad.numpy() if p.grad is not None else np.zeros(p.shape)
                np.testing.assert_allclose(r[f"grad_sp{sp}_{k}"], want, rtol=1e-4, atol=1e-7,
                                           err_msg=f"sp{sp} {k}")
                np.testing.assert_array_equal(r[f"grad_sp{sp}_{k}"],
                                              ranks[0][f"grad_sp{sp}_{k}"])
    assert ranks[0]["grad_sp1_emission"][1].sum() > 0.0


def test_errors(ranks):
    assert bool(ranks[0]["spp_error"]) and bool(ranks[0]["sobol_fused_error"])
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_process_group"):
            pdist.make_mesh()


def test_make_mesh_needs_cuda_by_default(monkeypatch, tmp_path):
    """make_mesh(device_type=None) means CUDA and raises without it; the
    CPU is asked for with device_type="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            pdist.make_mesh()
        mesh = pdist.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("sp", "dp") and tuple(mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


def test_distributed_render_entry_one_rank(monkeypatch, tmp_path):
    """python -m cuda_pt_torch.distributed_render on one rank, 8x8, an XML
    cornell box (chip_smoke.py's writer): progress lines and the PNG."""
    import chip_smoke
    from cuda_pt_torch import distributed_render
    from cuda_pt_torch.scene import testscenes as t_ts
    from cuda_pt_torch.scene import types as TT

    _, _, b = t_ts.cornell_box(8, 8)
    xml = chip_smoke.write_scene_xml(TT, b, str(tmp_path), "cornell",
                                     dict(chip_smoke.XML_VIEWS["cornell"], fov=40.0), 8)
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(k, v)
    out = str(tmp_path / "out.png")
    assert distributed_render.main(["--xml", xml, "--spp", "2", "--width", "8", "--height",
                                    "8", "--out", out, "--device", "cpu", "--denoise"]) == 0
    assert os.path.getsize(out) > 0 and os.path.exists(str(tmp_path / "out_denoised.png"))
    assert not dist.is_initialized()
