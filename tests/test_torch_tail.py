"""The port's tail modules against the reference: the viewer's camera
helpers (core/camera.move / rotate), utils/stats.py, the reference's
timing helpers in utils/timing.py, utils/image.encode_png, the lazy
top-level exports, and the distributed entry's --tensorboard and
--multihost flags. No JAX trace: the reference runs eagerly here.

Contracts: move / rotate within 1e-6 of JAX's on eager arrays (a new
float32 Camera on the camera's device); stats' output strings identical;
the timing helpers' keys, floors and fences; encode_png decoded equal to
its input, and to PIL's decode where PIL imports."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from cuda_pt_torch.core import camera as t_cam
from cuda_pt_torch.utils import image as t_image
from cuda_pt_torch.utils import stats as t_stats
from cuda_pt_torch.utils import timing as t_timing
from cuda_pt_tpu.core import camera as j_cam
from cuda_pt_tpu.utils import stats as j_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cams():
    args = ((0.3, 1.1, -2.0), (0.1, 0.4, 0.5))
    return j_cam.make_camera(*args, width=8, height=6), t_cam.make_camera(*args, width=8, height=6)


@pytest.mark.parametrize("steps", [
    [("move", [0.0, 0.0, 0.3])], [("move", [-0.1, 0.2, 0.05])],
    [("rotate", 0.2, -0.1)], [("rotate", -0.7, 0.35), ("move", [0.1, -0.1, 0.2])]])
def test_camera_move_rotate_match_reference(steps):
    cj, ct = _cams()
    for step in steps:
        if step[0] == "move":
            cj, ct = j_cam.move(cj, step[1]), t_cam.move(ct, step[1])
        else:
            cj, ct = j_cam.rotate(cj, *step[1:]), t_cam.rotate(ct, *step[1:])
    for f in ("R", "t"):
        got = getattr(ct, f)
        assert got.dtype == torch.float32 and got.device == torch.device("cpu")
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(cj, f)), rtol=0, atol=1e-6)
    assert torch.equal(ct.focal, _cams()[1].focal)
    # rotations stay orthonormal
    R = ct.R.double()
    assert torch.allclose(R.T @ R, torch.eye(3, dtype=torch.float64), atol=1e-6)


def test_stats_match_reference(capsys, monkeypatch):
    """TicToc, SlidingWindowAverage and print_progress print what the
    reference prints."""
    outs = []
    for mod in (t_stats, j_stats):
        # TicToc's clock reads: construction, tic, toc
        monkeypatch.setattr(mod.time, "perf_counter", iter([1.0, 1.25, 1.75]).__next__)
        t = mod.TicToc("bvh build")
        with t:
            pass
        w = mod.SlidingWindowAverage(window=3)
        for v in (1.0, 2.0, 3.0, 10.0):
            w.push(v)
        for i in range(3):
            mod.print_progress(i, 3, width=10, prefix="render ")
        outs.append((capsys.readouterr().out, t.elapsed_ms, w.mean, len(w.values)))
    assert outs[0] == outs[1]
    assert "[TIMER] bvh build: 500.00 ms" in outs[0][0] and outs[0][2] == 5.0
    assert t_stats.SlidingWindowAverage().mean == 0.0


def test_timing_helpers():
    """The reference's helpers on the CPU: force finds the first tensor of
    nested containers and dataclasses; timeit is floored at 1e-9;
    timeit_stats has the reference's keys; loop_cost differences two loop
    lengths; host_count runs on CPU copies and returns an int."""
    calls = []

    def fn(x):
        calls.append(1)
        return {"a": [x * 2.0], "b": (None,)}

    cam = _cams()[1]
    assert t_timing._first_tensor({"k": [None, (cam,)]}) is cam.R
    assert t_timing._first_tensor([None, 3]) is None
    t_timing.force(fn(torch.ones(3)))
    t_timing.force(cam)
    assert t_timing.timeit(lambda: None, reps=3) >= 1e-9
    calls.clear()
    st = t_timing.timeit_stats(fn, torch.ones(4), reps=4)
    assert len(calls) == 5  # one warm call, four timed
    assert set(st) == {"median", "mean", "std", "n", "samples"} and st["n"] == 4
    assert st["samples"] == sorted(st["samples"]) and len(st["samples"]) == 4
    assert st["std"] >= 0.0 and st["median"] >= 0.0
    st = t_timing.timeit_stats(fn, torch.ones(4), reps=2, warm=False, baseline=10.0)
    assert st["median"] == 0.0 and st["samples"] == [0.0, 0.0]
    per, t_n, t_half = t_timing.loop_cost(lambda s: s + 1.0, torch.zeros(8), n=10, reps=2)
    assert per >= 0.0 and t_n > 0.0 and t_half > 0.0
    assert 0.0 <= t_timing.fence_baseline(3) < 0.1

    seen = []

    def count(a, d):
        seen.append((a.device.type, d["x"].device.type))
        return (a > 0).sum() + d["x"].sum()

    n = t_timing.host_count(count, torch.arange(-2, 5), {"x": torch.tensor([3])})
    assert n == 7 and isinstance(n, int) and seen == [("cpu", "cpu")]


def test_encode_png_round_trip(tmp_path):
    """encode_png's bytes decode to the input (the port's decoder, and PIL's
    where it imports); floats round as the reference rounds them; save_png
    writes the same bytes."""
    rs = np.random.default_rng(2)
    for c in (3, 4):
        img = rs.integers(0, 256, size=(7, 5, c), dtype=np.uint8)
        data = t_image.encode_png(img)
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(t_image.decode_png(data), img)
        try:
            from PIL import Image
        except ImportError:
            continue
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
    f = rs.uniform(-0.1, 1.1, size=(3, 4, 3)).astype(np.float32)
    want = (np.clip(f, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(t_image.decode_png(t_image.encode_png(f)), want)
    path = str(tmp_path / "a.png")
    t_image.save_png(path, f)
    assert open(path, "rb").read() == t_image.encode_png(f)
    with pytest.raises(ValueError, match="not a PNG"):
        t_image.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        t_image.encode_png(np.zeros((4, 4), np.uint8))


def test_lazy_exports():
    """import cuda_pt_torch imports no torch (a fresh interpreter); the
    exports load on first use."""
    code = ("import sys, cuda_pt_torch as c; "
            "sys.exit('torch' in sys.modules or c.__version__ != '0.1.0')")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO).returncode == 0
    import cuda_pt_torch as c
    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.pyrender import PythonRenderer
    from cuda_pt_torch.scene.xml_parser import load_xml

    assert (c.Renderer, c.PythonRenderer, c.load_xml) == (Renderer, PythonRenderer, load_xml)
    with pytest.raises(AttributeError):
        c.nothing


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Writer:
    """A stand-in SummaryWriter recording its calls."""
    made = []

    def __init__(self, logdir):
        self.logdir, self.calls = logdir, []
        _Writer.made.append(self)

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step))

    def add_image(self, tag, img, step):
        self.calls.append(("image", tag, img.shape, img.dtype, step))

    def close(self):
        self.calls.append(("close",))


def test_distributed_entry_flags(monkeypatch, tmp_path):
    """--multihost raises naming the missing multi-node variables, then runs
    with them set; --tensorboard writes the reference's scalars and the
    CHW image from rank 0, and where the package is absent stops at once
    naming the flag and the package."""
    import chip_smoke
    from cuda_pt_torch import distributed_render
    from cuda_pt_torch.scene import testscenes as t_ts
    from cuda_pt_torch.scene import types as TT

    _, _, b = t_ts.cornell_box(8, 8)
    xml = chip_smoke.write_scene_xml(TT, b, str(tmp_path), "cornell",
                                     dict(chip_smoke.XML_VIEWS["cornell"], fov=40.0), 8)
    args = ["--xml", xml, "--spp", "2", "--width", "8", "--height", "8", "--device", "cpu",
            "--out", str(tmp_path / "out.png"), "--report-interval", "1"]
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "GROUP_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE, GROUP_RANK"):
        distributed_render.main(args + ["--multihost"])
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(SystemExit, match="--tensorboard needs the tensorboard package"):
        distributed_render.main(args + ["--tensorboard", str(tmp_path / "tb")])
    assert not dist.is_initialized()
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"), ("MASTER_ADDR", "127.0.0.1"),
                 ("MASTER_PORT", str(_free_port())), ("LOCAL_WORLD_SIZE", "1"),
                 ("GROUP_RANK", "0")):
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(distributed_render, "_summary_writer", lambda: _Writer)
    assert distributed_render.main(args + ["--multihost", "--tensorboard",
                                           str(tmp_path / "tb")]) == 0
    (w,) = _Writer.made
    assert w.logdir == str(tmp_path / "tb") and w.calls[-1] == ("close",)
    assert w.calls[:3] == [("scalar", "render/mean_variance", 1),
                           ("scalar", "render/ms_per_pass", 1),
                           ("image", "render/image", (3, 8, 8), np.dtype(np.uint8), 1)]
    assert len(w.calls) == 7 and not dist.is_initialized()
