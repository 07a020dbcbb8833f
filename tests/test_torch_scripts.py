"""The port's command-line tools (cuda_pt_torch/scripts/) against the JAX
scripts they port, on the same inputs, built here: scene_info and
serial_render (the JAX scripts run as subprocesses with --cpu, cwd and
every output under tmp_path) and analyze_rays (the JAX script's measure,
imported). The port pins traversal="xla" where a Renderer renders: JAX
fuses only off the CPU, and the port's CPU Renderer takes the kernel
routes' plain versions.

Tolerances, fixed before any run:
- scene_info: the JSON equal, floats within 1e-6 relative;
- serial_render, tof and volume at 8x8 x 2 frames x 2 spp: the frame files,
  and the JSON lines' frame, spp and basename of out, equal; the .npz film
  means allclose(rtol=1e-4, atol=1e-5) on >= 98 % of pixels; a second port
  call renders no frame;
- analyze_rays (16x16, spp 2, depth 6): each bounce's fraction within
  2 / 256 of JAX's.
The JAX references run concurrently (four subprocesses and one eager
measure: no jitted render in this process)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from cuda_pt_torch.scripts import analyze_rays, scene_info, serial_render
from cuda_pt_torch.scene import testscenes as t_ts
from test_media import _write_synthetic_nvdb
from test_torch_bridge import REPO, concurrently, jax_script
from test_torch_scene_input import _cornell_xml, _write_obj

RES, FRAMES, SPP = 8, 2, 2
TOF = ("--tof-start", "1.0", "--tof-end", "5.0", "--tof-width", "1.5")


def _run_jax(cwd, script: str, *args) -> str:
    """stdout of scripts/<script>.py --cpu ... run in cwd."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{script}.py"), *args,
                          "--cpu"], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _grid_xml(d) -> str:
    """A grid medium inside a closed box over a lit floor (VOLUME_PT),
    its density an 8^3 .nvdb."""
    rs = np.random.default_rng(5)
    dens = rs.uniform(0.0, 3.0, (8, 8, 8)).astype(np.float32)
    _write_synthetic_nvdb(os.path.join(d, "smoke.nvdb"), [((0, 0, 0), dens)], (0, 0, 0, 7, 7, 7))
    q = t_ts.quad
    _write_obj(os.path.join(d, "floor.obj"), q([-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]))
    _write_obj(os.path.join(d, "light.obj"),
               q([-.4, 2.5, -.4], [.4, 2.5, -.4], [.4, 2.5, .4], [-.4, 2.5, .4]))
    _write_obj(os.path.join(d, "box.obj"), t_ts._box_mesh((-0.6, 0.2, -0.6), (0.6, 1.4, 0.6)))
    return """<scene><renderer type="vpt"><integer name="max_bounce" value="4"/></renderer>
<brdf type="lambertian" id="white"><rgb name="k_d" value="0.7 0.7 0.7"/></brdf>
<brdf type="forward" id="null"/>
<phase type="hg" id="fwd"><float name="g" value="0.3"/></phase>
<medium type="grid" id="smoke"><rgb name="albedo" value="0.9 0.8 0.7"/>
  <string name="density" value="smoke.nvdb"/><float name="scale" value="2"/>
  <ref type="phase" id="fwd"/></medium>
<emitter type="area" id="light"><rgb name="emission" value="1 1 1"/>
  <float name="scaler" value="10"/></emitter>
<shape type="obj"><string name="filename" value="floor.obj"/><ref type="material" id="white"/>
</shape>
<shape type="obj"><string name="filename" value="light.obj"/><ref type="material" id="white"/>
  <ref type="emitter" id="light"/></shape>
<shape type="obj"><string name="filename" value="box.obj"/><ref type="material" id="null"/>
  <ref type="medium" id="smoke"/></shape>
<sensor><float name="fov" value="45"/>
  <transform><lookat origin="0, 1.2, -3.5" target="0, 0.7, 0"/></transform>
  <film><integer name="width" value="16"/><integer name="height" value="16"/></film>
</sensor></scene>
"""


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The cornell and grid XMLs, the per-frame densities (frame 0 padded
    into the compiled 8^3 grid, frame 1 cropped), and the JAX references:
    serial_render tof and volume and scene_info (subprocesses) and
    analyze_rays."""
    d = tmp_path_factory.mktemp("scripts")
    cornell = str(d / "cornell.xml")
    with open(cornell, "w") as f:
        f.write(_cornell_xml(str(d)))
    grid = str(d / "grid.xml")
    with open(grid, "w") as f:
        f.write(_grid_xml(str(d)))
    rs = np.random.default_rng(11)
    np.save(str(d / "dens-00.npy"), rs.uniform(0, 4, (6, 7, 5)).astype(np.float32))
    np.save(str(d / "dens-01.npy"), rs.uniform(0, 4, (10, 9, 8)).astype(np.float32))
    common = ("--frames", str(FRAMES), "--spp", str(SPP), "--width", str(RES), "--height",
              str(RES))
    jax_ar = jax_script("analyze_rays")
    refs = concurrently(
        tof=lambda: _run_jax(d, "serial_render", "--xml", cornell, "--mode", "tof", *common,
                             *TOF, "--out-dir", "jax_tof"),
        volume=lambda: _run_jax(d, "serial_render", "--xml", grid, "--mode", "volume", *common,
                                "--density-pattern", "dens-{:02d}.npy", "--out-dir",
                                "jax_volume"),
        rays=lambda: jax_ar.measure(cornell, 16, 2, 6),
        info_cornell=lambda: _run_jax(d, "scene_info", "--xml", cornell),
        info_grid=lambda: _run_jax(d, "scene_info", "--xml", grid))
    return {"dir": d, "cornell": cornell, "grid": grid, **refs}


def _close(a, b):
    return float(np.isclose(a, b, rtol=1e-6, atol=0).all())


def _json_equal(got, want, path="$"):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _json_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _json_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert _close(got, want), (path, got, want)
    else:
        assert got == want and type(got) is type(want), (path, got, want)


@pytest.mark.parametrize("which", ["cornell", "grid"])
def test_scene_info_matches_reference(scenes, which):
    """The JSON summary of each XML equal to the JAX script's."""
    want = json.loads(scenes[f"info_{which}"])
    got = scene_info.scene_info(scenes[which], "cpu")
    _json_equal(got, want)
    assert got["num_media"] >= 1 and got["bvh"]["num_nodes"] > 0


def _jax_lines(stdout: str) -> list:
    return [json.loads(ln) for ln in stdout.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("mode", ["tof", "volume"])
def test_serial_render_matches_reference(scenes, mode, capsys):
    d = scenes["dir"]
    out_dir = str(d / f"torch_{mode}")
    kw = dict(frames=FRAMES, spp=SPP, width=RES, height=RES, out_dir=out_dir,
              traversal="xla", device="cpu")
    if mode == "tof":
        kw.update(tof_start=1.0, tof_end=5.0, tof_width=1.5)
        done = serial_render.render_frames(scenes["cornell"], "tof", **kw)
    else:
        done = serial_render.render_frames(scenes["grid"], "volume",
                                           density_pattern="dens-{:02d}.npy", **kw)
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    assert printed == done
    want = _jax_lines(scenes[mode])
    key = lambda r: (r["frame"], r["spp"], os.path.basename(r["out"]))  # noqa: E731
    assert [key(r) for r in done] == [key(r) for r in want] and len(done) == FRAMES
    jax_dir = str(d / f"jax_{mode}")
    assert sorted(os.listdir(out_dir)) == sorted(os.listdir(jax_dir))
    means = []
    for frame in range(FRAMES):
        a = np.load(os.path.join(out_dir, f"frame_{frame:04d}.npz"))
        b = np.load(os.path.join(jax_dir, f"frame_{frame:04d}.npz"))
        assert int(a["count"]) == int(b["count"]) == SPP
        match = np.isclose(a["mean"], b["mean"], rtol=1e-4, atol=1e-5).all(axis=-1).mean()
        assert match >= 0.98, (mode, frame, match)
        means.append(float(a["mean"].mean()))
    assert all(np.isfinite(means)) and max(means) > 0.0
    # the resume: every PNG exists, so a second call renders nothing
    assert serial_render.render_frames(scenes["cornell"] if mode == "tof" else scenes["grid"],
                                       mode, density_pattern="dens-{:02d}.npy", **kw) == []
    assert capsys.readouterr().out.count("exists, skipping (resume)") == FRAMES


def test_serial_render_volume_frame_pads_and_crops(scenes):
    """Frame 0's 6x7x5 density padded and frame 1's 10x9x8 cropped into
    the compiled 8^3 grid, majorant and avg_density from the padded grid."""
    from cuda_pt_torch.scene.xml_parser import load_xml

    ps = load_xml(scenes["grid"])
    base = os.path.dirname(scenes["grid"])
    for frame in range(FRAMES):
        src = np.load(os.path.join(base, f"dens-{frame:02d}.npy"))
        g = serial_render.volume_frame(ps, base, "dens-{:02d}.npy", "", frame).scene.grids
        want = np.zeros((8, 8, 8), np.float32)
        n = [min(a, 8) for a in src.shape]
        want[:n[0], :n[1], :n[2]] = src[:n[0], :n[1], :n[2]]
        np.testing.assert_array_equal(g.density[0].numpy(), want)
        assert float(g.majorant[0]) == float(want.max())
        assert float(g.avg_density[0]) == float(np.float32(want.mean()))
    assert ps.scene.grids.density[0].shape == (8, 8, 8)  # the parsed scene untouched


def test_analyze_rays_matches_reference(scenes):
    got = analyze_rays.measure(scenes["cornell"], 16, 2, 6, device="cpu")
    want = np.asarray(scenes["rays"])
    assert got.shape == want.shape == (6,)
    assert np.abs(got - want).max() <= 2.0 / 256, (got, want)
    assert got[0] > 0.5 and np.all(np.diff(got) <= 0)
