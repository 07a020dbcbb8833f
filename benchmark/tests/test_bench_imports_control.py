"""What the benchmark imports, and its control.

Nothing the benchmark runs imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: cuda_pt_torch is not cuda_pt_tpu), and
the reference imports nothing of the program either: by a walk over every
module benchmark/ imports, and by sys.modules after a CPU dry run. The
control (the reference in bf16 in the program's place) fails the cells'
limits."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

import tiny_cell

BENCH = os.path.join(tiny_cell.REPO, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "cuda_pt_tpu"}


def _imports(path: str) -> set:
    """Absolute top-level names a file imports (relative imports stay in
    its package)."""
    out = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def _files(top: str, skip_tests: bool = True):
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if x != "__pycache__" and not (skip_tests and x == "tests")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_static_imports():
    for path in _files(BENCH):
        names = _imports(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert "cuda_pt_torch" not in names, path
            assert "benchmark" not in names, path


def _modules_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=tiny_cell.REPO)
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                       cwd=os.path.dirname(__file__), env=env, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_modules_after_a_cpu_dry_run(tmp_path):
    root = tiny_cell.make_root(tmp_path)
    mods = _modules_after(
        "import tiny_cell\nfrom benchmark import harness\n"
        f"r = harness.run_cell({tiny_cell.WORKLOAD!r}, 5, 0.2, True, device='cpu', "
        f"root={root!r})\nassert r['correct']")
    assert "cuda_pt_torch" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import tiny_cell, torch\nfrom benchmark.reference import plain_render as pr\n"
        "rs, _ = pr.make_scene({'scene': 'medium_cbox', 'scene_args': {'ns': 12, 'nt': 8}, "
        "'renderer': 'vpt'}, 8, 8, 'cpu')\n"
        "pr.pixel_paths(rs, 3, torch.arange(8), 1)")
    assert not mods & (FORBIDDEN | {"cuda_pt_torch"})


@pytest.mark.parametrize("workload,scene,args", [
    ("kitchen.pt_1024", "kitchen_stress", {"grid": 2}),
    ("medium_cbox.vpt_1024", "medium_cbox", {"ns": 48, "nt": 24}),
    ("kitchen.pt_2160p", "kitchen_stress", {"grid": 2})])
def test_control_fails_the_limits(workload, scene, args):
    """The reference with its state planes in bf16, put in the program's
    place, against the reference in f32, at 32x32 with the cell's spp a
    call and limits: not correct."""
    from benchmark import check
    from benchmark.reference import plain_render as pr

    with open(os.path.join(BENCH, "traffic", workload.split(".")[1] + ".json")) as f:
        spp = json.load(f)["spp_per_call"]
    cfg = {"scene": scene, "scene_args": args, "renderer": "vpt" if "cbox" in scene else "pt"}
    rs, _ = pr.make_scene(cfg, 32, 32, "cpu")
    pix = torch.as_tensor(check.sample_pixels(11, 32 * 32, 256 if spp > 1 else 512))
    f32 = pr.film_means(pr.pixel_paths(rs, 11, pix, spp), [spp])
    bf16 = pr.film_means(pr.pixel_paths(rs, 11, pix, spp, "bf16"), [spp])
    values = {"tables_off": 0, **check.compare([b.numpy() for b in bf16],
                                               [a.numpy() for a in f32])}
    ok, _ = check.judge(values, check.load_limits(tiny_cell.REPO, workload))
    assert not ok
