"""The harness on the CPU: a cell, a mix and a metric added as files run
with no code edit; the result line's keys; the rate over the whole window
and the p95 over every call; the check failing under each fault the
cells can have; no result without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import tiny_cell
from benchmark import harness

SEED = 2 ** 31 + 977  # above 32 signed bits, as the driver's seeds may be


def _run(root, trace=False, seconds=0.5, seed=SEED, workload=tiny_cell.WORKLOAD):
    return harness.run_cell(workload, seed, seconds, trace, device="cpu", root=root)


def test_files_added_run_with_no_code_edit(tmp_path):
    """A new configuration (medium_cbox, small), a new mix and a new
    per-layer metric, each a file, run through the harness as it is."""
    cfg = {"scene": "medium_cbox", "scene_args": {"ns": 48, "nt": 24}, "renderer": "vpt",
           "md": {}, "nee_candidates": 1, "sampler": "pcg", "attr_fmt": "f32"}
    mix = dict(tiny_cell.TRAFFIC, width=12, height=10, check_pixels=40)
    reader = "def read(ctx):\n    return float(ctx.passes)\n"
    root = tiny_cell.make_root(tmp_path, config=cfg, traffic=mix,
                               metrics={"tiny.passes_traced": reader},
                               workload="tiny_cbox.tiny_mix")
    res = _run(root, trace=True, workload="tiny_cbox.tiny_mix")
    assert res["correct"], res["checks"]
    assert res["metrics"]["tiny.passes_traced"]["value"] == float(mix["trace_calls"])
    assert res["metrics"]["scene.compile_s"]["value"] > 0


def test_result_line_keys(tmp_path, capsys):
    root = tiny_cell.make_root(tmp_path)
    for trace in (False, True):
        harness.print_result(_run(root, trace=trace))
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        want = ["correct", "attempted", "failed", "metrics", "device"]
        want += ["breakdown", "checks"] if trace else ["checks"]
        assert list(line) == want
        assert set(line["checks"]) == {"tables_off", "pixels_off_pct"}
        if trace:
            assert {"busy_s", "window_s"} <= set(line["device"])
            assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(line["metrics"]) == {"msamples_per_s", "pass_p95_ms", "setup_s"}


def test_rate_and_tail_take_every_call():
    """The rate divides all the window's samples by all its time, the p95
    is over every call: one stalled call moves both."""
    calls = [0.05] * 99
    base = {"setup_s": 1.0, "call_s": calls, "window_s": sum(calls), "samples": 99 * 2 ** 20}
    stalled = dict(base, call_s=calls[:-10] + [0.5] * 10, window_s=sum(calls) + 4.5)
    assert harness.end_to_end("msamples_per_s", base) == pytest.approx(99 * 2 ** 20 / 4.95e6)
    assert harness.end_to_end("msamples_per_s", stalled) == pytest.approx(99 * 2 ** 20 / 9.45e6)
    assert harness.end_to_end("pass_p95_ms", base) == pytest.approx(50.0)
    assert harness.end_to_end("pass_p95_ms", stalled) == pytest.approx(500.0)
    assert harness.end_to_end("msamples_per_s.offline", stalled) == \
        harness.end_to_end("msamples_per_s", stalled)


def test_window_holds_a_stall(tmp_path, monkeypatch):
    """A call that stalls inside the window lengthens the window and the
    call times the harness keeps."""
    from cuda_pt_torch import api

    root = tiny_cell.make_root(tmp_path)
    calls = {"n": 0}
    render = api.Renderer.render

    def slow(self, spp=None):
        calls["n"] += 1
        if calls["n"] == 3:  # after the warm-up call, the window's second
            import time

            time.sleep(1.0)
        return render(self, spp)

    monkeypatch.setattr(api.Renderer, "render", slow)
    seen = {}
    orig = harness.end_to_end

    def spy(name, run):
        seen.update(run)
        return orig(name, run)

    monkeypatch.setattr(harness, "end_to_end", spy)
    _run(root, seconds=0.1)
    assert len(seen["call_s"]) >= 2 and max(seen["call_s"]) >= 1.0
    assert seen["window_s"] >= sum(seen["call_s"]) - 1e-6


def _half_lanes(fn):
    def run(*a, **kw):
        L = fn(*a, **kw).clone()
        L[1::2] = 0.0  # half of the batch left out, the mean over the rest
        return L * 2.0
    return run


def _altered(fn):
    def run(*a, **kw):
        return fn(*a, **kw) * 1.01  # every radiance altered where it is produced
    return run


@pytest.mark.parametrize("fault", ["film_unchanged", "half_batch", "altered_answer"])
def test_check_fails_under_each_fault(tmp_path, monkeypatch, fault):
    """The timed path broken underneath, the rest of the run as it is:
    correct comes out false."""
    from cuda_pt_torch.core import film
    from cuda_pt_torch.ops import megakernel as mk

    root = tiny_cell.make_root(tmp_path)
    if fault == "film_unchanged":  # a pass that leaves the film's state as it was
        monkeypatch.setattr(film, "accumulate", lambda f, radiance: film.Film(
            f.mean, f.m2, f.weight, f.count + 1))
    elif fault == "half_batch":
        monkeypatch.setattr(mk, "auto_trace", _half_lanes(mk.auto_trace))
    else:
        monkeypatch.setattr(mk, "auto_trace", _altered(mk.auto_trace))
    res = _run(root)
    assert not res["correct"]
    assert res["checks"]["pixels_off_pct"]["value"] > 10 * tiny_cell.LIMITS["pixels_off_pct"]


def test_no_result_without_a_card(tmp_path):
    """run.py stops with another code than 0 and prints no result where no
    CUDA device is (skips where one is), and in a directory that holds
    only BENCHMARK.json and benchmark/."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    bare = tmp_path / "bare"
    bare.mkdir()
    import shutil

    shutil.copytree(os.path.join(tiny_cell.REPO, "benchmark"), bare / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny_cell.REPO, "BENCHMARK.json"), bare / "BENCHMARK.json")
    for cwd in (tiny_cell.REPO, str(bare)):
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "kitchen.pt_1024",
                            "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
                           capture_output=True, text=True, timeout=300)
        assert p.returncode != 0
        assert '"correct"' not in p.stdout
