"""The benchmark of cuda_pt_torch: one cell of BENCHMARK.json per run.

A cell names a configuration (configs/<name>.json: the scene generator,
its arguments, the renderer family and depth caps) and a traffic mix
(traffic/<name>.json: width, height, samples per call, the calls the
check compares); the per-layer metrics are readers of their own
(metrics/<name>.py, each with read(ctx) -> float or None) and each cell
has its limits (limits/<workload>.json). All are found by name, so a
cell, a mix or a metric is added by adding files and entries.

A run: set-up (the program's CUDA library built or loaded, the scene
compiled, the Renderer made, the cell's own shape warmed up), then
Renderer.render(spp_per_call) called back to back for --seconds, each
call timed by the host clock to its synchronized return, then the check
(check.py) once the window has closed. With --trace 1 the first calls of
the window run under torch.profiler with the benchmark's spans
(spans.py), the next ones under a profiler of the device alone, and the
per-layer metrics are read from those two traces.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_pt_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


# -- the cell, from its files -------------------------------------------------
def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(spec: dict, workload: str, root: str = ROOT) -> tuple:
    """(workload entry, configuration, traffic mix) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(root, "benchmark", "traffic", f"{wl['traffic']}.json"))
    return wl, cfg, traffic


def metrics_for(spec: dict, workload: str, kind: str) -> list:
    """The cell's metrics of kind "end_to_end" or "per_layer"."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def load_reader(name: str, root: str = ROOT):
    """metrics/<name>.py's read function. A metric <reader>.<group> with no
    file of its own reads with <reader>'s: the same quantity in a group of
    cells that moves another end-to-end metric (k5.ms_per_pass.offline)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(root, "benchmark", "metrics", f"{name.rsplit('.', 1)[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- end-to-end metrics -------------------------------------------------------
def end_to_end(name: str, run: dict):
    """An end-to-end metric from the run's host clock; <metric>.<group> is
    <metric> in a group of cells with a bound of its own
    (msamples_per_s.offline)."""
    base = name.split(".")[0]
    if base == "setup_s":
        return run["setup_s"]
    if base == "msamples_per_s":
        return run["samples"] / run["window_s"] / 1e6
    if base == "pass_p95_ms":
        return statistics.quantiles(run["call_s"], n=20, method="inclusive")[18] * 1e3
    raise SystemExit(f"no end-to-end metric named {name!r}")


# -- the run ------------------------------------------------------------------
def make_renderer(cfg: dict, traffic: dict, seed: int, device):
    """The program's Renderer for the cell, and the seconds its scene
    compile and construction took."""
    import torch  # noqa: F401  (the program imports it too)

    from cuda_pt_torch.api import Renderer
    from cuda_pt_torch.core.config import MaxDepthParams, RendererType, RenderingConfig
    from cuda_pt_torch.scene import testscenes
    from cuda_pt_torch.scene.xml_parser import ParsedScene

    W, H = traffic["width"], traffic["height"]
    rt = RendererType(cfg["renderer"])
    t0 = time.perf_counter()
    scene, cam, _ = getattr(testscenes, cfg["scene"])(W, H, device=device,
                                                       **cfg.get("scene_args", {}))
    rc = RenderingConfig(renderer=rt, width=W, height=H,
                         md=MaxDepthParams(**cfg.get("md", {})), seed=int(seed))
    r = Renderer(ParsedScene(scene, cam, rc), renderer=rt,
                 nee_candidates=cfg.get("nee_candidates", 1), sampler=cfg.get("sampler", "pcg"),
                 device=None if device.type == "cuda" else device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return r, time.perf_counter() - t0


class LayerContext:
    """What a per-layer metric reader sees."""

    def __init__(self, trace, passes: int, scene_compile_s: float, pack_bytes: int,
                 lane_bytes: tuple, idle_trace=None):
        self.trace = trace  # trace_reduce.Trace or None: host and device, with the spans
        self.idle_trace = idle_trace  # the device alone, over its host-clock window
        self.passes = passes
        self.scene_compile_s = scene_compile_s
        self.pack_bytes = pack_bytes
        self.lane_bytes = lane_bytes  # K5's (read, written) plane bytes per lane

    def ops(self, layer: str | None = None, name: str | None = None) -> list:
        if self.trace is None:
            return []
        return [o for o in self.trace.ops if (layer is None or o.layer == layer)
                and (name is None or name in o.name)]

    @property
    def attributed(self) -> bool:
        """Whether the trace tied any device operation to a span."""
        return any(o.layer != "other" for o in self.ops())


def _pack_info(r) -> tuple:
    """(pack bytes, K5's plane bytes per lane) of the Renderer's pack."""
    from . import yardstick

    pack = getattr(r, "_pack", None)
    if pack is None:
        return 0, (0, 0)
    nbytes = sum(pack.arrays[k].numel() * pack.arrays[k].element_size()
                 for k in yardstick.PACK_KEYS if k in pack.arrays)
    return nbytes, yardstick.k5_lane_bytes(pack.has_media, pack.textured, pack.has_grid,
                                           pack.tri_only)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None,
             root: str = ROOT, t_start: float | None = None) -> dict:
    """One run of a cell; returns the result line's object. device None is
    the card (the run stops where there is none); a CPU device runs the
    program's plain versions, for the harness's own tests."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(root)
    wl, cfg, traffic = cell(spec, workload, root)
    from . import check

    limits = check.load_limits(root, workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            raise SystemExit(f"{workload} needs {wl['chips']} CUDA device(s); "
                             f"available: {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    spp = traffic["spp_per_call"]
    W, H = traffic["width"], traffic["height"]

    # set-up; a checkout's first run compiles the library: setup_s holds
    # that, so a run that rebuilds shows, and device.compile_s records it
    # apart
    compile_s = 0.0
    if cuda:
        from cuda_pt_torch.ops import cuda_build

        t_b = time.perf_counter()
        pending, lib = cuda_build.start_build()
        cuda_build.finish_build(pending, lib)
        if pending is not None:
            compile_s = time.perf_counter() - t_b
        cuda_build.load()
    r, scene_s = make_renderer(cfg, traffic, seed, device)
    info = r.info()
    log(f"[bench] {workload} seed {seed}: {info['renderer']} driver {info['driver']} "
        f"{W}x{H} x {spp} spp per call; nvcc {compile_s:.3f} s, scene + Renderer "
        f"{scene_s:.3f} s")
    for _ in range(traffic["warmup_calls"]):
        r.render(spp)
    spans = None
    trace_calls = idle_calls = 0
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from .spans import Spans

        full = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        lean = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        for acts in (full, lean):  # the first profile of each kind pays its start-up
            with profile(activities=acts):
                r.render(spp)
        spans = Spans()
        trace_calls, idle_calls = traffic["trace_calls"], traffic["idle_calls"]
    setup_s = time.perf_counter() - t_start

    # the window; with --trace 1 its first trace_calls calls run under the
    # profiler of host and device with the spans (the layers, the
    # breakdown), the next idle_calls under a profiler of the device alone
    # (the idle share and busy time, with far less overhead on the host)
    r.reset_out_buffer()
    keep, call_s = [], []
    prof = prof_idle = tr = tr_idle = None
    idle_host_s = 0.0
    t_w0 = time.perf_counter()
    while True:
        n = len(call_s)
        if trace and n == 0:
            spans.install()
            prof = profile(activities=full)
            prof.__enter__()
        if trace and n == trace_calls:
            prof_idle = profile(activities=lean)
            prof_idle.__enter__()
            t_i0 = time.perf_counter()
        t0 = time.perf_counter()
        img = r.render(spp)
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        if len(keep) < traffic["check_calls"]:
            keep.append(img)
        if trace and n + 1 == trace_calls:  # read before the next profile clears it
            prof.__exit__(None, None, None)
            spans.uninstall()
            tr = _trace_of(prof)
        if trace and n + 1 == trace_calls + idle_calls:
            idle_host_s = time.perf_counter() - t_i0
            prof_idle.__exit__(None, None, None)
            tr_idle = _trace_of(prof_idle)
        if t1 - t_w0 >= seconds and n + 1 >= max(trace_calls + idle_calls,
                                                 traffic["check_calls"]):
            break
    window_s = t1 - t_w0
    run = {"setup_s": setup_s, "window_s": window_s, "call_s": call_s,
           "samples": W * H * spp * len(call_s)}
    log(f"[bench] window {window_s:.3f} s, {len(call_s)} calls, median call "
        f"{statistics.median(call_s) * 1e3:.3f} ms; setup {setup_s:.3f} s")

    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)) if cuda
                   else 0,
                   "compile_s": compile_s}
    result = {"correct": False, "attempted": len(call_s), "failed": 0, "metrics": {},
              "device": device_info}
    if trace:
        result["metrics"], result["breakdown"], busy = _per_layer(
            spec, workload, tr, tr_idle, idle_host_s, spans, r, scene_s, trace_calls * spp, root)
        device_info.update(busy)
    else:
        for m in metrics_for(spec, workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": end_to_end(m["name"], run),
                                            "unit": m["unit"]}

    # the check, once the program's state is freed
    from .reference import plain_render

    prog_tables = plain_render.scene_tables(r.scene)
    pixels = _sample(seed, traffic)
    prog = [np.asarray(a).reshape(-1, 3)[pixels] for a in keep]
    del r, keep, img
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    rs, tables_off = plain_render.make_scene(cfg, W, H, device, prog_tables)
    ref = check.reference_means(rs, traffic, seed, pixels, device)
    values = {"tables_off": tables_off, **check.compare(prog, ref)}
    result["correct"], result["checks"] = check.judge(values, limits)
    log(f"[bench] check {time.perf_counter() - t_c:.3f} s over {len(pixels)} pixels x "
        f"{traffic['check_calls']} calls; mean_gap_pct {values['mean_gap_pct']!r} "
        f"(not compared)")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"loaded modules of JAX or the JAX package: {bad}")
    return result


def _sample(seed: int, traffic: dict) -> np.ndarray:
    from . import check

    return check.sample_pixels(seed, traffic["width"] * traffic["height"],
                               traffic["check_pixels"])


def _trace_of(prof):
    from . import trace_reduce

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return trace_reduce.load(path)
    finally:
        os.remove(path)


def _per_layer(spec, workload, tr, idle, idle_host_s, spans, r, scene_s, passes,
               root) -> tuple:
    """(per-layer metrics, breakdown, device busy and window seconds) of a
    traced run: the layers from tr (host and device), the device's busy
    time from idle (the device alone) over its host-clock window."""
    from . import trace_reduce

    idle.window_start_us = min((o.start_us for o in idle.ops), default=0.0)
    idle.window_us = idle_host_s * 1e6
    pack_bytes, lane_bytes = _pack_info(r)
    ctx = LayerContext(tr, passes, scene_s, pack_bytes, lane_bytes, idle)
    metrics = {}
    for m in metrics_for(spec, workload, "per_layer"):
        v = load_reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    busy_s = trace_reduce.busy_us(idle) * 1e-6
    breakdown = {"device_ops": trace_reduce.top_device_ops(tr),
                 "idle_gaps": trace_reduce.idle_gaps(tr)}
    grid_lanes = sum(o.grid[0] * o.block[0] for o in ctx.ops(name="seg_kernel")
                     if o.grid and o.block)
    log(f"[bench] trace: {len(tr.ops)} device operations over {passes} passes; K5 lanes: "
        f"{grid_lanes} by the launch grids, {sum(spans.k5_lanes)} live by the host; device "
        f"alone: busy {busy_s:.6f} s of {idle_host_s:.6f} s, host and device: busy "
        f"{trace_reduce.busy_us(tr) * 1e-6:.6f} s of {tr.window_us * 1e-6:.6f} s")
    return metrics, breakdown, {"busy_s": busy_s, "window_s": idle_host_s}


def print_result(result: dict):
    """The checks on standard error as the last lines, then the result as
    the last line of standard output, the checks its last key."""
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    print_result(run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          t_start=t_start))
    return 0
