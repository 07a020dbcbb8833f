"""From a torch.profiler trace of a few calls to device operations grouped
by layer, the device's busy time and the idle gaps.

Spans come from the benchmark itself (spans.py): record_function ranges
named SPANS around the calls into each layer. Each device operation
(kernel, copy, memset) is tied to the host call that launched it by the
trace's correlation id, and belongs to the innermost span whose host range
holds that call. Busy time is the union of the device operations'
intervals, so overlapping operations count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import json

# span name -> layer; the innermost span decides, in this order
SPANS = {"bench::k5": "k5", "bench::driver": "driver", "bench::api": "api"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a breakdown entry's name, cut to this many characters
HOST_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float
    layer: str  # "k5", "driver", "api" or "other"
    grid: tuple | None = None
    block: tuple | None = None


@dataclasses.dataclass
class Trace:
    ops: list  # DeviceOp
    window_us: float  # host range from the first api span's start to the last's end
    window_start_us: float
    host: list  # (start, end, name) of host ranges (spans and operators), for gap names


class _Ranges:
    """Sorted disjoint host ranges of one span name."""

    def __init__(self, ranges):
        self.r = sorted(ranges)
        self.starts = [a for a, _ in self.r]

    def holds(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.r[i][0] <= t <= self.r[i][1]


def reduce_events(events: list) -> Trace:
    """Trace from a chrome-trace event list (export_chrome_trace's
    "traceEvents")."""
    spans = {name: [] for name in SPANS}
    launches = {}
    host = []
    dev = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in ("user_annotation", "cpu_op"):
            if e["name"] in spans:
                spans[e["name"]].append((ts, ts + dur))
            host.append((ts, ts + dur, e["name"]))
    ranges = {name: _Ranges(r) for name, r in spans.items()}
    ops = []
    for e in dev:
        args = e.get("args", {})
        t_host = launches.get(args.get("correlation"))
        layer = "other"
        if t_host is not None:
            for name, lay in SPANS.items():
                if ranges[name].holds(t_host):
                    layer = lay
                    break
        grid = tuple(args["grid"]) if "grid" in args else None
        block = tuple(args["block"]) if "block" in args else None
        ops.append(DeviceOp(e["name"], float(e["ts"]), float(e.get("dur", 0.0)), layer,
                            grid, block))
    api = sorted(spans["bench::api"])
    w0 = api[0][0] if api else min((o.start_us for o in ops), default=0.0)
    w1 = api[-1][1] if api else max((o.start_us + o.dur_us for o in ops), default=0.0)
    return Trace(ops, w1 - w0, w0, sorted(host))


def load(path: str) -> Trace:
    with open(path) as f:
        return reduce_events(json.load(f)["traceEvents"])


def busy_intervals(ops: list, lo: float, hi: float) -> list:
    """The union of the operations' intervals clipped to [lo, hi], sorted
    and disjoint."""
    out = []
    for a, b in sorted((o.start_us, o.start_us + o.dur_us) for o in ops):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_us(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr.ops, tr.window_start_us,
                                                tr.window_start_us + tr.window_us))


def idle_gaps(tr: Trace, top: int = 10) -> list:
    """The longest gaps of the window in which no device operation ran,
    each named by the innermost host range (a span or an operator) that
    holds its midpoint: [[name, seconds], ...], longest first."""
    lo, hi = tr.window_start_us, tr.window_start_us + tr.window_us
    gaps, t = [], lo
    for a, b in busy_intervals(tr.ops, lo, hi):
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = [h[0] for h in tr.host]
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        name = "idle"
        best = None
        for h in tr.host[:bisect.bisect_right(starts, mid)]:
            if h[1] >= mid and (best is None or h[0] >= best[0]):
                best = h
        if best is not None:
            name = best[2]
        out.append([name[:NAME_CHARS], (b - a) * 1e-6])
    return out


def top_device_ops(tr: Trace, top: int = 10) -> list:
    """The device operations that took most time: [[name, seconds], ...]."""
    tot = {}
    for o in tr.ops:
        tot[o.name] = tot.get(o.name, 0.0) + o.dur_us
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[k[:NAME_CHARS], v * 1e-6] for k, v in rows]
