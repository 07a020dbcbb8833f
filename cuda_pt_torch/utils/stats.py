"""Wall timers and console progress (port of cuda_pt_tpu/utils/stats.py;
reference src/core/stats.h:30-59 TicToc and src/core/progress.h)."""

from __future__ import annotations

import sys
import time
from collections import deque


class TicToc:
    """Wall timer: ``with TicToc("bvh build"):`` prints ms on exit; or
    tic() / toc() for manual use."""

    def __init__(self, label: str = "", echo: bool = True):
        self.label = label
        self.echo = echo
        self.elapsed_ms = 0.0
        self._t0 = time.perf_counter()

    def tic(self):
        self._t0 = time.perf_counter()
        return self

    def toc(self) -> float:
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return self.elapsed_ms

    def __enter__(self):
        return self.tic()

    def __exit__(self, *exc):
        self.toc()
        if self.echo:
            print(f"[TIMER] {self.label}: {self.elapsed_ms:.2f} ms")
        return False


class SlidingWindowAverage:
    """Frame-time average (reference src/pyrender/python_render.cuh:33-56)."""

    def __init__(self, window: int = 32):
        self.values = deque(maxlen=window)

    def push(self, v: float):
        self.values.append(v)

    @property
    def mean(self) -> float:
        return sum(self.values) / len(self.values) if self.values else 0.0


def print_progress(i: int, total: int, width: int = 40, prefix: str = ""):
    """Console progress bar (reference src/impl/progress.cpp)."""
    frac = (i + 1) / max(total, 1)
    fill = int(width * frac)
    bar = "#" * fill + "-" * (width - fill)
    sys.stdout.write(f"\r{prefix}[{bar}] {i + 1}/{total} ({100 * frac:5.1f}%)")
    if i + 1 >= total:
        sys.stdout.write("\n")
    sys.stdout.flush()
