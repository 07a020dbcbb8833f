"""The benchmark's spans: torch.profiler.record_function ranges around the
calls into each layer of the program, installed at run time from here, so
no program file carries them. Installed only in a traced run.

- "bench::api": api.Renderer.render, the entry (ray setup, the driver,
  the film and the read-back of the mean);
- "bench::driver": ops/megakernel.auto_trace, the driver of the pass;
- "bench::k5": ops/megakernel.trace_megakernel_seg, one launch of K5.

The K5 wrapper also records each launch's live-lane count n (its fourth
argument), a host-side cross-check of the lanes the trace's grid gives.
"""

from __future__ import annotations

import functools

import torch


def _wrap(fn, name: str, record=None):
    @functools.wraps(fn)
    def inner(*args, **kw):
        if record is not None:
            record(args, kw)
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    inner.__wrapped_span__ = fn
    return inner


class Spans:
    """Install the wrappers; uninstall restores the program's functions."""

    def __init__(self):
        self.k5_lanes = []
        self._undo = []

    def _patch(self, owner, attr: str, name: str, record=None):
        fn = getattr(owner, attr)
        setattr(owner, attr, _wrap(fn, name, record))
        self._undo.append((owner, attr, fn))

    def install(self):
        from cuda_pt_torch import api
        from cuda_pt_torch.ops import megakernel as mk

        def lanes(args, kw):
            n = kw.get("n", args[3] if len(args) > 3 else None)
            self.k5_lanes.append(int(n))

        self._patch(api.Renderer, "render", "bench::api")
        self._patch(mk, "auto_trace", "bench::driver")
        self._patch(mk, "trace_megakernel_seg", "bench::k5", lanes)
        return self

    def uninstall(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()
