"""device.idle_share: the share of the traced window, in percent, in which
no kernel, copy or memset ran on the device (the union of their
intervals, so overlaps count once). Read from the stretch traced on the
device alone (LayerContext.idle_trace) where the run has one: the host's
side of the profiler slows the launches, and so idles the device more."""

from benchmark import trace_reduce


def read(ctx):
    tr = ctx.idle_trace if ctx.idle_trace is not None else ctx.trace
    if tr is None or not tr.ops or tr.window_us <= 0:
        return None
    return 100.0 * (1.0 - trace_reduce.busy_us(tr) / tr.window_us)
