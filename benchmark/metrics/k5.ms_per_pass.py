"""k5.ms_per_pass: device milliseconds per pass of the segment kernel K5
(every seg_kernel launch in the trace)."""


def read(ctx):
    ops = ctx.ops(name="seg_kernel")
    if not ops:
        return None
    return sum(o.dur_us for o in ops) / 1e3 / ctx.passes
