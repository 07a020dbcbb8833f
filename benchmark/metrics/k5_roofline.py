"""k5_roofline: K5's least time by bytes (yardstick.k5_bound_s: the pack
once a pass, and each launch's live lanes times the plane bytes a lane
reads and writes) over its traced device time, in percent. K5 launches one
thread per live lane in blocks of 128, so a launch's lanes are read from
its grid as grid x block, at most 127 over the live count. Nothing where
a K5 launch in the trace has no grid."""

from benchmark import yardstick


def read(ctx):
    ops = ctx.ops(name="seg_kernel")
    if not ops or any(o.grid is None or o.block is None for o in ops):
        return None
    lanes = [o.grid[0] * o.grid[1] * o.grid[2] * o.block[0] * o.block[1] * o.block[2]
             for o in ops]
    t = sum(o.dur_us for o in ops) * 1e-6
    if t <= 0:
        return None
    bound = yardstick.k5_bound_s(ctx.pack_bytes, ctx.passes, lanes, ctx.lane_bytes)
    return 100.0 * bound / t
