"""driver.device_ms_per_pass: device milliseconds per pass of the
driver's own operations (driver.launches_per_pass)."""


def read(ctx):
    if not ctx.attributed:
        return None
    return sum(o.dur_us for o in ctx.ops("driver")) / 1e3 / ctx.passes
