"""api.device_ms_per_pass: device milliseconds per pass of the api
layer's own operations (api.launches_per_pass)."""


def read(ctx):
    if not ctx.attributed:
        return None
    return sum(o.dur_us for o in ctx.ops("api")) / 1e3 / ctx.passes
