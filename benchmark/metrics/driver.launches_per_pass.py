"""driver.launches_per_pass: device operations per pass launched inside
megakernel.auto_trace other than K5's: the sort keys, the argsort, the
gathers, the texel resolve, the result."""


def read(ctx):
    if not ctx.attributed:
        return None
    return len(ctx.ops("driver")) / ctx.passes
