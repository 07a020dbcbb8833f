"""api.launches_per_pass: device operations (kernels, copies, memsets) per
pass that the api layer launches outside the driver: ray setup, the
Z-order swizzle and its inverse, the film, the read-back of the mean."""


def read(ctx):
    if not ctx.attributed:
        return None
    return len(ctx.ops("api")) / ctx.passes
