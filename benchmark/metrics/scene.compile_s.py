"""scene.compile_s: host seconds of the scene compile (the scene generator
and api.Renderer(...), which packs it), measured around both in set-up."""


def read(ctx):
    return ctx.scene_compile_s
