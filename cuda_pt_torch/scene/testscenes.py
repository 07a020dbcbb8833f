"""Procedural test scenes (port of cuda_pt_tpu/scene/testscenes.py:
``quad`` and ``cornell_box``)."""

from __future__ import annotations

import numpy as np

from ..core import camera as cam_mod
from . import types as T
from .builder import BSDFSpec, EmitterSpec, SceneBuilder


def quad(p00, p10, p11, p01):
    """Two triangles for a quad given CCW corners."""
    p00, p10, p11, p01 = (np.asarray(p, np.float32) for p in (p00, p10, p11, p01))
    return np.stack([np.stack([p00, p10, p11]), np.stack([p00, p11, p01])], axis=0)


def _box_mesh(lo, hi):
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)

    def c(x, y, z):
        return np.array([lo[0] + x * (hi[0] - lo[0]), lo[1] + y * (hi[1] - lo[1]),
                         lo[2] + z * (hi[2] - lo[2])], np.float32)

    quads = [
        quad(c(0, 0, 0), c(1, 0, 0), c(1, 1, 0), c(0, 1, 0)),  # front
        quad(c(1, 0, 1), c(0, 0, 1), c(0, 1, 1), c(1, 1, 1)),  # back
        quad(c(0, 0, 1), c(0, 0, 0), c(0, 1, 0), c(0, 1, 1)),  # left
        quad(c(1, 0, 0), c(1, 0, 1), c(1, 1, 1), c(1, 1, 0)),  # right
        quad(c(0, 1, 0), c(1, 1, 0), c(1, 1, 1), c(0, 1, 1)),  # top
    ]
    return np.concatenate(quads, axis=0)


def cornell_box(width=64, height=64, light_scale=12.0, tall_box_bsdf=None, device="cpu"):
    """Unit cornell box with an area light; returns (scene, camera, builder).
    tall_box_bsdf: None (white lambertian) or a BSDFSpec for the tall box."""
    b = SceneBuilder()
    white = b.add_bsdf(BSDFSpec(k_d=(0.73, 0.73, 0.73)))
    red = b.add_bsdf(BSDFSpec(k_d=(0.65, 0.05, 0.05)))
    green = b.add_bsdf(BSDFSpec(k_d=(0.12, 0.45, 0.15)))
    light_m = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    em = b.add_emitter(
        EmitterSpec(etype=T.EMITTER_AREA, emission=(1.0, 1.0, 1.0), scaler=light_scale))

    b.add_mesh(quad([0, 0, 0], [1, 0, 0], [1, 0, 1], [0, 0, 1]), white)  # floor
    b.add_mesh(quad([0, 1, 0], [0, 1, 1], [1, 1, 1], [1, 1, 0]), white)  # ceiling
    b.add_mesh(quad([0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]), white)  # back
    b.add_mesh(quad([0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0]), red)  # left
    b.add_mesh(quad([1, 0, 0], [1, 1, 0], [1, 1, 1], [1, 0, 1]), green)  # right
    # light panel just below the ceiling, wound so its normal faces down
    b.add_mesh(
        quad([0.35, 0.998, 0.35], [0.65, 0.998, 0.35], [0.65, 0.998, 0.65],
             [0.35, 0.998, 0.65]),
        light_m, emitter_id=em)
    if tall_box_bsdf is None:
        tall_box_bsdf = white
    elif isinstance(tall_box_bsdf, BSDFSpec):
        tall_box_bsdf = b.add_bsdf(tall_box_bsdf)
    b.add_mesh(_box_mesh([0.53, 0.0, 0.45], [0.83, 0.6, 0.75]), tall_box_bsdf)
    b.add_mesh(_box_mesh([0.15, 0.0, 0.15], [0.45, 0.3, 0.45]), white)

    scene = b.compile(device=device)
    cam = cam_mod.make_camera(origin=(0.5, 0.5, -1.35), target=(0.5, 0.5, 0.5), fov=40.0,
                              width=width, height=height, device=device)
    return scene, cam, b


def cornell_box_lights(width=64, height=64, device="cpu"):
    """cornell_box with two more emitters after its ceiling panel: a point
    light, then a small emissive box (10 triangles of unequal area) on the
    floor. Not in the JAX package: it holds the kernel's NEE emitter and
    emitter-prim pick to the plain version where the emitter-prim table has
    rows of more than one emitter. Returns (scene, camera, builder)."""
    _, cam, b = cornell_box(width, height, device=device)
    b.add_emitter(EmitterSpec(etype=T.EMITTER_POINT, emission=(0.6, 0.5, 0.4), scaler=1.0,
                              pos=(0.3, 0.8, 0.3)))
    glow = b.add_emitter(EmitterSpec(etype=T.EMITTER_AREA, emission=(0.2, 0.6, 1.0), scaler=4.0))
    dark = b.add_bsdf(BSDFSpec(k_d=(0.0, 0.0, 0.0)))
    b.add_mesh(_box_mesh([0.62, 0.0, 0.12], [0.88, 0.08, 0.3]), dark, emitter_id=glow)
    return b.compile(device=device), cam, b
