"""Scenes the tools share with chip_smoke.py.

slot_scene: the reference's guiding test scene (tests/test_guiding.py
_slot_scene), a bright light seen from the floor only through a narrow
slot in an occluder panel: NEE from the floor is mostly occluded and
cosine BSDF sampling rarely finds the slot, the configuration where guided
scattering wins. quality_bench --scene slot and guiding_study render it.
"""

from __future__ import annotations


def slot_scene(size: int = 20, device="cpu"):
    """(scene, camera): the slot scene, its camera size x size, on device."""
    from ..core import camera as cam_mod
    from ..scene import testscenes
    from ..scene.builder import BSDFSpec, EmitterSpec, SceneBuilder

    b = SceneBuilder()
    white = b.add_bsdf(BSDFSpec(k_d=(0.75, 0.75, 0.75)))
    dark = b.add_bsdf(BSDFSpec(k_d=(0, 0, 0)))
    em = b.add_emitter(EmitterSpec(emission=(1, 1, 1), scaler=60.0))
    q = testscenes.quad
    # floor (normal +y, toward the light)
    b.add_mesh(q([-1, 0, -1], [-1, 0, 1], [1, 0, 1], [1, 0, -1]), white)
    # bright light above a panel with a narrow slot at x in [0.05, 0.25]
    # (normal -y: one-sided emission faces the floor)
    b.add_mesh(q([-1, 1.6, -1], [1, 1.6, -1], [1, 1.6, 1], [-1, 1.6, 1]), dark, emitter_id=em)
    # occluder panel at y = 1.0 with the slot cut out (two pieces, normals -y)
    b.add_mesh(q([-1, 1.0, -1], [0.05, 1.0, -1], [0.05, 1.0, 1], [-1, 1.0, 1]), white)
    b.add_mesh(q([0.25, 1.0, -1], [1, 1.0, -1], [1, 1.0, 1], [0.25, 1.0, 1]), white)
    cam = cam_mod.make_camera((0, 0.7, -2.6), (0, 0.3, 0), fov=35, width=size, height=size,
                              device=device)
    return b.compile(device=device), cam
