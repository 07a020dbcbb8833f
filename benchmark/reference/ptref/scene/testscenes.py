"""The procedural scenes of the benchmark's configurations (port of
cuda_pt_tpu/scene/testscenes.py): ``kitchen_stress`` with its torus mesh
and procedural textures, and ``medium_cbox``, the in-repo stand-in for the
reference's medium-cbox.xml."""

from __future__ import annotations

import numpy as np

from ..core import camera as cam_mod
from . import types as T
from .builder import BSDFSpec, EmitterSpec, MediumSpec, SceneBuilder


def quad(p00, p10, p11, p01):
    """Two triangles for a quad given CCW corners."""
    p00, p10, p11, p01 = (np.asarray(p, np.float32) for p in (p00, p10, p11, p01))
    return np.stack([np.stack([p00, p10, p11]), np.stack([p00, p11, p01])], axis=0)


def _closed_box(lo, hi):
    """The six faces of an axis-aligned box as quads (the face order of the
    reference's medium-box test scene)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    faces = [
        ([x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0]),
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        ([x0, y0, z0], [x0, y1, z0], [x0, y1, z1], [x0, y0, z1]),
        ([x1, y0, z0], [x1, y1, z0], [x1, y1, z1], [x1, y0, z1]),
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),
        ([x0, y1, z0], [x1, y1, z0], [x1, y1, z1], [x0, y1, z1]),
    ]
    return [quad(*f) for f in faces]


def _cornell_shell(b: SceneBuilder, light_scale: float) -> int:
    """The cornell box's walls, ceiling and ceiling light; returns the white
    material's id."""
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
    return white


def _cornell_camera(width, height, device):
    return cam_mod.make_camera(origin=(0.5, 0.5, -1.35), target=(0.5, 0.5, 0.5), fov=40.0,
                               width=width, height=height, device=device)


def _torus_mesh(center, R, r, ns, nt, scale_y=1.0):
    """UV-mapped torus: (2*ns*nt, 3, 3) tris + matching normals + uvs."""
    c = np.asarray(center, np.float32)
    u = np.linspace(0.0, 2 * np.pi, ns, endpoint=False)
    v = np.linspace(0.0, 2 * np.pi, nt, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")  # (ns, nt)

    def P(uu, vv):
        x = (R + r * np.cos(vv)) * np.cos(uu)
        z = (R + r * np.cos(vv)) * np.sin(uu)
        y = r * np.sin(vv) * scale_y
        return np.stack([x, y, z], axis=-1).astype(np.float32) + c

    def N(uu, vv):
        nx = np.cos(vv) * np.cos(uu)
        nz = np.cos(vv) * np.sin(uu)
        ny = np.sin(vv) / max(scale_y, 1e-6)
        n = np.stack([nx, ny, nz], axis=-1)
        return (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)

    def T_(uu, vv):
        return np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], axis=-1).astype(np.float32)

    iu1 = (np.arange(ns) + 1) % ns
    iv1 = (np.arange(nt) + 1) % nt
    corners = [(uu, vv), (uu[iu1], vv[iu1]), (uu[:, iv1], vv[:, iv1]),
               (uu[iu1][:, iv1], vv[iu1][:, iv1])]  # 00, 10, 01, 11
    p00, p10, p01, p11 = (P(a, b).reshape(-1, 3) for a, b in corners)
    n00, n10, n01, n11 = (N(a, b).reshape(-1, 3) for a, b in corners)
    t00, t10, t01, t11 = (T_(a, b).reshape(-1, 2) for a, b in corners)
    tri_p = np.concatenate([np.stack([p00, p10, p11], axis=1), np.stack([p00, p11, p01], axis=1)])
    tri_n = np.concatenate([np.stack([n00, n10, n11], axis=1), np.stack([n00, n11, n01], axis=1)])
    tri_uv = np.concatenate([np.stack([t00, t10, t11], axis=1),
                             np.stack([t00, t11, t01], axis=1)])
    return tri_p, tri_n, tri_uv


def _checker_texture(n=256, tiles=12, c0=(0.85, 0.82, 0.75), c1=(0.22, 0.2, 0.25)):
    ij = np.arange(n)
    cell = ((ij[:, None] * tiles // n) + (ij[None, :] * tiles // n)) % 2
    img = np.where(cell[..., None] == 0, np.asarray(c0, np.float32), np.asarray(c1, np.float32))
    return img.astype(np.float32)


def _noise_texture(n=256, seed=7, lo=0.25, hi=0.95):
    rng = np.random.default_rng(seed)
    img = rng.random((n // 8, n // 8, 3)).astype(np.float32)
    for _ in range(3):  # cheap smooth upsample (marble-ish blotches)
        img = np.repeat(np.repeat(img, 2, 0), 2, 1)
        img = 0.25 * (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(img, 1, (0, 1)))
    return (lo + (hi - lo) * img).astype(np.float32)


def _sky_hdr(h=128, w=256, sun_dir=(0.35, 0.65, 0.4), sun_lum=80.0):
    """Lat-long HDR sky: horizon-to-zenith gradient plus a bright sun disc."""
    th = (np.arange(h) + 0.5) / h * np.pi  # zenith angle
    ph = (np.arange(w) + 0.5) / w * 2 * np.pi - np.pi
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1)
    s = np.asarray(sun_dir, np.float32)
    s = s / np.linalg.norm(s)
    cos_sun = np.clip((d * s).sum(-1), -1, 1)
    sky_t = np.clip(np.cos(tt), 0, 1)[..., None]
    img = (1.0 - sky_t) * np.array([0.35, 0.32, 0.3]) + sky_t * np.array([0.25, 0.45, 0.9])
    img = img + sun_lum * np.exp((cos_sun[..., None] - 1.0) * 4000.0)
    return img.astype(np.float32)


def kitchen_stress(width=128, height=128, grid=7, ns=36, nt=28, device="cpu"):
    """Kitchen-class stress scene, the in-repo stand-in for the reference's
    kitchen.xml (textures + envmap): grid^2 tessellated tori (default
    98,784 triangles) cycling through five BSDF families (textured
    Lambertian, GGX conductor, Plastic, smooth dielectric, Dispersion), a
    checker-textured floor, a noise-textured back wall, an HDR sky envmap
    with a hot sun disc and one area panel. Returns (scene, camera, builder)."""
    b = SceneBuilder()
    checker = b.add_texture(_checker_texture())
    marble = b.add_texture(_noise_texture())
    sky = b.add_texture(_sky_hdr())

    floor_m = b.add_bsdf(BSDFSpec(k_d=(1.0, 1.0, 1.0), tex_ids=(checker, -1, -1, -1, -1)))
    wall_m = b.add_bsdf(BSDFSpec(k_d=(1.0, 1.0, 1.0), tex_ids=(marble, -1, -1, -1, -1)))
    mats = [
        b.add_bsdf(BSDFSpec(k_d=(0.8, 0.55, 0.3), tex_ids=(checker, -1, -1, -1, -1))),
        b.add_bsdf(BSDFSpec(btype=T.BSDF_GGX_CONDUCTOR, eta=(0.143, 0.375, 1.444),
                            k=(3.983, 2.386, 1.603), roughness_x=0.15, roughness_y=0.15)),
        b.add_bsdf(BSDFSpec(btype=T.BSDF_PLASTIC, k_d=(0.1, 0.3, 0.65), k_s=(1.0, 1.0, 1.0),
                            ior=1.5, thickness=0.2)),
        b.add_bsdf(BSDFSpec(btype=T.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5)),
        b.add_bsdf(BSDFSpec(btype=T.BSDF_DISPERSION, k_s=(0.99, 0.99, 0.99),
                            cauchy_a=1.5046, cauchy_b=0.0042)),
    ]
    b.add_emitter(EmitterSpec(etype=T.EMITTER_ENVMAP, emission=(1.0, 1.0, 1.0), scaler=1.0,
                              tex_id=sky, extra=(1.0, 0.0, 0.0, 0.0)))
    panel = b.add_emitter(EmitterSpec(etype=T.EMITTER_AREA, emission=(1.0, 0.95, 0.85),
                                      scaler=40.0))

    ext = grid * 1.1
    fl_uv = np.array([[[0, 0], [4, 0], [4, 4]], [[0, 0], [4, 4], [0, 4]]], np.float32)
    b.add_mesh(quad([-ext, 0, -ext], [ext, 0, -ext], [ext, 0, ext], [-ext, 0, ext]), floor_m,
               uv=fl_uv)
    b.add_mesh(quad([-ext, 0, ext], [ext, 0, ext], [ext, ext, ext], [-ext, ext, ext]), wall_m,
               uv=fl_uv)
    lp = 0.25 * ext
    b.add_mesh(quad([-lp, 0.98 * ext, -lp], [lp, 0.98 * ext, -lp], [lp, 0.98 * ext, lp],
                    [-lp, 0.98 * ext, lp]), floor_m, emitter_id=panel)

    rng = np.random.default_rng(42)
    for gi in range(grid):
        for gj in range(grid):
            cx = (gi - (grid - 1) / 2) * 2.0
            cz = (gj - (grid - 1) / 2) * 2.0
            ry = 0.6 + 0.5 * rng.random()
            p, n, uv = _torus_mesh((cx, 0.45, cz), R=0.55, r=0.22, ns=ns, nt=nt, scale_y=ry)
            b.add_mesh(p, mats[(gi * grid + gj) % len(mats)], n=n, uv=uv)

    scene = b.compile(device=device)
    cam = cam_mod.make_camera(origin=(0.0, grid * 0.85, -grid * 1.45), target=(0.0, 0.3, 0.0),
                              fov=55.0, width=width, height=height, device=device)
    return scene, cam, b


# ---------------------------------------------------------------------------
# participating media (the volume path tracer, RendererType.VOLUME_PT)
# ---------------------------------------------------------------------------

# The fog of medium_cbox
FOG_MEDIUM = dict(sigma_a=(0.05, 0.08, 0.05), sigma_s=(0.6, 0.5, 0.4), scale=1.5)


def medium_cbox(width=64, height=64, ns=192, nt=96, device="cpu"):
    """The in-repo stand-in for the reference's medium-cbox.xml (a glass
    bunny holding an isotropic medium inside an HG fog box): the cornell
    walls and ceiling light; a fog box of forward faces, x, z in [0.1, 0.9]
    and y in [0.002, 0.75], holding medium_box's HG medium (g 0.3); inside
    it a smooth-glass torus (ior 1.5; R 0.22, r 0.09, ns x nt quads)
    holding an isotropic medium (sigma_a 0.02, sigma_s 2.0). At the default
    tessellation 36,888 triangles, media nested two deep. Returns (scene,
    camera, builder)."""
    b = SceneBuilder()
    _cornell_shell(b, 12.0)
    hg = b.add_medium(MediumSpec(**FOG_MEDIUM, phase_type=T.PHASE_HG, phase_g=(0.3, 0.0)))
    iso = b.add_medium(MediumSpec(sigma_a=(0.02, 0.02, 0.02), sigma_s=(2.0, 2.0, 2.0)))
    fog = b.add_bsdf(BSDFSpec(btype=T.BSDF_FORWARD))
    glass = b.add_bsdf(BSDFSpec(btype=T.BSDF_TRANSLUCENT, k_s=(0.98, 0.98, 0.98), ior=1.5))
    for face in _closed_box((0.1, 0.002, 0.1), (0.9, 0.75, 0.9)):
        b.add_mesh(face, fog, medium_in=hg)
    p, n, uv = _torus_mesh((0.5, 0.35, 0.5), R=0.22, r=0.09, ns=ns, nt=nt)
    b.add_mesh(p, glass, n=n, uv=uv, medium_in=iso)
    return b.compile(device=device), _cornell_camera(width, height, device), b

