"""Fused whole-path megakernel: scene pack, envelope check, kernel wrappers
(port of cuda_pt_tpu/ops/pallas/megakernel.py for the whole-path mode).

``trace_megakernel`` replaces the TPU kernel ``_kernel`` (megakernel.py:500)
as driven by ``trace_megakernel`` (:2963, pallas_call :3083) over the TPU
kernel's envelope: nine BSDF families (all but Plastic-forward), area,
area-spot and point emitters, envmaps, diffuse-textured Lambertian and
Oren-Nayar, and wavelength-locked dispersion (K2 with the K3 flags
``has_env``, ``textured``, ``has_disp``), and homogeneous participating
media for the volume path tracer (K4, ``has_media``: packs made with
``vpt=True``), w8 nodes and f32 attrs and prims. The CUDA source is
csrc/megakernel.cu; it is built with nvcc at first use (ops/cuda_build.py).

Every wrapper here takes the plain PyTorch version for CPU tensors and
only for them; for CUDA tensors it launches its kernel or raises. Each
launch adds one to ``LAUNCHES[name]``; a launch of the trace kernel also
adds one to ``INSTANTIATION_LAUNCHES`` under the name of the template
instantiation the C side reports it launched (``"K3+ALL+MED"``, ...).

Kernels:
- ``trace_megakernel``: the whole path per ray -> L (B, 3). Plain version
  ``trace_megakernel_reference``: the path tracer of models/path_tracer.py
  in its ``fused`` mode (the TPU kernel's estimator) on ``kernel_scene``;
  for a pack with ``has_media`` the volume path tracer of
  models/volume_pt.py in its ``fused`` mode. The pack alone decides both
  this and the kernel's instantiation.
- ``closest_hit_w8``: the same device walk alone -> (t, prim, b1, b2).
  Plain version: brute force up to path_tracer.BRUTE_FORCE_MAX_PRIMS
  prims, the skip walk of accel/traverse.py above. It exists so a walk
  bug shows as wrong prim ids, not as a noisy image.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..accel import traverse
from ..accel import wide_build
from ..core import camera as cam_mod
from ..core import qmc
from ..models import path_tracer as pt
from ..models import volume_pt
from ..scene import types as T
from . import cuda_build
from . import intersect as isect

SLOTS = 8  # slots per 128-float row
SLOT_F = 16  # f32 fields per slot
# Limits that shape the packed tables (the TPU kernel's, kept): one
# emitter row of 8 slots (slot 0 = null; passed to nvcc), the emitter-prim
# table, the material table.
MAX_EMITTERS = 8
MAX_EMITTER_PRIMS = 56
MAX_BSDFS = 32
# Leaf stack entries pack cnt into 4 bits (csrc/walk.cuh).
MK_MAX_LEAF = 15
# The TPU kernel's surface families; Plastic-forward stays composed-only.
KERNEL_BSDFS = (T.BSDF_LAMBERTIAN, T.BSDF_SPECULAR, T.BSDF_TRANSLUCENT, T.BSDF_PLASTIC,
                T.BSDF_GGX_CONDUCTOR, T.BSDF_DISPERSION, T.BSDF_FORWARD,
                T.BSDF_GGX_DIELECTRIC, T.BSDF_OREN_NAYAR)
# The families of the kernel's pruned build (csrc/bsdf.cuh, ALL = false).
BASIC_BSDFS = (T.BSDF_LAMBERTIAN, T.BSDF_SPECULAR, T.BSDF_TRANSLUCENT)
KERNEL_EMITTERS = (T.EMITTER_NULL, T.EMITTER_POINT, T.EMITTER_AREA, T.EMITTER_AREA_SPOT,
                   T.EMITTER_ENVMAP)
# K4: the single media row holds 8 slots; the phase functions it evaluates
# (SGGX falls back to isotropic)
MAX_MEDIA = 8
KERNEL_PHASES = (T.PHASE_ISOTROPIC, T.PHASE_HG, T.PHASE_DUAL_HG, T.PHASE_RAYLEIGH, T.PHASE_SGGX)

LAUNCHES = {"trace_megakernel": 0, "closest_hit_w8": 0}
INSTANTIATION_LAUNCHES = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    INSTANTIATION_LAUNCHES.clear()


def instantiation_name(variant: int) -> str:
    """csrc/megakernel.cu's instantiation bits (K3 1, ALL 2, MED 4) as a
    name, "K2" for the pruned surface build."""
    flags = [name for bit, name in ((1, "K3"), (2, "ALL"), (4, "MED")) if variant & bit]
    return "+".join(flags) or "K2"


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------


def _real_k(cdf_row, sel_row) -> int:
    """Real prim entries of a (K,) emitter cdf row (padding repeats the
    last prim with cdf 1.0)."""
    k = cdf_row.shape[0]
    while k > 1 and cdf_row[k - 2] >= 1.0 and sel_row[k - 1] == sel_row[k - 2]:
        k -= 1
    return k


def scene_has_media(scene: T.Scene) -> bool:
    """An object holds a medium or the camera sits in one."""
    return int(scene.objects.medium_in.max()) >= 0 or scene.cam_medium >= 0


def megakernel_ok(scene: T.Scene, md=None, renderer: str = "pt") -> bool:
    """Host-side envelope check: the TPU kernel's (megakernel.py:131) without
    its VMEM-residency limits (FUSED_VMEM_BUDGET_BYTES, AUTO_COMPACT_BYTES,
    the tile-state bytes), which the card does not have: the kernel reads
    its tables from device memory. Families: all surface ones but
    Plastic-forward; emitters: null, point, area, area-spot, envmap;
    textures: the diffuse slot of Lambertian / Oren-Nayar on triangle
    scenes only; no ToF. Media only under renderer="vpt" (the volume path
    tracer), as on the TPU (:188-216): at most MAX_MEDIA of them,
    homogeneous only (grid media need kernel K6), phases of KERNEL_PHASES,
    no textures. The reference's strict=True cap (its auto-pick's
    TPU-fault gate) has no counterpart: the port's Renderer always takes
    the kernel, like an explicit traversal='fused' there."""
    if scene_has_media(scene) or renderer == "vpt":
        mt = _np(scene.media.mtype)
        if renderer != "vpt" or mt.shape[0] > MAX_MEDIA or (mt == T.MEDIUM_GRID).any():
            return False
        if set(int(x) for x in _np(scene.media.phase_type)) - set(KERNEL_PHASES):
            return False
        if _np(scene.bsdfs.tex_ids).max(initial=-1) >= 0:
            return False
    if set(scene.present_bsdfs) - set(KERNEL_BSDFS):
        return False
    bt = _np(scene.bsdfs.btype)
    if bt.shape[0] > MAX_BSDFS:
        return False
    et = _np(scene.emitters.etype)
    if et.shape[0] > MAX_EMITTERS or set(int(x) for x in et) - set(KERNEL_EMITTERS):
        return False
    if np.where(et == T.EMITTER_ENVMAP, -1, _np(scene.emitters.tex_id)).max(initial=-1) >= 0:
        return False  # textured geometric emitters stay composed-only
    tids = _np(scene.bsdfs.tex_ids)
    if np.delete(tids, T.TEX_DIFFUSE, axis=1).max(initial=-1) >= 0:
        return False
    has_dt = tids[:, T.TEX_DIFFUSE] >= 0
    if (has_dt & ~np.isin(bt, (T.BSDF_LAMBERTIAN, T.BSDF_OREN_NAYAR))).any():
        return False
    sph = _np(scene.geom.is_sphere)
    if has_dt.any() and sph.any():
        return False  # the uv capture is triangle-only, as on the TPU
    if md is not None and md.max_time > 0.0:
        return False
    if int(scene.bvh.max_leaf) > MK_MAX_LEAF:
        return False
    cdf = _np(scene.emitters.prim_cdf)
    sel = _np(scene.emitters.prim_sel)
    n_eprims = 0
    for e in range(et.shape[0]):
        if et[e] in (T.EMITTER_AREA, T.EMITTER_AREA_SPOT):
            k = _real_k(cdf[e], sel[e])
            n_eprims += k
            if sph[sel[e, :k]].any():
                return False  # sphere emitter prims stay outside the envelope
    return n_eprims <= MAX_EMITTER_PRIMS


def kernel_emitter_pmf(scene: T.Scene):
    """(etype, sel_pmf, sel_cdf) as the kernel sees them (NumPy): with an
    envmap, its slot becomes a null emitter and the pick is renormalized
    over the geometric emitters (the TPU pack's rule, megakernel.py:364),
    since the kernel never NEE-samples the environment."""
    e = scene.emitters
    et = _np(e.etype)
    pmf = _np(e.sel_pmf).astype(np.float32).copy()
    cdf = _np(e.sel_cdf).astype(np.float32)
    env_mask = et == T.EMITTER_ENVMAP
    if env_mask.any():
        pmf[env_mask] = 0.0
        pmf = pmf / max(float(pmf.sum()), 1e-12)
        cdf = np.cumsum(pmf).astype(np.float32)
        if cdf[-1] > 0:
            cdf /= cdf[-1]
        else:
            cdf[:] = 1.0
    return np.where(env_mask, T.EMITTER_NULL, et).astype(np.int32), pmf, cdf


def kernel_scene(scene: T.Scene) -> T.Scene:
    """The scene as the kernel's estimator sees it: the emitter pick of
    kernel_emitter_pmf, and no envmap importance tables (no envmap NEE, so
    no u_tex draw). The envmap keeps its id, emission and texture for the
    miss lookup."""
    if scene.env_emitter <= 0:
        return scene
    et, pmf, cdf = kernel_emitter_pmf(scene)
    dev = scene.device
    emitters = dataclasses.replace(
        scene.emitters, etype=torch.as_tensor(et, device=dev),
        sel_pmf=torch.as_tensor(pmf, device=dev), sel_cdf=torch.as_tensor(cdf, device=dev))
    one = torch.ones((1, 1), device=dev)
    imp = T.EnvImportance(row_cdf=one[0], col_cdf=one, pmf=one)
    return dataclasses.replace(scene, emitters=emitters, env_importance=imp)


# ---------------------------------------------------------------------------
# scene pack (host side, NumPy; values identical to the TPU pack)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pack_rows(cols, pad_vals) -> np.ndarray:
    """Per-item field columns -> (rows, 128) f32: 8 slots of 16 fields per
    row, at least one full padding group of inert sentinel slots."""
    M = cols[0].shape[0]
    Mp = -(-max(M, 1) // SLOTS) * SLOTS + SLOTS
    out = [np.concatenate([np.asarray(c, np.float32), np.full(Mp - M, pv, np.float32)])
           for c, pv in zip(cols, pad_vals)]
    while len(out) < SLOT_F:
        out.append(np.zeros(Mp, np.float32))
    return np.stack(out, axis=1).reshape(Mp // SLOTS, SLOTS * SLOT_F)


def pack_prims(geom: T.Geometry) -> np.ndarray:
    """p0(3) e1(3) e2(3) is_sphere gid per slot; padding prims are degenerate."""
    p0, e1, e2 = _np(geom.p0), _np(geom.e1), _np(geom.e2)
    return _pack_rows(
        [p0[:, 0], p0[:, 1], p0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
         e2[:, 0], e2[:, 1], e2[:, 2], _np(geom.is_sphere).astype(np.float32),
         np.arange(p0.shape[0], dtype=np.float32)],
        [0.0] * 9 + [0.0, -1.0])


def _prim_medium_null(scene: T.Scene):
    obj = _np(scene.geom.obj_idx)
    med = _np(scene.objects.medium_in)[obj].astype(np.float32)
    bid = np.maximum(_np(scene.objects.bsdf_id)[obj], 0)
    bt = _np(scene.bsdfs.btype)[bid]
    cul = _np(scene.objects.cullable)[obj]
    return med, ((bt == T.BSDF_FORWARD) | cul).astype(np.float32)


def pack_attrs(scene: T.Scene) -> np.ndarray:
    """n0(3) n1(3) n2(3) eid inv_area bsdf_id medium_in is_null per prim."""
    g = scene.geom
    obj = _np(g.obj_idx)
    bid = np.maximum(_np(scene.objects.bsdf_id)[obj], 0)
    eid = _np(scene.objects.emitter_id)[obj].astype(np.float32)
    inv_a = _np(scene.objects.inv_area)[obj]
    med, nul = _prim_medium_null(scene)
    n0, n1, n2 = _np(g.n0), _np(g.n1), _np(g.n2)
    return _pack_rows(
        [n0[:, 0], n0[:, 1], n0[:, 2], n1[:, 0], n1[:, 1], n1[:, 2],
         n2[:, 0], n2[:, 1], n2[:, 2], eid, inv_a, bid.astype(np.float32), med, nul],
        [0.0] * 9 + [0.0, 0.0, 0.0, -1.0, 0.0])


def pack_media(scene: T.Scene) -> np.ndarray:
    """(1, 128): MAX_MEDIA slots of sigma_a(3) sigma_s(3) sigma_t(3), each
    times the medium's scale, phase_type g1 g2 w is_grid (the TPU pack's
    row; a grid medium's sigmas are zero there)."""
    m = scene.media
    V = int(m.mtype.shape[0])
    if V > MAX_MEDIA:
        raise ValueError(f"{V} media > MAX_MEDIA={MAX_MEDIA}")
    sc = _np(m.scale).astype(np.float32)[:, None]
    sa = _np(m.sigma_a).astype(np.float32) * sc
    ss = _np(m.sigma_s).astype(np.float32) * sc
    st = sa + ss
    is_grid = (_np(m.mtype) == T.MEDIUM_GRID).astype(np.float32)
    gz = (1.0 - is_grid)[:, None]
    sa, ss, st = sa * gz, ss * gz, st * gz
    g = _np(m.phase_g).astype(np.float32)
    cols = [sa[:, 0], sa[:, 1], sa[:, 2], ss[:, 0], ss[:, 1], ss[:, 2], st[:, 0], st[:, 1],
            st[:, 2], _np(m.phase_type).astype(np.float32), g[:, 0], g[:, 1],
            _np(m.phase_w).astype(np.float32), is_grid]
    out = [np.concatenate([c, np.zeros(MAX_MEDIA - V, np.float32)]) for c in cols]
    while len(out) < SLOT_F:
        out.append(np.zeros(MAX_MEDIA, np.float32))
    return np.stack(out, axis=1).reshape(1, MAX_MEDIA * SLOT_F).astype(np.float32)


def pack_bsdfs(scene: T.Scene) -> np.ndarray:
    """Two slots per bsdf: A = btype kd(3) ks(3) kg(3) ior ax ay;
    B = eta(3) k(3) thickness cauchy_a cauchy_b."""
    b = scene.bsdfs
    NB = int(b.btype.shape[0])
    P = _np(b.params)
    cols_a = np.zeros((NB, SLOT_F), np.float32)
    cols_b = np.zeros((NB, SLOT_F), np.float32)
    cols_a[:, 0] = _np(b.btype).astype(np.float32)
    cols_a[:, 1:4] = _np(b.k_d)
    cols_a[:, 4:7] = _np(b.k_s)
    cols_a[:, 7:10] = _np(b.k_g)
    cols_a[:, 10] = P[:, T.P_IOR]
    cols_a[:, 11] = np.maximum(P[:, T.P_ROUGH_X], 1e-4)
    cols_a[:, 12] = np.maximum(P[:, T.P_ROUGH_Y], 1e-4)
    cols_b[:, 0:3] = _np(b.eta)
    cols_b[:, 3:6] = _np(b.k)
    cols_b[:, 6] = P[:, T.P_THICKNESS]
    cols_b[:, 7] = P[:, T.P_CAUCHY_A]
    cols_b[:, 8] = P[:, T.P_CAUCHY_B]
    inter = np.stack([cols_a, cols_b], axis=1).reshape(2 * NB, SLOT_F)
    rows = -(-inter.shape[0] // SLOTS) * SLOTS
    out = np.zeros((rows, SLOT_F), np.float32)
    out[: inter.shape[0]] = inter
    return out.reshape(rows // SLOTS, SLOTS * SLOT_F)


def pack_emitters(scene: T.Scene) -> np.ndarray:
    """(1, 128): 8 emitter slots of etype em(3)=emission*scaler pos(3)
    sel_pmf sel_cdf kmax falloff. Padding emitters are null with cdf 1.0.
    The envmap rides as a null slot with the pick renormalized over the
    geometric emitters (kernel_emitter_pmf)."""
    e = scene.emitters
    E = int(e.etype.shape[0])
    if E > MAX_EMITTERS:
        raise ValueError(f"{E} emitter slots > MAX_EMITTERS={MAX_EMITTERS}")
    em = _np(e.emission) * _np(e.scaler)[:, None]
    cdfs, sels = _np(e.prim_cdf), _np(e.prim_sel)
    kmax = np.array([max(_real_k(cdfs[i], sels[i]) - 1, 0) for i in range(E)], np.float32)
    et_np = _np(e.etype)
    et_k, pmf, cdf = kernel_emitter_pmf(scene)
    falloff = np.where(et_np == T.EMITTER_AREA_SPOT, _np(e.extra)[:, 0], -1.0).astype(np.float32)
    pos = _np(e.pos)
    cols = [et_k.astype(np.float32), em[:, 0], em[:, 1], em[:, 2],
            pos[:, 0], pos[:, 1], pos[:, 2], pmf, cdf, kmax, falloff]
    out = [np.concatenate([np.asarray(c, np.float32), np.zeros(MAX_EMITTERS - E, np.float32)])
           for c in cols]
    out[8][E:] = 1.0  # padding never selected
    while len(out) < SLOT_F:
        out.append(np.zeros(MAX_EMITTERS, np.float32))
    return np.stack(out, axis=1).reshape(1, MAX_EMITTERS * SLOT_F).astype(np.float32)


def pack_emitter_prims(scene: T.Scene) -> np.ndarray:
    """Emitter-prim slots: p0(3) e1(3) e2(3) cdf eid k inv_area_obj; padding
    slots carry cdf 2.0 and eid -1 (never selected)."""
    g = scene.geom
    e = scene.emitters
    et = _np(e.etype)
    cdfs, sels = _np(e.prim_cdf), _np(e.prim_sel)
    p0, e1, e2 = _np(g.p0), _np(g.e1), _np(g.e2)
    inv_area = _np(scene.objects.inv_area)
    obj_of = _np(g.obj_idx)
    rows = []
    for eid in range(et.shape[0]):
        if et[eid] not in (T.EMITTER_AREA, T.EMITTER_AREA_SPOT):
            continue
        for k in range(_real_k(cdfs[eid], sels[eid])):
            prim = int(sels[eid, k])
            rows.append([*p0[prim], *e1[prim], *e2[prim], float(cdfs[eid, k]), float(eid),
                         float(k), float(inv_area[obj_of[prim]])])
    S = len(rows)
    Sp = max(-(-max(S, 1) // SLOTS) * SLOTS, SLOTS)
    arr = np.zeros((Sp, SLOT_F), np.float32)
    for i, r in enumerate(rows):
        arr[i, : len(r)] = r
    arr[S:, 9] = 2.0
    arr[S:, 10] = -1.0
    return arr.reshape(Sp // SLOTS, SLOTS * SLOT_F)


def pack_nodes_w8(wb: T.WideBVHArrays) -> np.ndarray:
    """(W, 128): child c of wide node w at lane c*9 = [lo(3), hi(3), enc,
    base, cnt]; enc >= 0 interior wide id, -1 leaf, -2 empty (inverted box)."""
    cmin = _np(wb.child_min).astype(np.float32)
    cmax = _np(wb.child_max).astype(np.float32)
    enc = _np(wb.child_node)
    lbase, lcnt = _np(wb.leaf_base), _np(wb.leaf_count)
    W = enc.shape[0]
    is_leaf = (enc < 0) & (enc != wide_build.EMPTY)
    lid = np.where(is_leaf, -(enc + 1), 0)
    enc_f = np.where(enc == wide_build.EMPTY, -2.0, np.where(is_leaf, -1.0, enc.astype(np.float32)))
    base_f = np.where(is_leaf, lbase[lid], 0).astype(np.float32)
    cnt_f = np.where(is_leaf, lcnt[lid], 0).astype(np.float32)
    big = np.float32(1e30)
    used = (is_leaf | (enc >= 0))[..., None]
    lo = np.where(used, cmin, big)
    hi = np.where(used, cmax, -big)
    out = np.zeros((W, 128), np.float32)
    fields = np.concatenate([lo, hi, enc_f[..., None], base_f[..., None], cnt_f[..., None]], axis=-1)
    out[:, : 8 * 9] = fields.reshape(W, 72)
    return out


def pack_uvs(geom: T.Geometry) -> np.ndarray:
    """(P, 8) f32: uv0(2) uv1(2) uv2(2) and two padding fields per prim."""
    uv = np.concatenate([_np(geom.uv0), _np(geom.uv1), _np(geom.uv2)], axis=1)
    return np.concatenate([uv, np.zeros((uv.shape[0], 2), np.float32)], axis=1).astype(np.float32)


def pack_textures(atlas: T.TextureAtlas):
    """(texels (N, 4) f32, tinfo (K, 4) int32 = offset width height 0)."""
    info = np.stack([_np(atlas.offset), _np(atlas.width), _np(atlas.height),
                     np.zeros_like(_np(atlas.offset))], axis=1).astype(np.int32)
    return _np(atlas.texels).astype(np.float32), info


def pack_env(scene: T.Scene) -> np.ndarray:
    """(16,) f32: tex_id scale azimuth zenith base(3) of the envmap, where
    base = emission * scaler (the TPU pack's env_* epilogue inputs)."""
    out = np.zeros(SLOT_F, np.float32)
    eid = scene.env_emitter
    if eid > 0:
        e = scene.emitters
        extra = _np(e.extra)[eid]
        out[0] = float(_np(e.tex_id)[eid])
        out[1:4] = extra[0:3]
        out[4:7] = _np(e.emission)[eid] * _np(e.scaler)[eid]
    return out


@dataclasses.dataclass
class MKPack:
    """Kernel scene pack: row-packed f32 tables + static format flags, plus
    the source scene (the plain version renders from it)."""

    arrays: dict
    scene: T.Scene
    node_fmt: str = "w8"
    attr_fmt: str = "f32"
    prim_fmt: str = "f32"
    tri_only: bool = True
    max_leaf: int = 4
    max_stack: int = 0
    has_env: bool = False  # K3 flags (the TPU pack's, megakernel.py:2893-2917)
    textured: bool = False
    has_disp: bool = False
    # a family beyond Lambertian / Specular / Translucent is present (the
    # kernel's compile-time family pruning, csrc/bsdf.cuh)
    all_families: bool = True
    # K4 (the TPU pack's has_media, ambient_med): a vpt pack of a scene with
    # media; the medium of an empty stack (scene.cam_medium, -1 = none)
    has_media: bool = False
    ambient_med: int = -1

    def __getitem__(self, k):
        return self.arrays[k]

    @property
    def device(self) -> torch.device:
        return self.arrays["nodes"].device

    @property
    def flags(self) -> dict:
        return {"has_env": self.has_env, "textured": self.textured, "has_disp": self.has_disp}


# The six tables of the TPU pack (bit-equal to it), then kernel K3's and
# kernel K4's inputs.
PACK_KEYS = ("nodes", "prims", "attrs", "erow", "eprims", "brows")
K3_KEYS = ("uvs", "texels", "tinfo", "tdiff", "envrow")
MED_KEYS = ("mrow",)


def make_pack(scene: T.Scene, node_fmt: str = "w8", attr_fmt: str | None = None,
              prim_fmt: str | None = None, vpt: bool = False) -> MKPack:
    """Host-side scene pack on the scene's device. Only the w8 node format
    with f32 attrs and prims is ported. vpt=True packs for the volume path
    tracer: a scene with media then sets has_media and carries the media
    row; without vpt such a scene raises, so the pack alone says which
    estimator both the kernel and its plain version run. The K3 and K4
    tables are placeholders of one row where their flag is off."""
    if node_fmt != "w8" or attr_fmt not in (None, "f32") or prim_fmt not in (None, "f32"):
        raise NotImplementedError(
            "only node_fmt='w8' with f32 attrs and prims is ported (ROADMAP Queue 2, K1)")
    wb = wide_build.from_bvharrays(scene.bvh)
    max_stack = int(wb.max_stack) + 8  # the TPU walk's unconditional 8-slot write
    if max_stack > cuda_build.MK_MAX_STACK:
        raise ValueError(
            f"scene needs a traversal stack of {max_stack} > {cuda_build.MK_MAX_STACK}")
    if int(scene.bvh.max_leaf) > MK_MAX_LEAF:
        raise ValueError(f"max_leaf {scene.bvh.max_leaf} > {MK_MAX_LEAF}")
    tdiff = _np(scene.bsdfs.tex_ids)[:, T.TEX_DIFFUSE].astype(np.int32)
    has_env = scene.env_emitter > 0
    textured = bool((tdiff >= 0).any())
    has_media = scene_has_media(scene)
    if has_media and not vpt:
        raise ValueError("a scene with media packs only for the volume path tracer: "
                         "make_pack(vpt=True), RendererType.VOLUME_PT")
    if has_media and textured:
        raise ValueError("the fused volume path tracer takes no textures (as on the TPU)")
    texels, tinfo = pack_textures(scene.textures)
    host = {
        "nodes": pack_nodes_w8(wb),
        "prims": pack_prims(scene.geom),
        "attrs": pack_attrs(scene),
        "erow": pack_emitters(scene),
        "eprims": pack_emitter_prims(scene),
        "brows": pack_bsdfs(scene),
        "uvs": pack_uvs(scene.geom) if textured else np.zeros((1, 8), np.float32),
        "texels": texels if (textured or has_env) else np.zeros((1, 4), np.float32),
        "tinfo": tinfo,
        "tdiff": tdiff,
        "envrow": pack_env(scene),
        "mrow": pack_media(scene) if has_media else np.zeros((1, 128), np.float32),
    }
    arrays = {k: torch.as_tensor(v, device=scene.device).contiguous() for k, v in host.items()}
    return MKPack(arrays, scene, tri_only=not bool(scene.geom.is_sphere.any()),
                  max_leaf=int(scene.bvh.max_leaf), max_stack=max_stack, has_env=has_env,
                  textured=textured, has_disp=T.BSDF_DISPERSION in set(scene.present_bsdfs),
                  all_families=bool(set(scene.present_bsdfs) - set(BASIC_BSDFS)),
                  has_media=has_media, ambient_med=int(scene.cam_medium) if vpt else -1)


def pack_bytes(pack: MKPack, keys=PACK_KEYS + K3_KEYS + MED_KEYS) -> int:
    return sum(pack[k].numel() * pack[k].element_size() for k in keys)


# ---------------------------------------------------------------------------
# lane order
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _tile_swizzle_np(width: int, height: int):
    """Morton (Z-order) pixel permutation (perm, inv), NumPy int32."""
    y, x = np.mgrid[0:height, 0:width]

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
        v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
        v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        v = (v | (v << 2)) & np.uint64(0x3333333333333333)
        v = (v | (v << 1)) & np.uint64(0x5555555555555555)
        return v

    code = spread(x.ravel()) | (spread(y.ravel()) << np.uint64(1))
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def tile_swizzle(width: int, height: int, device="cpu"):
    """(perm, inv) Z-order lane permutation: neighbouring lanes (a warp)
    trace a compact screen block. The pixel -> stream map is unchanged, so
    images are bit-identical to row-major order."""
    perm, inv = _tile_swizzle_np(int(width), int(height))
    return (torch.as_tensor(perm, dtype=torch.int64, device=device),
            torch.as_tensor(inv, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _tables(pack: MKPack):
    """Host array of the pack's table pointers (csrc/megakernel.cu
    make_pack_view order)."""
    ptrs = [pack[k].data_ptr() for k in PACK_KEYS + K3_KEYS + MED_KEYS]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _check_rays(pack: MKPack, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    if pack.device != dev:
        raise ValueError(f"pack on {pack.device}, rays on {dev}")
    for x in tensors:
        if x.device != dev or not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous and on one device")


def rng_bits(rng: torch.Tensor) -> torch.Tensor:
    """(B, 2) u32-in-int64 pcg states -> the same bits as int32."""
    if rng.dtype == torch.int32:
        return rng.contiguous()
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32).contiguous()


def trace_megakernel_reference(pack: MKPack, md, o, d, rng, nee_candidates: int = 1):
    """Plain PyTorch version of the kernel on the pack's scene with the
    kernel's emitter table. The pack decides the estimator, as it decides
    the kernel's instantiation: with has_media (a vpt pack of a scene with
    media, K4) the volume path tracer's fused estimator, else the path
    tracer's (envmap misses at MIS weight 1, deferred diffuse texels,
    in-stream dispersion wavelength; for scenes without the K3 flags the
    composed estimator itself), which ignores any media in the scene."""
    scene = kernel_scene(pack.scene)
    if pack.has_media:
        if nee_candidates != 1:
            raise ValueError("the fused volume path tracer takes nee_candidates=1")
        return volume_pt.trace_paths(scene, md, o, d, rng, fused=True)
    return pt.trace_paths(scene, md, o, d, rng, nee_candidates, fused=True)


def trace_megakernel(pack: MKPack, md, o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor,
                     nee_candidates: int = 1, count_stats: bool = False):
    """(B, 3) rays + (B, 2) pcg states -> L (B, 3). CPU tensors run the plain
    version; CUDA tensors launch the kernel. count_stats (CUDA only) also
    returns per-ray (B, 2) int32 [wide nodes expanded, prim tests], the
    shadow rays' transmittance walks included."""
    if pack.has_media and nee_candidates != 1:
        raise ValueError("the fused volume path tracer takes nee_candidates=1 (as on the TPU)")
    if o.device.type == "cpu":
        if count_stats:
            raise ValueError("count_stats counts kernel work; it needs CUDA tensors")
        return trace_megakernel_reference(pack, md, o, d, rng, nee_candidates)
    if o.dtype != torch.float32 or d.dtype != torch.float32 or o.shape != d.shape \
            or o.dim() != 2 or o.shape[1] != 3 or tuple(rng.shape) != (o.shape[0], 2):
        raise ValueError("expected o, d (B, 3) float32 and rng (B, 2)")
    rng32 = rng_bits(rng)
    _check_rays(pack, o, d, rng32)
    lib = cuda_build.load()
    B = o.shape[0]
    L = torch.empty_like(o)
    stats = torch.zeros((B, 2), dtype=torch.int32, device=o.device) if count_stats else None
    variant = ctypes.c_int(-1)
    rc = lib.mk_trace(_tables(pack), o.data_ptr(), d.data_ptr(), rng32.data_ptr(), L.data_ptr(),
                      stats.data_ptr() if stats is not None else None,
                      B, pack.max_leaf, int(pack.tri_only), int(pack.has_env),
                      int(pack.textured), int(pack.has_disp), int(pack.all_families),
                      int(pack.has_media), int(pack.ambient_med),
                      int(md.max_depth), int(md.max_diffuse), int(md.max_specular),
                      int(md.max_transmit), int(md.max_volume), int(nee_candidates),
                      ctypes.byref(variant), torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_trace launch failed: cudaError {rc}")
    LAUNCHES["trace_megakernel"] += 1
    name = instantiation_name(variant.value)
    INSTANTIATION_LAUNCHES[name] = INSTANTIATION_LAUNCHES.get(name, 0) + 1
    return (L, stats) if count_stats else L


def closest_hit_plain(scene: T.Scene, o: torch.Tensor, d: torch.Tensor) -> dict:
    """The path tracer's closest hit: brute force up to
    BRUTE_FORCE_MAX_PRIMS prims, the skip walk above."""
    if scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS:
        return traverse.closest_hit_bvh(scene.geom, scene.bvh, o, d)
    return isect.closest_hit_brute(scene.geom, o, d)


def closest_hit_w8(pack: MKPack, o: torch.Tensor, d: torch.Tensor):
    """Closest hit of (B, 3) rays -> (t, prim (int64, -1 = miss), b1, b2).
    CPU tensors run closest_hit_plain; CUDA tensors launch the w8 walk."""
    if o.device.type == "cpu":
        h = closest_hit_plain(pack.scene, o, d)
        return h["t"], h["prim"], h["b1"], h["b2"]
    if o.dtype != torch.float32 or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (B, 3) float32")
    _check_rays(pack, o, d)
    lib = cuda_build.load()
    B = o.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    rc = lib.mk_closest_hit(_tables(pack), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                            prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), B, pack.max_leaf,
                            int(pack.tri_only), torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_closest_hit launch failed: cudaError {rc}")
    LAUNCHES["closest_hit_w8"] += 1
    return t, prim.long(), b1, b2


def auto_trace(pack: MKPack, md, o, d, rng, nee_candidates: int = 1):
    """Driver pick of the reference (megakernel.py:3684). The TPU sent
    scenes of 512 boxes or more to the sorted-wavefront driver (kernel K5,
    not ported yet); here every scene takes the whole-path kernel, which
    has no VMEM limit and computes the same estimator."""
    return trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_candidates)


def render_pack(pack: MKPack, cam: cam_mod.Camera, md, spp: int, seed,
                nee_candidates: int = 1) -> torch.Tensor:
    """spp-pass render from a prebuilt pack -> (H, W, 3) mean, with the same
    per-(pixel, sample) pcg streams as models/path_tracer.render."""
    B = cam.width * cam.height
    perm, inv = tile_swizzle(cam.width, cam.height, pack.device)
    acc = torch.zeros((B, 3), device=pack.device)
    for i in range(spp):
        rng = qmc.make_state("pcg", seed, perm, i)
        o, d, rng = cam_mod.generate_rays(cam, perm, rng)
        acc = acc + auto_trace(pack, md, o, d, rng, nee_candidates)
    return (acc[inv] / spp).reshape(cam.height, cam.width, 3)
