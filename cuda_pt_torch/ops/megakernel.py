"""Fused megakernel: scene pack, envelope check, kernel wrappers and the
sorted-wavefront driver (port of cuda_pt_tpu/ops/pallas/megakernel.py).

``trace_megakernel`` replaces the TPU kernel ``_kernel`` (megakernel.py:500)
as driven by ``trace_megakernel`` (:2963, pallas_call :3083) over the TPU
kernel's envelope: nine BSDF families (all but Plastic-forward), area,
area-spot and point emitters, envmaps, diffuse-textured Lambertian and
Oren-Nayar, and wavelength-locked dispersion (K2 with the K3 flags
``has_env``, ``textured``, ``has_disp``), and homogeneous participating
media for the volume path tracer (K4, ``has_media``: packs made with
``vpt=True``), on every table format of the reference's make_pack: w8 or
binary nodes (the binary skip tree in f32 or bf16 rows), f32 or t9 prims,
f32 or bf16 attrs (``make_pack`` picks them by the reference's rule,
``AUTO_COMPACT_BYTES``). The CUDA source is csrc/megakernel.cu; it is
built with nvcc at first use (ops/cuda_build.py).

Every wrapper here takes the plain PyTorch version for CPU tensors and
only for them; for CUDA tensors it launches its kernel or raises. Each
launch adds one to ``LAUNCHES[name]``; a launch of the trace kernel or of
the segment kernel also adds one to ``INSTANTIATION_LAUNCHES`` under the
name of the template instantiation the C side reports it launched
(``"K3+ALL+MED"``, ``"SEG+K3+ALL"``, ``"SEG+SHADE+ALL+MED+GRID"``, ...).

Kernels:
- ``trace_megakernel``: the whole path per ray -> L (B, 3), on a
  persistent grid whose lanes take the next path as theirs ends (csrc/
  persist.cuh; one launch, the work counter resets in the kernel), with a
  small w8 pack's tables in shared memory (``stages``). Plain version
  ``trace_megakernel_reference``: the path tracer of models/path_tracer.py
  in its ``fused`` mode (the TPU kernel's estimator) on ``kernel_scene``;
  for a pack with ``has_media`` the volume path tracer of
  models/volume_pt.py in its ``fused`` mode. The pack alone decides both
  this and the kernel's instantiation. Node and prim formats change no hit;
  for bf16 attrs the plain version renders the scene with its vertex
  normals truncated to bf16 as the pack stores them (``pack_scene``).
- ``closest_hit_w8``: the same device walk alone (in the pack's node
  format; the name is the w8 walk's, the first one ported) -> (t, prim,
  b1, b2).
  Plain version: brute force up to path_tracer.BRUTE_FORCE_MAX_PRIMS
  prims, the skip walk of accel/traverse.py above. It exists so a walk
  bug shows as wrong prim ids, not as a noisy image.
- ``closest_hit_sorted``: the sorted-lane walk (csrc/walk.cuh, written
  for K5's sorted lanes; no render path runs it) alone on w8 packs ->
  (t, prim, b1, b2, the most entries each ray's stack held). Plain
  version: closest_hit_plain (no stack depth: None).
- ``trace_megakernel_seg`` (K5, csrc/seg.cuh): one bounce of the same path
  code on the carried state planes of the first n lanes, in place. Plain
  version ``seg_step_reference``: one ``seg`` bounce of the path tracer
  (models/path_tracer.py) or of the volume path tracer
  (models/volume_pt.py) on the pack's kernel scene.
- ``traverse_resolve`` (K6, csrc/megakernel_split.cu): the closest walk
  of the live lanes of the state planes and its hit resolve -> the SHADE
  form's hit planes (and, on request, the walk's (t, gid, u, v) planes).
  Plain version: resolve_hit of traverse_plain (closest_hit_plain on the
  live lanes).

``trace_megakernel_swf`` is the sorted-wavefront driver (K5 per bounce,
with the lanes re-sorted between bounces; for a grid pack its split form
adds K6 and the grid-media passes), ``auto_trace`` the reference's pick between it and
the whole-path kernel: the driver for a pack of SWF_AUTO_BOXES boxes or
more or with a grid medium, the whole-path kernel below. The two compute
the same estimator on untextured scenes (per lane); on textured ones the
driver's inline texturing lets Russian roulette see the texels of the
earlier bounces, where the whole-path kernel's deferred texturing does
not, so they agree in the mean only, as in the reference.
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
from ..core import rng as prng
from ..emitters import emitters
from ..media import grid as gridmod
from ..models import path_tracer as pt
from ..models import volume_pt
from ..scene import textures as tex
from ..scene import types as T
from . import cuda_build
from . import intersect as isect
from . import traverse_kernel as tk

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

# The driver pick (auto_trace): packs of this many boxes (pack_boxes) or
# more take the sorted-wavefront driver, as in the reference.
SWF_AUTO_BOXES = 512
# make_pack's format rule (the reference's, megakernel.py:2557): a scene
# whose pack would take more than this in f32 (fused_pack_bytes) gets bf16
# binary nodes (where no node format is asked for), bf16 attrs and, on an
# all-triangle scene, t9 prims. On the TPU this fitted the pack in VMEM;
# the card has no such limit, but the rule decides the image (bf16 attrs
# quantize the shading normals), so the port keeps it. attr_fmt="f32"
# keeps f32 attrs on any scene.
AUTO_COMPACT_BYTES = 2 * 1024 * 1024
T9_PER_ROW = 14  # t9 prims: 14 prims x 9 fields = 126 of a row's 128 floats
NODE_FMTS = ("w8", "f32", "bf16")
ATTR_FMTS = ("f32", "bf16")
PRIM_FMTS = ("f32", "t9")
# the table-format bits of the C entry points (csrc/common.cuh FMT_*)
FMT_BIN, FMT_NODE_BF16, FMT_PRIM_T9, FMT_ATTR_BF16 = 1, 2, 4, 8

# launches per wrapper: one dict with K1's (ops/traverse_kernel.py owns it;
# this module imports that one, not the other way round)
LAUNCHES = tk.LAUNCHES
LAUNCHES.update({"trace_megakernel": 0, "closest_hit_w8": 0, "closest_hit_sorted": 0,
                 "trace_megakernel_seg": 0, "traverse_resolve": 0})
INSTANTIATION_LAUNCHES = {}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    INSTANTIATION_LAUNCHES.clear()


def instantiation_name(variant: int) -> str:
    """The instantiation bits the C side reports (K3 1, ALL 2, MED 4; the
    segment kernel K5: SEG 8, SHADE 16, GRID 32; the table builds: BIN 64
    for binary nodes, CPT 128 for w8 nodes with t9 prims or bf16 attrs;
    STAGE 256 for the whole-path kernel with its tables in shared memory,
    ``stages``) as a name, "K2" for the pruned surface build ("SEG+K2" in
    segment form)."""
    bits = ((8, "SEG"), (16, "SHADE"), (1, "K3"), (2, "ALL"), (4, "MED"), (32, "GRID"),
            (64, "BIN"), (128, "CPT"), (256, "STAGE"))
    flags = [name for bit, name in bits if variant & bit]
    if not variant & 7:
        flags.insert(1 if variant & 8 else 0, "K2")
    return "+".join(flags)


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
    tracer), as on the TPU (:188-216): at most MAX_MEDIA of them, phases
    of KERNEL_PHASES, no textures; grid media (the split sorted-wavefront
    driver) without an envmap and without emission. The reference's strict=True cap (its auto-pick's
    TPU-fault gate) has no counterpart: the port's Renderer always takes
    the kernel, like an explicit traversal='fused' there."""
    if scene_has_media(scene) or renderer == "vpt":
        mt = _np(scene.media.mtype)
        if renderer != "vpt" or mt.shape[0] > MAX_MEDIA:
            return False
        if (mt == T.MEDIUM_GRID).any():
            if (_np(scene.emitters.etype) == T.EMITTER_ENVMAP).any():
                return False  # escaping rays would skip the grid transmittance
            if (_np(scene.media.emission_scale)[mt == T.MEDIUM_GRID] > 0.0).any():
                return False  # emissive grids stay on the composed route
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


def _bf16_truncated(x: torch.Tensor) -> torch.Tensor:
    """f32 values cut to their high 16 bits, as tk._pack2 stores a bf16
    field (not rounded to nearest, as Tensor.to(torch.bfloat16) would)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def pack_scene(pack) -> T.Scene:
    """The scene the pack's plain versions render: kernel_scene, with the
    vertex normals truncated to bf16 where the kernel reads them from bf16
    attrs. A grid pack's shade form takes its normals from g_hit, in f32,
    so its scene keeps them."""
    scene = kernel_scene(pack.scene)
    if pack.attr_fmt != "bf16" or pack.has_grid:
        return scene
    g = scene.geom
    geom = dataclasses.replace(g, n0=_bf16_truncated(g.n0), n1=_bf16_truncated(g.n1),
                               n2=_bf16_truncated(g.n2))
    return dataclasses.replace(scene, geom=geom)


# ---------------------------------------------------------------------------
# scene pack (host side, NumPy; values identical to the TPU pack)
# ---------------------------------------------------------------------------


# the TPU pack's prim table is K1's (the rows, field 10 the global prim id)
_np = tk._np
_pack_rows = tk._pack_rows
pack_prims = tk.pack_prims


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


def pack_prims_t9(geom: T.Geometry) -> np.ndarray:
    """(R, 128) triangle-only prim rows: p0(3) e1(3) e2(3) per prim, T9_PER_ROW
    prims per row, no id (make_pack packs the prims in id order, so the
    kernel takes the slot as the id); padding prims are degenerate."""
    p0, e1, e2 = _np(geom.p0), _np(geom.e1), _np(geom.e2)
    M = p0.shape[0]
    Mp = -(-max(M, 1) // T9_PER_ROW) * T9_PER_ROW + 2 * T9_PER_ROW
    cols = [np.concatenate([np.asarray(c, np.float32), np.zeros(Mp - M, np.float32)])
            for c in (p0[:, 0], p0[:, 1], p0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
                      e2[:, 0], e2[:, 1], e2[:, 2])]
    out = np.zeros((Mp // T9_PER_ROW, 128), np.float32)
    out[:, : T9_PER_ROW * 9] = np.stack(cols, axis=1).reshape(Mp // T9_PER_ROW, T9_PER_ROW * 9)
    return out


def pack_attrs_bf16(scene: T.Scene) -> np.ndarray:
    """(R, 128) compact attrs, 8 f32 per prim (16 prims per row): bf16 pairs
    (tk._pack2, the first in the high bits) n0x|n0y n0z|n1x n1y|n1z n2x|n2y
    n2z|is_sphere eid|bid, then inv_area in f32, then medium_in|is_null."""
    g = scene.geom
    obj = _np(g.obj_idx)
    bid = np.maximum(_np(scene.objects.bsdf_id)[obj], 0).astype(np.float32)
    eid = _np(scene.objects.emitter_id)[obj].astype(np.float32)
    inv_a = _np(scene.objects.inv_area)[obj]
    sph = _np(g.is_sphere).astype(np.float32)
    n0, n1, n2 = _np(g.n0), _np(g.n1), _np(g.n2)
    M = n0.shape[0]
    per_row = 2 * SLOTS
    Mp = -(-max(M, 1) // per_row) * per_row + per_row

    def pad(c, pv=0.0):
        return np.concatenate([np.asarray(c, np.float32), np.full(Mp - M, pv, np.float32)])

    med, nul = _prim_medium_null(scene)
    pack2 = tk._pack2
    cols = [pack2(pad(n0[:, 0]), pad(n0[:, 1])), pack2(pad(n0[:, 2]), pad(n1[:, 0])),
            pack2(pad(n1[:, 1]), pad(n1[:, 2])), pack2(pad(n2[:, 0]), pad(n2[:, 1])),
            pack2(pad(n2[:, 2]), pad(sph)), pack2(pad(eid), pad(bid)), pad(inv_a),
            pack2(pad(med, -1.0), pad(nul))]
    return np.stack(cols, axis=1).reshape(Mp // per_row, per_row * (SLOT_F // 2))


def fused_pack_bytes(scene: T.Scene, node_fmt: str = "f32", attr_fmt: str = "f32",
                     prim_fmt: str = "f32") -> int:
    """The reference's size of a pack (megakernel.py:86): nodes (64 B f32,
    32 B bf16) + prims (64 B f32, 37 B t9) + attrs (64 B f32, 32 B bf16) +
    the emitter and material tables. make_pack's rule reads it in f32."""
    n = int(scene.bvh.num_nodes)
    p = int(scene.geom.num_prims)
    nb = int(scene.bsdfs.btype.shape[0])
    node_b = 32 if node_fmt == "bf16" else 64
    prim_b = (512 // T9_PER_ROW + 1) if prim_fmt == "t9" else 64
    attr_b = 32 if attr_fmt == "bf16" else 64
    small = (2 * nb + SLOTS + MAX_EMITTER_PRIMS) * SLOT_F * 4
    return n * node_b + p * prim_b + p * attr_b + small


def resident_pack_bytes(scene: T.Scene) -> int:
    """fused_pack_bytes of the formats make_pack(scene) picks."""
    if fused_pack_bytes(scene) > AUTO_COMPACT_BYTES:
        tri = not bool(scene.geom.is_sphere.any())
        return fused_pack_bytes(scene, node_fmt="bf16", attr_fmt="bf16",
                                prim_fmt="t9" if tri else "f32")
    return fused_pack_bytes(scene)


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


def _np_sa(lo, hi) -> float:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def treelet_boxes_w8(wb: T.WideBVHArrays, max_tl: int = 64) -> np.ndarray:
    """(max_tl, 8) f32 treelet-root boxes [lo(3), hi(3), 0, 0] for the
    treelet sort keys (swf_sort_key "tl_*"): from the wide root, expand the
    frontier entry of largest surface area (interior entries only) until an
    expansion would exceed max_tl entries. The frontier (wide subtree roots
    and leaf boxes) partitions the scene; padding rows are inverted boxes."""
    cmin = _np(wb.child_min).astype(np.float32)
    cmax = _np(wb.child_max).astype(np.float32)
    enc = _np(wb.child_node)

    def entry(w, c):
        return (float(_np_sa(cmin[w, c], cmax[w, c])), cmin[w, c], cmax[w, c],
                int(enc[w, c]) if enc[w, c] >= 0 else -1)

    frontier = [entry(0, c) for c in range(8) if enc[0, c] != wide_build.EMPTY]
    while True:
        cand = [f for f in frontier if f[3] >= 0]
        if not cand:
            break
        best = max(cand, key=lambda f: f[0])
        w = best[3]
        kids = [entry(w, c) for c in range(8) if enc[w, c] != wide_build.EMPTY]
        if len(frontier) - 1 + len(kids) > max_tl:
            break
        frontier.remove(best)
        frontier.extend(kids)
    out = np.zeros((max_tl, 8), np.float32)
    out[:, 0:3] = np.float32(1e30)
    out[:, 3:6] = -np.float32(1e30)
    for i, (_, lo, hi, _w) in enumerate(frontier):
        out[i, 0:3] = lo
        out[i, 3:6] = hi
    return out


def pack_hit_matrix(scene: T.Scene) -> np.ndarray:
    """(M, 32) f32 per-prim rows from which one row gather resolves a hit
    for the split driver (resolve_hit): 0-2 n0, 3-5 n1, 6-8 n2, 9-11
    cross(e1, e2), 12-14 p0 (a sphere's centre), 15 eid, 16 bid, 17
    inv_area, 18 is_sphere, 19 medium_in, 20 is_null, 21-26 uv0 uv1 uv2."""
    g = scene.geom
    obj = _np(g.obj_idx)
    e1 = _np(g.e1).astype(np.float32)
    e2 = _np(g.e2).astype(np.float32)
    M = e1.shape[0]
    out = np.zeros((max(M, 1), 32), np.float32)
    if M:
        med, nul = _prim_medium_null(scene)
        out[:, 0:3] = _np(g.n0)
        out[:, 3:6] = _np(g.n1)
        out[:, 6:9] = _np(g.n2)
        out[:, 9:12] = np.cross(e1, e2)
        out[:, 12:15] = _np(g.p0)
        out[:, 15] = _np(scene.objects.emitter_id)[obj]
        out[:, 16] = np.maximum(_np(scene.objects.bsdf_id)[obj], 0)
        out[:, 17] = _np(scene.objects.inv_area)[obj]
        out[:, 18] = _np(g.is_sphere)
        out[:, 19] = med
        out[:, 20] = nul
        out[:, 21:23] = _np(g.uv0)
        out[:, 23:25] = _np(g.uv1)
        out[:, 25:27] = _np(g.uv2)
    return out


def pack_grids(scene: T.Scene) -> dict:
    """The split driver's grid tables (never read by a kernel): the dense
    grids of media/grid.py and per-medium gid, scale, albedo, is_grid, and
    per grid the density scale of the first medium that references it
    (the NEE pass tracks per grid)."""
    g, m = scene.grids, scene.media
    gids = _np(m.grid_id)
    scale = _np(m.scale).astype(np.float32)
    G = int(g.majorant.shape[0])
    gscale = np.ones(G, np.float32)
    for j in range(G):
        ref = np.nonzero(gids == j)[0]
        if ref.size:
            gscale[j] = scale[ref[0]]
    return {"gr_density": g.density, "gr_emis": g.emission, "gr_bmin": g.bbox_min,
            "gr_bmax": g.bbox_max, "gr_major": g.majorant, "gr_avg": g.avg_density,
            "gr_gid": m.grid_id, "gr_scale": m.scale, "gr_albedo": m.sigma_s,
            "gr_isg": (_np(m.mtype) == T.MEDIUM_GRID).astype(np.float32), "gr_gscale": gscale}


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
    # a grid medium: the split sorted-wavefront driver (the TPU pack's has_grid)
    has_grid: bool = False

    def __getitem__(self, k):
        return self.arrays[k]

    @property
    def device(self) -> torch.device:
        return self.arrays["nodes"].device

    @property
    def flags(self) -> dict:
        return {"has_env": self.has_env, "textured": self.textured, "has_disp": self.has_disp}


# The six tables of the TPU pack (bit-equal to it), then kernel K3's and
# kernel K4's inputs; the sorted-wavefront driver's tables (treelet boxes,
# the hit matrix of the split form: w8 packs only, as in the reference),
# and with a grid medium pack_grids'.
PACK_KEYS = ("nodes", "prims", "attrs", "erow", "eprims", "brows")
K3_KEYS = ("uvs", "texels", "tinfo", "tdiff", "envrow")
MED_KEYS = ("mrow",)
SWF_KEYS = ("tlbox", "g_hit")
# the tables the whole-path kernel's STAGE builds copy into shared memory
# (csrc/trace.cuh), in its order; K6's (csrc/megakernel_split.cu): the walk
# tables and g_hit, all three or none
STAGE_KEYS = ("nodes", "prims", "attrs", "brows", "erow", "eprims")
K6_STAGE_KEYS = ("nodes", "prims", "g_hit")


def make_pack(scene: T.Scene, node_fmt: str | None = None, attr_fmt: str | None = None,
              prim_fmt: str | None = None, vpt: bool = False) -> MKPack:
    """Host-side scene pack on the scene's device, in the reference's formats
    and by its rule: a format left None is f32 (binary f32 nodes) where the
    pack's f32 size (fused_pack_bytes) is at most AUTO_COMPACT_BYTES, else
    compact: bf16 binary nodes (boxes rounded outward: the same hits), bf16
    attrs (shading normals truncated to bf16) and, on an all-triangle scene,
    t9 prims (f32 positions: the same hits). node_fmt "w8" is the 8-wide
    tree the Renderer asks for. vpt=True packs for the volume path tracer:
    a scene with media then sets has_media and carries the media row;
    without vpt such a scene raises, so the pack alone says which
    estimator both the kernel and its plain version run. The K3 and K4
    tables are placeholders of one row where their flag is off. A w8 pack
    carries the driver's tlbox and g_hit (as the reference's); a vpt pack
    with a grid medium sets has_grid and carries pack_grids' tables."""
    big = fused_pack_bytes(scene) > AUTO_COMPACT_BYTES
    tri_only = not bool(scene.geom.is_sphere.any())
    node_fmt = node_fmt or ("bf16" if big else "f32")
    attr_fmt = attr_fmt or ("bf16" if big else "f32")
    prim_fmt = prim_fmt or ("t9" if big and tri_only else "f32")
    if node_fmt not in NODE_FMTS or attr_fmt not in ATTR_FMTS or prim_fmt not in PRIM_FMTS:
        raise ValueError(f"formats: node_fmt in {NODE_FMTS}, attr_fmt in {ATTR_FMTS}, "
                         f"prim_fmt in {PRIM_FMTS}; got {node_fmt!r}, {attr_fmt!r}, "
                         f"{prim_fmt!r}")
    if prim_fmt == "t9" and not tri_only:
        raise ValueError("prim_fmt='t9' requires an all-triangle scene")
    max_stack = 0
    if node_fmt == "w8":
        wb = wide_build.from_bvharrays(scene.bvh)
        max_stack = int(wb.max_stack) + 8  # the TPU walk's unconditional 8-slot write
        if max_stack > cuda_build.MK_MAX_STACK:
            raise ValueError(
                f"scene needs a traversal stack of {max_stack} > {cuda_build.MK_MAX_STACK}")
        nodes = pack_nodes_w8(wb)
    elif node_fmt == "bf16":
        nodes = tk.pack_nodes_bf16(scene.bvh)
    else:
        nodes = tk.pack_nodes(scene.bvh)
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
        "nodes": nodes,
        "prims": pack_prims_t9(scene.geom) if prim_fmt == "t9" else pack_prims(scene.geom),
        "attrs": pack_attrs_bf16(scene) if attr_fmt == "bf16" else pack_attrs(scene),
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
    if node_fmt == "w8":
        host.update(tlbox=treelet_boxes_w8(wb), g_hit=pack_hit_matrix(scene))
    has_grid = has_media and bool((_np(scene.media.mtype) == T.MEDIUM_GRID).any())
    if has_grid:
        host.update(pack_grids(scene))
    arrays = {k: torch.as_tensor(v, device=scene.device).contiguous() for k, v in host.items()}
    return MKPack(arrays, scene, node_fmt=node_fmt, attr_fmt=attr_fmt, prim_fmt=prim_fmt,
                  tri_only=tri_only, max_leaf=int(scene.bvh.max_leaf), max_stack=max_stack, has_env=has_env,
                  textured=textured, has_disp=T.BSDF_DISPERSION in set(scene.present_bsdfs),
                  all_families=bool(set(scene.present_bsdfs) - set(BASIC_BSDFS)),
                  has_media=has_media, ambient_med=int(scene.cam_medium) if vpt else -1,
                  has_grid=has_grid)


def pack_bytes(pack: MKPack, keys=PACK_KEYS + K3_KEYS + MED_KEYS) -> int:
    return sum(pack[k].numel() * pack[k].element_size() for k in keys)


def walk_args(pack: MKPack) -> tuple:
    """The walk's arguments of every C entry point: max_leaf, tri_only, the
    table formats as FMT_* bits, the binary tree's node count (the walk
    stops there)."""
    fmt = (0 if pack.node_fmt == "w8" else FMT_BIN) \
        | (FMT_NODE_BF16 if pack.node_fmt == "bf16" else 0) \
        | (FMT_PRIM_T9 if pack.prim_fmt == "t9" else 0) \
        | (FMT_ATTR_BF16 if pack.attr_fmt == "bf16" else 0)
    return pack.max_leaf, int(pack.tri_only), fmt, int(pack.scene.bvh.num_nodes)


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
    ptrs += [_nbytes(pack[k]) for k in STAGE_KEYS]  # what a STAGE build copies
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _fits(pack: MKPack, keys) -> bool:
    """csrc/stage.cuh's rule: each table a multiple of 16 bytes, together at
    most cuda_build.MK_STAGE_BYTES."""
    sizes = [_nbytes(pack[k]) for k in keys]
    return all(n % 16 == 0 for n in sizes) and sum(sizes) <= cuda_build.MK_STAGE_BYTES


def stages(pack: MKPack) -> bool:
    """Whether the whole-path kernel runs its STAGE build on the pack (the
    rule of csrc/trace.cuh): w8 nodes with f32 prims and attrs whose
    STAGE_KEYS tables fit (_fits)."""
    return (pack.node_fmt, pack.prim_fmt, pack.attr_fmt) == ("w8", "f32", "f32") \
        and _fits(pack, STAGE_KEYS)


def k6_stages(pack: MKPack) -> bool:
    """Whether the traverse kernel runs its STAGE build on the pack
    (csrc/megakernel_split.cu k6_stage): w8 nodes with f32 prims and attrs
    whose K6_STAGE_KEYS tables fit together (_fits)."""
    return (pack.node_fmt, pack.prim_fmt, pack.attr_fmt) == ("w8", "f32", "f32") \
        and _fits(pack, K6_STAGE_KEYS)


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
    scene = pack_scene(pack)
    if pack.has_media:
        if nee_candidates != 1:
            raise ValueError("the fused volume path tracer takes nee_candidates=1")
        return volume_pt.trace_paths(scene, md, o, d, rng, fused=True)
    return pt.trace_paths(scene, md, o, d, rng, nee_candidates=nee_candidates, fused=True)


def trace_megakernel(pack: MKPack, md, o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor,
                     nee_candidates: int = 1, count_stats: bool = False):
    """(B, 3) rays + (B, 2) pcg states -> L (B, 3). CPU tensors run the plain
    version; CUDA tensors launch the kernel. count_stats (CUDA only) also
    returns per-ray (B, 2) int32 [wide nodes expanded (binary nodes: node
    fetches), prim tests], the shadow rays' transmittance walks included."""
    if pack.has_media and nee_candidates != 1:
        raise ValueError("the fused volume path tracer takes nee_candidates=1 (as on the TPU)")
    if pack.has_grid:
        raise ValueError("a grid-media pack takes the split sorted-wavefront driver "
                         "(trace_megakernel_swf: kernels K6 and K5's shade phase)")
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
                      B, *walk_args(pack), int(pack.has_env),
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
    CPU tensors run closest_hit_plain; CUDA tensors launch the walk of the
    pack's node format (w8 or binary)."""
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
                            prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), B, *walk_args(pack),
                            torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_closest_hit launch failed: cudaError {rc}")
    LAUNCHES["closest_hit_w8"] += 1
    return t, prim.long(), b1, b2


def closest_hit_sorted(pack: MKPack, o: torch.Tensor, d: torch.Tensor):
    """Closest hit of (B, 3) rays by the sorted-lane walk (w8 packs) ->
    (t, prim (int64, -1 = miss), b1, b2, depth: the most entries each ray's
    stack held, int32). CPU tensors run closest_hit_plain (depth None); CUDA
    tensors launch the walk."""
    if pack.node_fmt != "w8":
        raise ValueError("the sorted-lane walk takes w8 packs")
    if o.device.type == "cpu":
        h = closest_hit_plain(pack.scene, o, d)
        return h["t"], h["prim"], h["b1"], h["b2"], None
    if o.dtype != torch.float32 or o.shape != d.shape or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (B, 3) float32")
    _check_rays(pack, o, d)
    lib = cuda_build.load()
    B = o.shape[0]
    t = torch.empty(B, dtype=torch.float32, device=o.device)
    prim = torch.empty(B, dtype=torch.int32, device=o.device)
    depth = torch.empty(B, dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    rc = lib.mk_closest_hit_sorted(_tables(pack), o.data_ptr(), d.data_ptr(), t.data_ptr(),
                                   prim.data_ptr(), b1.data_ptr(), b2.data_ptr(),
                                   depth.data_ptr(), B, *walk_args(pack),
                                   torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_closest_hit_sorted launch failed: cudaError {rc}")
    LAUNCHES["closest_hit_sorted"] += 1
    return t, prim.long(), b1, b2, depth


# ---------------------------------------------------------------------------
# the sorted-wavefront driver: kernels K5 (one bounce per launch) and K6
# ---------------------------------------------------------------------------

# State planes of the segment kernel (csrc/seg.cuh): int32 (n_state, B),
# floats as their bits, the pcg state as u32 bits (the reference's
# _SEG_STATE order, megakernel.py:2445-2455).
S_O, S_D, S_THP, S_L, S_ACT = 2, 5, 8, 11, 14
S_PPDF, S_PDELTA, S_NDIFF, S_WL, S_ENV = 15, 16, 17, 20, 21
# sort key of a dead lane: dead lanes sort last
DEAD_KEY = 1 << 30
KEY_MODES = ("none", "dir_pos", "pos_dir", "tl_pos", "tl_oct")


@dataclasses.dataclass(frozen=True)
class SegLayout:
    """First plane of each optional block of the state, -1 where absent."""

    n_state: int
    env: int  # has_env: miss direction(3), miss throughput(3)
    med: int  # has_media: stk0 stk1 stk2 mtop n_vol
    tex: int  # textured: NEE contribution(3), bid, u, v
    grid: int  # has_grid: NEE contribution(3), segment start(3), end(3)


def seg_layout(pack: MKPack) -> SegLayout:
    med = S_ENV + (6 if pack.has_env else 0)
    rec = med + (5 if pack.has_media else 0)
    n = rec + (6 if pack.textured else 0) + (9 if pack.has_grid else 0)
    return SegLayout(n, S_ENV if pack.has_env else -1, med if pack.has_media else -1,
                     rec if pack.textured else -1, rec if pack.has_grid else -1)


def seg_init(pack: MKPack, o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor) -> torch.Tensor:
    """The state planes of rays (B, 3) with pcg states (B, 2) at bounce 0."""
    lay = seg_layout(pack)
    f = torch.zeros((lay.n_state, o.shape[0]), dtype=torch.float32, device=o.device)
    f[S_O:S_O + 3] = o.T
    f[S_D:S_D + 3] = d.T
    f[S_THP:S_THP + 3] = 1.0
    f[S_ACT] = 1.0
    f[S_PPDF] = 1.0
    f[S_PDELTA] = 1.0
    if lay.env >= 0:
        f[lay.env + 2] = 1.0  # the reference's unused miss direction (0, 0, 1)
    if lay.med >= 0:
        f[lay.med:lay.med + 4] = -1.0
    if lay.tex >= 0:
        f[lay.tex + 3] = -1.0
    st = f.view(torch.int32)
    st[0:2] = rng_bits(rng).T
    return st


def _f32(st: torch.Tensor) -> torch.Tensor:
    return st.view(torch.float32)


def _vec(f: torch.Tensor, k: int, n: int) -> torch.Tensor:
    return f[k:k + 3, :n].T.contiguous()


def _seg_state(pack: MKPack, st: torch.Tensor, n: int, bounce: int):
    """The first n lanes of the planes as the plain bounce's path state."""
    lay = seg_layout(pack)
    f = _f32(st)
    common = dict(
        o=_vec(f, S_O, n), d=_vec(f, S_D, n), thp=_vec(f, S_THP, n), L=_vec(f, S_L, n),
        rng=(st[0:2, :n].T.to(torch.int64) & prng.MASK32).contiguous(),
        active=f[S_ACT, :n] > 0.5, prev_pdf=f[S_PPDF, :n].clone(),
        prev_delta=f[S_PDELTA, :n] > 0.5, env_pdf=torch.zeros(n, device=st.device),
        n_diff=f[S_NDIFF, :n].to(torch.int32), n_spec=f[S_NDIFF + 1, :n].to(torch.int32),
        n_trans=f[S_NDIFF + 2, :n].to(torch.int32), dist=torch.zeros(n, device=st.device),
        wl=f[S_WL, :n].clone(), bounce=bounce)
    rec = None
    if lay.env >= 0:
        rec = {"miss_d": _vec(f, lay.env, n), "miss_thp": _vec(f, lay.env + 3, n)}
    if lay.med < 0:
        return pt.PTState(**common, rec=rec)
    return volume_pt.VPTState(
        **common, n_vol=f[lay.med + 4, :n].to(torch.int32),
        med_stack=f[lay.med:lay.med + 3, :n].T.to(torch.int32).contiguous(),
        med_top=f[lay.med + 3, :n].to(torch.int32), rec=rec)


def _seg_store(pack: MKPack, st: torch.Tensor, n: int, s):
    """Write the plain bounce's state and records into the first n lanes."""
    lay = seg_layout(pack)
    f = _f32(st)
    st[0:2, :n] = rng_bits(s.rng).T
    for k, v in ((S_O, s.o), (S_D, s.d), (S_THP, s.thp), (S_L, s.L)):
        f[k:k + 3, :n] = v.T
    f[S_ACT, :n] = s.active.float()
    f[S_PPDF, :n] = s.prev_pdf
    f[S_PDELTA, :n] = s.prev_delta.float()
    for k, v in enumerate((s.n_diff, s.n_spec, s.n_trans)):
        f[S_NDIFF + k, :n] = v.float()
    f[S_WL, :n] = s.wl
    rec = s.rec or {}
    if lay.env >= 0:
        f[lay.env:lay.env + 3, :n] = rec["miss_d"].T
        f[lay.env + 3:lay.env + 6, :n] = rec["miss_thp"].T
    if lay.med >= 0:
        f[lay.med:lay.med + 3, :n] = s.med_stack.T.float()
        f[lay.med + 3, :n] = s.med_top.float()
        f[lay.med + 4, :n] = s.n_vol.float()
    if lay.tex >= 0:
        f[lay.tex:lay.tex + 3, :n] = rec["nee"].T
        f[lay.tex + 3, :n] = rec["bid"].float()
        f[lay.tex + 4:lay.tex + 6, :n] = rec["uv"].T
    if lay.grid >= 0:
        for j, key in enumerate(("gc", "gp0", "gp1")):
            f[lay.grid + 3 * j:lay.grid + 3 * j + 3, :n] = rec[key].T


def _hit_dict(pack: MKPack, hp: torch.Tensor) -> dict:
    """resolve_hit's planes as the plain bounce's resolved hit."""
    n = hp.shape[1]
    k = 10
    hit = {"t": hp[0], "hit": hp[1] > 0.5, "ns": hp[2:5].T, "ng": hp[5:8].T,
           "eid": hp[8].long(), "inva": hp[9],
           "sph": torch.zeros(n, dtype=torch.bool, device=hp.device)}
    if not pack.tri_only:
        hit["sph"] = hp[k] > 0.5
        k += 1
    hit["bid"] = hp[k].long()
    k += 1
    hit["uv"] = torch.zeros((n, 2), device=hp.device)
    if pack.textured:
        hit["uv"] = hp[k:k + 2].T
        k += 2
    hit["med_obj"] = torch.full((n,), -1, dtype=torch.int32, device=hp.device)
    if pack.has_media:
        hit["med_obj"] = hp[k].to(torch.int32)
    return hit


def seg_step_reference(pack: MKPack, md, st: torch.Tensor, n: int, bounce: int,
                       nee_candidates: int = 1, hit: torch.Tensor | None = None,
                       flight: torch.Tensor | None = None, stats=None):
    """Plain version of the segment kernel: one ``seg`` bounce of the fused
    path tracer (the volume path tracer for a pack with media) on the
    first n lanes of the planes, in place. hit: resolve_hit's planes and
    flight: grid_flight's (the split driver, grid packs only); stats (the
    kernel's walk counters) is not counted here."""
    scene = pack_scene(pack)
    s = _seg_state(pack, st, n, bounce)
    hd = _hit_dict(pack, hit) if hit is not None else None
    if pack.has_media:
        if nee_candidates != 1:
            raise ValueError("the fused volume path tracer takes nee_candidates=1")
        fl = None if flight is None else {"t": flight[0], "is_medium": flight[1] > 0.5,
                                          "weight": flight[2:5].T}
        s = volume_pt.vpt_bounce(scene, md, s, fused=True, seg=True, hit=hd, flight=fl)
    else:
        s = pt.pt_bounce(scene, md, s, nee_candidates, fused=True, seg=True)
    _seg_store(pack, st, n, s)


def _check_state(pack: MKPack, st: torch.Tensor, n: int, *planes):
    if st.device.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {st.device}")
    if pack.device != st.device:
        raise ValueError(f"pack on {pack.device}, state on {st.device}")
    if st.dtype != torch.int32 or not st.is_contiguous() or st.dim() != 2 \
            or st.shape[0] != seg_layout(pack).n_state or not 0 <= n <= st.shape[1]:
        raise ValueError("expected contiguous int32 state planes (n_state, B) and 0 <= n <= B")
    for x in planes:
        if x is not None and (x.device != st.device or x.dtype != torch.float32
                              or not x.is_contiguous() or x.shape[1] != n):
            raise ValueError("hit and flight planes must be contiguous float32 (k, n) on the "
                             "state's device")


def trace_megakernel_seg(pack: MKPack, md, st: torch.Tensor, n: int, bounce: int,
                         nee_candidates: int = 1, hit: torch.Tensor | None = None,
                         flight: torch.Tensor | None = None, stats: torch.Tensor | None = None):
    """One bounce of the first n lanes of the state planes (n_state, B)
    int32, in place (kernel K5). A grid pack takes the SHADE form, which
    needs the split driver's resolved hit planes and flight planes; no
    other pack takes them. stats (CUDA only; (B, 2) int32) accumulates
    the walk work per slot. CPU tensors run seg_step_reference; CUDA
    tensors launch the kernel."""
    if pack.has_media and nee_candidates != 1:
        raise ValueError("the fused volume path tracer takes nee_candidates=1 (as on the TPU)")
    if pack.has_grid != (hit is not None) or pack.has_grid != (flight is not None):
        raise ValueError("a grid-media pack's bounce takes the split driver's hit and flight "
                         "planes, and only such a pack's")
    if pack.has_grid and pack.node_fmt != "w8":
        raise ValueError("split traversal needs a w8 pack (g_hit matrix)")
    if st.device.type == "cpu":
        return seg_step_reference(pack, md, st, n, bounce, nee_candidates, hit, flight)
    _check_state(pack, st, n, hit, flight)
    lib = cuda_build.load()
    variant = ctypes.c_int(-1)
    rc = lib.mk_trace_seg(_tables(pack), st.data_ptr(), st.shape[1], n, bounce,
                          hit.data_ptr() if hit is not None else None,
                          flight.data_ptr() if flight is not None else None,
                          stats.data_ptr() if stats is not None else None,
                          *walk_args(pack), int(pack.has_env), int(pack.textured),
                          int(pack.has_disp), int(pack.all_families), int(pack.has_media),
                          int(pack.has_grid), int(pack.ambient_med),
                          int(md.max_depth), int(md.max_diffuse), int(md.max_specular),
                          int(md.max_transmit), int(md.max_volume), int(nee_candidates),
                          ctypes.byref(variant), torch.cuda.current_stream(st.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_trace_seg launch failed: cudaError {rc}")
    LAUNCHES["trace_megakernel_seg"] += 1
    name = instantiation_name(variant.value)
    INSTANTIATION_LAUNCHES[name] = INSTANTIATION_LAUNCHES.get(name, 0) + 1


def traverse_plain(pack: MKPack, st: torch.Tensor, n: int, stats=None) -> torch.Tensor:
    """Plain version of K6: closest_hit_plain of the live lanes among the
    first n -> (4, n) planes t, gid, u, v (gid -1, t inf, u = v = 0 on a
    miss or a dead lane)."""
    f = _f32(st)
    live = f[S_ACT, :n] > 0.5
    h = pt.closest_hit(pack.scene, _vec(f, S_O, n), _vec(f, S_D, n), live)
    ok = live & h["hit"]
    return torch.stack([torch.where(ok, h["t"], torch.inf), torch.where(ok, h["prim"], -1).float(),
                        torch.where(ok, h["b1"], 0.0), torch.where(ok, h["b2"], 0.0)])


def hit_planes(pack: MKPack) -> int:
    """The number of hit planes resolve_hit stacks for the pack."""
    return 11 + (0 if pack.tri_only else 1) + (2 if pack.textured else 0) \
        + (2 if pack.has_media else 0)


def traverse_resolve(pack: MKPack, st: torch.Tensor, n: int, trav: torch.Tensor | None = None,
                     stats: torch.Tensor | None = None) -> torch.Tensor:
    """The closest hit of the live lanes among the first n of the state
    planes, resolved from the pack's g_hit -> the SHADE form's hit planes
    (hit_planes(pack), n) float32, as resolve_hit lays them out (kernel K6).
    trav ((4, n) float32): the walk's (t, gid, u, v) planes are written
    there too (gid -1, t inf, u = v = 0 on a miss or a dead lane). stats
    (CUDA only; (B, 2) int32) accumulates the walk work per lane. CPU
    tensors run the plain version, resolve_hit of traverse_plain; CUDA
    tensors launch the kernel."""
    if "g_hit" not in pack.arrays:
        raise ValueError("split traversal needs a w8 pack (g_hit matrix)")
    if st.device.type == "cpu":
        walk = traverse_plain(pack, st, n)
        if trav is not None:
            trav.copy_(walk)
        return resolve_hit(pack, walk)
    _check_state(pack, st, n, trav)
    if trav is not None and trav.shape[0] != 4:
        raise ValueError("trav must be (4, n) float32")
    out = torch.empty((hit_planes(pack), n), dtype=torch.float32, device=st.device)
    ghit = pack["g_hit"]
    rc = cuda_build.load().mk_traverse_resolve(
        _tables(pack), ghit.data_ptr(), _nbytes(ghit), st.data_ptr(), st.shape[1], n,
        out.data_ptr(), trav.data_ptr() if trav is not None else None,
        stats.data_ptr() if stats is not None else None, *walk_args(pack), int(pack.textured),
        int(pack.has_media), torch.cuda.current_stream(st.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_traverse_resolve launch failed: cudaError {rc}")
    LAUNCHES["traverse_resolve"] += 1
    return out


def resolve_hit(pack: MKPack, trav: torch.Tensor) -> torch.Tensor:
    """(t, gid, u, v) planes -> the SHADE kernel's hit planes by one row
    gather from the pack's g_hit (the reference's resolve_hit, :3404; on
    the card K6 does it in the kernel, traverse_resolve): t,
    hit, interpolated ns(3), raw ng(3) (a sphere's centre for both), eid,
    inv_area, [sphere flag], bid, [uv(2)], [medium_in, is_null]."""
    t, gidf, u, v = trav[0], trav[1], trav[2], trav[3]
    ghit = pack["g_hit"]
    row = ghit[torch.clamp(gidf.to(torch.int32), 0, ghit.shape[0] - 1).long()]
    w0 = 1.0 - u - v
    ns = w0[:, None] * row[:, 0:3] + u[:, None] * row[:, 3:6] + v[:, None] * row[:, 6:9]
    ng = row[:, 9:12]
    if not pack.tri_only:
        sph = (row[:, 18] > 0.5)[:, None]
        ns = torch.where(sph, row[:, 12:15], ns)
        ng = torch.where(sph, row[:, 12:15], ng)
    planes = [t, (gidf >= 0.0).float(), ns[:, 0], ns[:, 1], ns[:, 2], ng[:, 0], ng[:, 1],
              ng[:, 2], row[:, 15], row[:, 17]]
    if not pack.tri_only:
        planes.append(row[:, 18])
    planes.append(row[:, 16])
    if pack.textured:
        uv = w0[:, None] * row[:, 21:23] + u[:, None] * row[:, 23:25] + v[:, None] * row[:, 25:27]
        planes += [uv[:, 0], uv[:, 1]]
    if pack.has_media:
        planes += [row[:, 19], row[:, 20]]
    return torch.stack(planes).contiguous()


def _side_rng(st: torch.Tensor, n: int) -> torch.Tensor:
    """The grid passes' own pcg stream, xor-derived from the lane's (:3448):
    the kernel's stream advances a fixed number of draws per bounce, so the
    two never collide."""
    x = (st[0, :n].to(torch.int64) & prng.MASK32) ^ 0x9E3779B9
    y = (st[1, :n].to(torch.int64) & prng.MASK32) ^ 0x85EBCA6B
    return torch.stack([x, y], dim=-1)


def _grids(pack: MKPack) -> T.GridMediumData:
    return T.GridMediumData(density=pack["gr_density"], emission=pack["gr_emis"],
                            bbox_min=pack["gr_bmin"], bbox_max=pack["gr_bmax"],
                            majorant=pack["gr_major"], avg_density=pack["gr_avg"])


def grid_flight(pack: MKPack, st: torch.Tensor, n: int, t_surf: torch.Tensor) -> torch.Tensor:
    """Delta-tracked flight of the live lanes among the first n that run
    through a grid medium (:3458) -> (5, n) planes t, is_medium,
    weight(3); t_surf: the closest hit's t (inf on a miss)."""
    lay = seg_layout(pack)
    f = _f32(st)
    mtop = f[lay.med + 3, :n]
    s0, s1, s2 = f[lay.med, :n], f[lay.med + 1, :n], f[lay.med + 2, :n]
    cur = torch.where(mtop >= 2.0, s2, torch.where(mtop >= 1.0, s1, torch.where(
        mtop >= 0.0, s0, torch.full_like(s0, float(pack.ambient_med)))))
    curi = torch.clamp(cur.to(torch.int32), 0, pack["gr_isg"].shape[0] - 1).long()
    in_grid = (cur >= 0.0) & (pack["gr_isg"][curi] > 0.5) & (f[S_ACT, :n] > 0.5)
    gid = torch.clamp(pack["gr_gid"][curi], min=0).long()
    scale = pack["gr_scale"][curi]
    maj = torch.clamp(pack["gr_major"][gid] * scale, min=1e-6)
    res, _ = gridmod.sample_distance_arrays(
        _grids(pack), gid, scale, maj, pack["gr_albedo"][curi], _vec(f, S_O, n), _vec(f, S_D, n),
        torch.where(torch.isfinite(t_surf), t_surf, 1e8), _side_rng(st, n), in_grid)
    w = res["weight"]
    return torch.stack([res["t"], res["is_medium"].float(), w[:, 0], w[:, 1], w[:, 2]])


def grid_nee_resolve(pack: MKPack, st: torch.Tensor, n: int):
    """Ratio-track the recorded NEE segments of the first n lanes through
    every grid and add contribution * Tr to L, in place (:3482)."""
    lay = seg_layout(pack)
    f = _f32(st)
    c = f[lay.grid:lay.grid + 3, :n]
    p = _vec(f, lay.grid + 3, n)
    seg = _vec(f, lay.grid + 6, n) - p
    dist = torch.sqrt(torch.sum(seg * seg, dim=-1))
    dirn = seg / torch.clamp(dist, min=1e-8)[:, None]
    have = (c[0] + c[1] + c[2]) > 0.0
    tr_tot = torch.ones_like(dist)
    rng_t = _side_rng(st, n) ^ 0x51633E2D
    inv = 1.0 / torch.where(torch.abs(dirn) < 1e-9, torch.where(dirn < 0, -1e-9, 1e-9), dirn)
    grids = _grids(pack)
    for g in range(pack["gr_major"].shape[0]):
        t0s = (pack["gr_bmin"][g][None, :] - p) * inv
        t1s = (pack["gr_bmax"][g][None, :] - p) * inv
        tn = torch.amax(torch.minimum(t0s, t1s), dim=-1)
        tf = torch.amin(torch.maximum(t0s, t1s), dim=-1)
        t_in = torch.clamp(tn, min=0.0)
        seg_len = torch.clamp(torch.minimum(tf, dist) - t_in, min=0.0)
        act_g = have & (seg_len > 1e-6)
        scale = pack["gr_gscale"][g]
        maj = torch.clamp(pack["gr_major"][g] * scale, min=1e-6)
        tr_g, _ = gridmod.transmittance_residual_arrays(
            grids, torch.full_like(dist, g, dtype=torch.int64), scale, maj,
            p + t_in[:, None] * dirn, dirn, seg_len, rng_t ^ ((g * 0x632BE5AB) & prng.MASK32),
            act_g)
        tr_tot = tr_tot * torch.where(act_g, tr_g, 1.0)
    f[S_L:S_L + 3, :n] += c * tr_tot


def resolve_texels(pack: MKPack, st: torch.Tensor, n: int):
    """Inline texturing between bounces (:3593): the diffuse texel of each
    of the first n lanes' recorded hit multiplies its recorded NEE
    contribution, added to L, and its throughput, in place."""
    lay = seg_layout(pack)
    f = _f32(st)
    bidq = f[lay.tex + 3, :n]
    tdiff = pack["tdiff"]
    bid = torch.clamp(bidq.to(torch.int32), 0, tdiff.shape[0] - 1).long()
    tid = torch.where(bidq >= 0.0, tdiff[bid], -1)
    m = tex.sample_texture(pack.scene.textures, tid, _vec(f, lay.tex + 4, n)[:, :2])[:, :3]
    m = torch.where((tid >= 0)[:, None], m, 1.0).T
    f[S_L:S_L + 3, :n] += f[lay.tex:lay.tex + 3, :n] * m
    f[S_THP:S_THP + 3, :n] *= m


def _morton21(qx, qy, qz):
    """Interleave three 7-bit ints into a 21-bit Morton code."""

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return spread(qx) | (spread(qy) << 1) | (spread(qz) << 2)


def _nearest_treelet(tlbox, o, d):
    """Per-lane nearest-entered treelet box -> (entry t, exit t, index);
    a lane entering none gets index len(tlbox) and entry t 0."""

    def inv(v):
        return torch.where(torch.abs(v) < 1e-12, torch.full_like(v, 1e12), 1.0 / v)

    iv = torch.stack([inv(d[:, 0]), inv(d[:, 1]), inv(d[:, 2])], dim=-1)[:, None, :]
    t0 = (tlbox[None, :, 0:3] - o[:, None, :]) * iv
    t1 = (tlbox[None, :, 3:6] - o[:, None, :]) * iv
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    entered = (tn <= tf) & (tf > 1e-5)
    tval = torch.where(entered, torch.clamp(tn, min=0.0), torch.inf)
    tl = torch.argmin(tval, dim=1).to(torch.int32)
    tmin = torch.amin(tval, dim=1)
    none = ~entered.any(dim=1)
    tl = torch.where(none, tlbox.shape[0], tl).to(torch.int32)
    return torch.where(none, 0.0, tmin), tf, tl


def swf_sort_key(st: torch.Tensor, key_mode: str = "dir_pos", tlbox=None) -> torch.Tensor:
    """The reference's inter-bounce key (:3172) of the state planes, int32
    (B,): dead lanes DEAD_KEY (they sort last), live lanes grouped for walk
    coherence. "dir_pos": direction octant, then the Morton cell of the
    origin; "pos_dir": the reverse; "tl_pos": the nearest-entered treelet
    box (tlbox, make_pack's), then the Morton cell of the entry point;
    "tl_oct": the treelet, then the octant. Cells quantize each coordinate
    to 7 bits over the batch's range."""
    f = _f32(st)
    o = f[S_O:S_O + 3].T
    d = f[S_D:S_D + 3].T

    def q7(v):
        n_ = torch.clamp((v - v.min()) / torch.clamp(v.max() - v.min(), min=1e-12), 0.0, 0.9999)
        return (n_ * 128.0).to(torch.int32)

    oct_ = ((d[:, 0] < 0).to(torch.int32) * 4 + (d[:, 1] < 0).to(torch.int32) * 2
            + (d[:, 2] < 0).to(torch.int32))
    if key_mode.startswith("tl"):
        if tlbox is None:
            raise ValueError("treelet sort keys need the pack's treelet boxes (tlbox)")
        tn, _, tl = _nearest_treelet(tlbox, o, d)
        if key_mode == "tl_oct":
            key = (tl << 3) | oct_
        else:
            e = o + tn[:, None] * d
            key = (tl << 21) | _morton21(q7(e[:, 0]), q7(e[:, 1]), q7(e[:, 2]))
    else:
        m = _morton21(q7(o[:, 0]), q7(o[:, 1]), q7(o[:, 2]))
        key = (m << 3) | oct_ if key_mode == "pos_dir" else (oct_ << 21) | m
    return torch.where(f[S_ACT] > 0.5, key, DEAD_KEY).to(torch.int32)


def swf_sort(st: torch.Tensor, pix: torch.Tensor, key_mode: str, tlbox=None):
    """One re-sort of the driver's lanes by swf_sort_key, with one gather of
    all state planes as int32 (the pcg bits never pass through a float
    dtype) -> (state, pixel of each lane, live prefix n). Dead lanes sort
    last; key_mode "none" keeps the lanes in place and n is every lane
    while any is live, else 0."""
    if key_mode == "none":
        return st, pix, st.shape[1] if bool((_f32(st)[S_ACT] > 0.5).any()) else 0
    key = swf_sort_key(st, key_mode, tlbox)
    perm = torch.argsort(key, stable=True)
    return st[:, perm].contiguous(), pix[perm], int((key < DEAD_KEY).sum())


def swf_resolve(pack: MKPack, st: torch.Tensor, n: int):
    """The passes after a segment launch on the first n lanes, in place:
    the grid NEE segments ratio-tracked (grid_nee_resolve), the texels of
    the recorded hits (resolve_texels)."""
    if pack.has_grid:
        grid_nee_resolve(pack, st, n)
    if pack.textured:
        resolve_texels(pack, st, n)


def swf_result(pack: MKPack, st: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """L (B, 3) in pixel order: the planes' L plus the envmap epilogue
    thp * Le(d) of the recorded misses, un-permuted."""
    lay = seg_layout(pack)
    f = _f32(st)
    B = st.shape[1]
    L_s = f[S_L:S_L + 3].T
    if lay.env >= 0:
        L_s = L_s + _vec(f, lay.env + 3, B) * emitters.env_radiance(pack.scene, _vec(f, lay.env, B))
    L = torch.empty((B, 3), dtype=torch.float32, device=st.device)
    L[pix] = L_s
    return L


def trace_megakernel_swf(pack: MKPack, md, o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor,
                         nee_candidates: int = 1, key_mode: str = "dir_pos",
                         plain: bool | None = None):
    """Sorted-wavefront driver (the reference's trace_megakernel_swf, :3248):
    (B, 3) rays + (B, 2) pcg states -> L (B, 3). Per bounce: the lanes
    re-sorted (swf_sort; key_mode "none": kept in place), then one segment
    launch on the live prefix the sort leaves (dead lanes sort last;
    unsorted, every lane), then swf_resolve; until no lane is live or
    max_depth is reached; then swf_result. A grid pack takes the split
    form (as the reference forces it, :3332): each bounce first walks and
    resolves the hit with K6 (traverse_resolve; the reference's walk and
    row gather, resolve_hit) and delta-tracks the flight through the grid
    (grid_flight); the shade form of the segment kernel takes both.

    plain (default: CPU tensors) runs the plain versions of K5 and K6 on
    any device."""
    if key_mode not in KEY_MODES:
        raise ValueError(f"key_mode {key_mode!r} not in {KEY_MODES}")
    if pack.has_media and nee_candidates != 1:
        raise ValueError("the fused volume path tracer takes nee_candidates=1 (as on the TPU)")
    if o.dtype != torch.float32 or d.dtype != torch.float32 or o.shape != d.shape \
            or o.dim() != 2 or o.shape[1] != 3 or tuple(rng.shape) != (o.shape[0], 2):
        raise ValueError("expected o, d (B, 3) float32 and rng (B, 2)")
    if pack.has_grid and "g_hit" not in pack.arrays:
        raise ValueError("split traversal needs a w8 pack (g_hit matrix)")
    if key_mode.startswith("tl") and "tlbox" not in pack.arrays:
        raise ValueError("treelet sort keys need a w8 pack (its treelet boxes, tlbox)")
    if plain is None:
        plain = o.device.type == "cpu"
    if not plain:
        _check_rays(pack, o.contiguous())
    tlbox = pack["tlbox"] if key_mode.startswith("tl") else None
    step = seg_step_reference if plain else trace_megakernel_seg
    st = seg_init(pack, o, d, rng)
    pix = torch.arange(o.shape[0], device=o.device)
    for bounce in range(md.max_depth):
        st, pix, n = swf_sort(st, pix, key_mode, tlbox)
        if n == 0:
            break
        hit = flight = None
        if pack.has_grid:
            hit = resolve_hit(pack, traverse_plain(pack, st, n)) if plain \
                else traverse_resolve(pack, st, n)
            flight = grid_flight(pack, st, n, hit[0]).contiguous()
        step(pack, md, st, n, bounce, nee_candidates, hit, flight)
        swf_resolve(pack, st, n)
    return swf_result(pack, st, pix)


def trace_megakernel_swf_reference(pack: MKPack, md, o, d, rng, nee_candidates: int = 1,
                                   key_mode: str = "dir_pos"):
    """Plain version of the driver on any device: the plain versions of K5
    and K6 in the same driver."""
    return trace_megakernel_swf(pack, md, o, d, rng, nee_candidates, key_mode, plain=True)


def pack_boxes(pack: MKPack) -> int:
    """Boxes of the pack's node table, as the reference counts them
    (_pack_boxes): w8 rows x 8 children, binary rows x their node slots."""
    rows = pack["nodes"].shape[0]
    if pack.node_fmt == "w8":
        return rows * 8
    return rows * (tk.SLOTS16 if pack.node_fmt == "bf16" else SLOTS)


def driver_of(pack: MKPack) -> str:
    """The driver auto_trace takes for the pack: "whole_path", "swf" or
    "swf_split"."""
    if pack.has_grid:
        return "swf_split"
    return "swf" if pack_boxes(pack) >= SWF_AUTO_BOXES else "whole_path"


def auto_trace(pack: MKPack, md, o, d, rng, nee_candidates: int = 1):
    """The reference's driver pick (megakernel.py:3684): a pack with a grid
    medium or of SWF_AUTO_BOXES boxes or more takes the sorted-wavefront
    driver with key_mode "pos_dir" (kernel K5; its split form with K6 for
    grid media), a smaller one the whole-path kernel. Per lane the two
    agree on untextured scenes; on textured ones the driver's inline
    texturing and the kernel's deferred texturing agree in the mean only
    (trace_megakernel_swf). A failing build or launch raises: there is no
    fallback to the other driver or to the CPU."""
    if driver_of(pack) == "whole_path":
        return trace_megakernel(pack, md, o, d, rng, nee_candidates=nee_candidates)
    return trace_megakernel_swf(pack, md, o, d, rng, nee_candidates=nee_candidates,
                                key_mode="pos_dir")


def render_pack(pack: MKPack, cam: cam_mod.Camera, md, spp: int, seed,
                nee_candidates: int = 1) -> torch.Tensor:
    """spp-pass render from a prebuilt pack -> (H, W, 3) mean, with the same
    per-(pixel, sample) pcg streams as models/path_tracer.render. A pack of
    SWF_AUTO_BOXES boxes or more traces all spp samples in one driver call
    (more lanes per sort; the image is the same), as in the reference."""
    B = cam.width * cam.height
    perm, inv = tile_swizzle(cam.width, cam.height, pack.device)
    if pack_boxes(pack) >= SWF_AUTO_BOXES and spp > 1:
        lanes = perm.repeat(spp)
        idx = torch.arange(spp, device=pack.device).repeat_interleave(B)
        rng = qmc.make_state("pcg", seed, lanes, idx)
        o, d, rng = cam_mod.generate_rays(cam, lanes, rng)
        acc = auto_trace(pack, md, o, d, rng, nee_candidates).reshape(spp, B, 3).sum(dim=0)
        return (acc[inv] / spp).reshape(cam.height, cam.width, 3)
    acc = torch.zeros((B, 3), device=pack.device)
    for i in range(spp):
        rng = qmc.make_state("pcg", seed, perm, i)
        o, d, rng = cam_mod.generate_rays(cam, perm, rng)
        acc = acc + auto_trace(pack, md, o, d, rng, nee_candidates)
    return (acc[inv] / spp).reshape(cam.height, cam.width, 3)


def render_megakernel(scene: T.Scene, cam: cam_mod.Camera, md, spp: int, seed: int = 0,
                      sampler: str = "pcg") -> torch.Tensor:
    """The reference's convenience entry (megakernel.py:3743): make_pack(scene)
    in the formats of its rule (binary nodes), then render_pack. The pcg
    sampler only, as in the reference."""
    if sampler != "pcg":
        raise ValueError("the fused megakernel takes the pcg sampler, as in the reference")
    return render_pack(make_pack(scene), cam, md, spp, seed)
