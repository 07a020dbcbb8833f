"""Fused whole-path megakernel: scene pack, envelope check, kernel wrappers
(port of cuda_pt_tpu/ops/pallas/megakernel.py for the whole-path mode).

``trace_megakernel`` replaces the TPU kernel ``_kernel`` (megakernel.py:500)
as driven by ``trace_megakernel`` (:2963, pallas_call :3083), for scenes
with the Lambertian / Specular / Translucent families, area and point
emitters, w8 nodes and f32 attrs and prims. The CUDA source is
csrc/megakernel.cu; it is built with nvcc at first use (ops/cuda_build.py).

Every wrapper here takes the plain PyTorch version for CPU tensors and
only for them; for CUDA tensors it launches its kernel or raises. Each
launch adds one to ``LAUNCHES[name]``.

Kernels:
- ``trace_megakernel``: the whole path per ray -> L (B, 3). Plain version
  ``trace_megakernel_reference`` (models/path_tracer.trace_paths, brute
  force intersection).
- ``closest_hit_w8``: the same device walk alone -> (t, prim, b1, b2).
  Plain version ``ops/intersect.closest_hit_brute``. It exists so a walk
  bug shows as wrong prim ids, not as a noisy image.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..accel import wide_build
from ..bsdf.eval import PORTED_BSDFS
from ..core import camera as cam_mod
from ..core import qmc
from ..emitters.emitters import PORTED_EMITTERS
from ..models import path_tracer as pt
from ..scene import types as T
from . import cuda_build
from . import intersect as isect

SLOTS = 8  # slots per 128-float row
SLOT_F = 16  # f32 fields per slot
# The TPU kernel's VMEM limits, kept as megakernel_ok's semantics. The card
# needs none of them (it reads the pack from device memory); see ROADMAP.md.
MAX_EMITTERS = 8  # slots in the emitter row (slot 0 = null); passed to nvcc
MAX_EMITTER_PRIMS = 56
MAX_BSDFS = 32
FUSED_VMEM_BUDGET_BYTES = 12 * 1024 * 1024
AUTO_COMPACT_BYTES = 2 * 1024 * 1024
TILE = 8192
# Leaf stack entries pack cnt into 4 bits (csrc/walk.cuh).
MK_MAX_LEAF = 15

LAUNCHES = {"trace_megakernel": 0, "closest_hit_w8": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# envelope
# ---------------------------------------------------------------------------


def fused_pack_bytes(scene: T.Scene, node_fmt: str = "f32", attr_fmt: str = "f32",
                     prim_fmt: str = "f32") -> int:
    """Resident bytes of the TPU pack in the given formats (megakernel.py:86)."""
    n = int(scene.bvh.num_nodes)
    p = int(scene.geom.num_prims)
    nb = int(scene.bsdfs.btype.shape[0])
    node_b = 32 if node_fmt == "bf16" else 64
    prim_b = (512 // 14 + 1) if prim_fmt == "t9" else 64
    attr_b = 32 if attr_fmt == "bf16" else 64
    small = (2 * nb + SLOTS + MAX_EMITTER_PRIMS) * SLOT_F * 4
    return n * node_b + p * prim_b + p * attr_b + small


def resident_pack_bytes(scene: T.Scene) -> int:
    if fused_pack_bytes(scene) > AUTO_COMPACT_BYTES:
        tri = not bool(scene.geom.is_sphere.any())
        return fused_pack_bytes(scene, node_fmt="bf16", attr_fmt="bf16",
                                prim_fmt="t9" if tri else "f32")
    return fused_pack_bytes(scene)


def _tile_state_bytes() -> int:
    return 11 * TILE * 4 * 2


def _real_k(cdf_row, sel_row) -> int:
    """Real prim entries of a (K,) emitter cdf row (padding repeats the
    last prim with cdf 1.0)."""
    k = cdf_row.shape[0]
    while k > 1 and cdf_row[k - 2] >= 1.0 and sel_row[k - 1] == sel_row[k - 2]:
        k -= 1
    return k


def megakernel_ok(scene: T.Scene, md=None) -> bool:
    """Host-side envelope check of the ported kernel: the TPU kernel's
    size limits (megakernel.py:131), narrowed to the ported BSDF families
    and emitter types, no textures, no media, no ToF. The reference's
    strict=True cap (its auto-pick's TPU-fault gate) has no counterpart:
    the port's Renderer always takes the kernel, like an explicit
    traversal='fused' there."""
    if resident_pack_bytes(scene) + _tile_state_bytes() > FUSED_VMEM_BUDGET_BYTES:
        return False
    if set(scene.present_bsdfs) - set(PORTED_BSDFS):
        return False
    if int(scene.bsdfs.btype.shape[0]) > MAX_BSDFS:
        return False
    et = scene.emitters.etype.cpu().numpy()
    if et.shape[0] > MAX_EMITTERS or set(int(x) for x in et) - set(PORTED_EMITTERS):
        return False
    if scene.env_emitter > 0 or int(scene.emitters.tex_id.max()) >= 0:
        return False
    if int(scene.bsdfs.tex_ids.max()) >= 0:
        return False
    if int(scene.objects.medium_in.max()) >= 0 or scene.cam_medium >= 0:
        return False
    if md is not None and md.max_time > 0.0:
        return False
    if int(scene.bvh.max_leaf) > MK_MAX_LEAF:
        return False
    cdf = scene.emitters.prim_cdf.cpu().numpy()
    sel = scene.emitters.prim_sel.cpu().numpy()
    sph = scene.geom.is_sphere.cpu().numpy()
    n_eprims = 0
    for e in range(et.shape[0]):
        if et[e] == T.EMITTER_AREA:
            k = _real_k(cdf[e], sel[e])
            n_eprims += k
            if sph[sel[e, :k]].any():
                return False  # sphere emitter prims stay outside the envelope
    return n_eprims <= MAX_EMITTER_PRIMS


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
    With an envmap the pmf is renormalized over the geometric emitters
    (the TPU pack's rule, megakernel.py:364)."""
    e = scene.emitters
    E = int(e.etype.shape[0])
    if E > MAX_EMITTERS:
        raise ValueError(f"{E} emitter slots > MAX_EMITTERS={MAX_EMITTERS}")
    em = _np(e.emission) * _np(e.scaler)[:, None]
    cdfs, sels = _np(e.prim_cdf), _np(e.prim_sel)
    kmax = np.array([max(_real_k(cdfs[i], sels[i]) - 1, 0) for i in range(E)], np.float32)
    et_np = _np(e.etype)
    pmf = _np(e.sel_pmf).astype(np.float32).copy()
    cdf = _np(e.sel_cdf).astype(np.float32)
    env_mask = et_np == T.EMITTER_ENVMAP
    if env_mask.any():
        pmf[env_mask] = 0.0
        pmf = pmf / max(float(pmf.sum()), 1e-12)
        cdf = np.cumsum(pmf).astype(np.float32)
        if cdf[-1] > 0:
            cdf /= cdf[-1]
        else:
            cdf[:] = 1.0
    et_k = np.where(env_mask, T.EMITTER_NULL, et_np)
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

    def __getitem__(self, k):
        return self.arrays[k]

    @property
    def device(self) -> torch.device:
        return self.arrays["nodes"].device


PACK_KEYS = ("nodes", "prims", "attrs", "erow", "eprims", "brows")


def make_pack(scene: T.Scene, node_fmt: str = "w8", attr_fmt: str | None = None,
              prim_fmt: str | None = None) -> MKPack:
    """Host-side scene pack on the scene's device. Only the w8 node format
    with f32 attrs and prims is ported."""
    if node_fmt != "w8" or attr_fmt not in (None, "f32") or prim_fmt not in (None, "f32"):
        raise NotImplementedError(
            "only node_fmt='w8' with f32 attrs and prims is ported (ROADMAP Queue 2, K1/K3)")
    wb = wide_build.from_bvharrays(scene.bvh)
    max_stack = int(wb.max_stack) + 8  # the TPU walk's unconditional 8-slot write
    if max_stack > cuda_build.MK_MAX_STACK:
        raise ValueError(
            f"scene needs a traversal stack of {max_stack} > {cuda_build.MK_MAX_STACK}")
    if int(scene.bvh.max_leaf) > MK_MAX_LEAF:
        raise ValueError(f"max_leaf {scene.bvh.max_leaf} > {MK_MAX_LEAF}")
    host = {
        "nodes": pack_nodes_w8(wb),
        "prims": pack_prims(scene.geom),
        "attrs": pack_attrs(scene),
        "erow": pack_emitters(scene),
        "eprims": pack_emitter_prims(scene),
        "brows": pack_bsdfs(scene),
    }
    arrays = {k: torch.as_tensor(v, device=scene.device).contiguous() for k, v in host.items()}
    return MKPack(arrays, scene, tri_only=not bool(scene.geom.is_sphere.any()),
                  max_leaf=int(scene.bvh.max_leaf), max_stack=max_stack)


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


def _ptr(x: torch.Tensor):
    return x.data_ptr()


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


def trace_megakernel_reference(scene: T.Scene, md, o, d, rng, nee_candidates: int = 1):
    """Plain PyTorch version of the kernel: the composed path tracer."""
    return pt.trace_paths(scene, md, o, d, rng, nee_candidates)


def trace_megakernel(pack: MKPack, md, o: torch.Tensor, d: torch.Tensor, rng: torch.Tensor,
                     nee_candidates: int = 1, count_stats: bool = False):
    """(B, 3) rays + (B, 2) pcg states -> L (B, 3). CPU tensors run the plain
    version; CUDA tensors launch the kernel. count_stats (CUDA only) also
    returns per-ray (B, 2) int32 [wide nodes expanded, prim tests]."""
    if o.device.type == "cpu":
        if count_stats:
            raise ValueError("count_stats counts kernel work; it needs CUDA tensors")
        return trace_megakernel_reference(pack.scene, md, o, d, rng, nee_candidates)
    if o.dtype != torch.float32 or d.dtype != torch.float32 or o.shape != d.shape \
            or o.dim() != 2 or o.shape[1] != 3 or tuple(rng.shape) != (o.shape[0], 2):
        raise ValueError("expected o, d (B, 3) float32 and rng (B, 2)")
    rng32 = rng_bits(rng)
    _check_rays(pack, o, d, rng32)
    lib = cuda_build.load()
    B = o.shape[0]
    L = torch.empty_like(o)
    stats = torch.zeros((B, 2), dtype=torch.int32, device=o.device) if count_stats else None
    rc = lib.mk_trace(*[_ptr(pack[k]) for k in PACK_KEYS], _ptr(o), _ptr(d), _ptr(rng32),
                      _ptr(L), _ptr(stats) if stats is not None else None,
                      B, pack.max_leaf, int(pack.tri_only),
                      int(md.max_depth), int(md.max_diffuse), int(md.max_specular),
                      int(md.max_transmit), int(nee_candidates),
                      torch.cuda.current_stream(o.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mk_trace launch failed: cudaError {rc}")
    LAUNCHES["trace_megakernel"] += 1
    return (L, stats) if count_stats else L


def closest_hit_w8(pack: MKPack, o: torch.Tensor, d: torch.Tensor):
    """Closest hit of (B, 3) rays -> (t, prim (int64, -1 = miss), b1, b2).
    CPU tensors run closest_hit_brute; CUDA tensors launch the w8 walk."""
    if o.device.type == "cpu":
        h = isect.closest_hit_brute(pack.scene.geom, o, d)
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
    rc = lib.mk_closest_hit(*[_ptr(pack[k]) for k in PACK_KEYS], _ptr(o), _ptr(d), _ptr(t),
                            _ptr(prim), _ptr(b1), _ptr(b2), B, pack.max_leaf, int(pack.tri_only),
                            torch.cuda.current_stream(o.device).cuda_stream)
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
