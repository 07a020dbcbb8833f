"""Kernel K1: the walk of a chunked, skip-encoded binary BVH forest (port of
cuda_pt_tpu/ops/pallas/traverse_kernel.py).

``traverse_forest`` replaces the TPU kernel ``_kernel`` (:316) as driven by
``traverse_forest`` (:488, pallas_call :561), and ``traverse_pallas``
(:585) its single-chunk wrapper. The scene is cut into spatially coherent
chunks (Morton order of the prim centroids), each with its own skip tree;
a ray walks chunk 0, 1, ... in order and keeps its best hit across them.
Closest hit returns dict(t, prim, hit, b1, b2), any hit dict(occluded).

The host side packs the forest as the reference does, bit for bit: f32
node rows of 8 slots x 16 fields (lo(3) hi(3) skip base count), or bf16
rows of 16 slots x 8 fields whose three box fields hold two bf16 bounds
each (the lower bound, rounded down, in bits 31..16; the upper one,
rounded up, in bits 15..0; the box only grows); prim rows of 8 slots x 16
fields (p0(3) e1(3) e2(3) is_sphere gid). Integer fields are exact floats.

On a CUDA tensor the wrappers launch the CUDA kernel (csrc/traverse.cu,
built by ops/cuda_build.py) or raise; on a CPU tensor they run the plain
version ``traverse_forest_reference``, and only there. Each launch adds
one to ``LAUNCHES["traverse_forest"]``; ops/megakernel.py shares this dict
with its own wrappers, so one reset counts every kernel of the package.
The outputs are plain tensors with no autograd: the TPU kernel defines no
VJP either (models/path_tracer.py).

Two forms, one result per ray:
- per ray (``count_iters=False``): each ray walks its own pointer. It
  stops at a chunk's real node count (``forest.n_nodes``): the reference's
  walk goes on into the chunk's padding nodes, whose inverted empty boxes
  pass its slab test, and steps through them to the end of the rows; they
  hold no prims, so stopping there changes no result.
- packet (``count_iters=True``): a tile of ``tile`` rays walks in lockstep,
  descending where any of its rays hits the box, through the padding too,
  as the reference's packet does; ``tile_iters`` is its node-fetch count
  per tile, summed over the chunks, equal to the reference's. The batch is
  padded to a multiple of the tile as the reference pads it (zero rays,
  t_far 0, or 1e8 without t_far), and the padding lanes take part.
A packet tests a leaf's prims on every ray of the tile, also on rays that
missed the leaf's box; a prim's hit lies inside its box, so the two forms
give the same hits but where rounding puts a hit just outside its box
(none on the rays the tests and chip_smoke.py check).
"""

from __future__ import annotations

import numpy as np
import torch

from ..scene.types import BVHArrays, Geometry, TraversalForest
from . import cuda_build
from . import intersect as isect

TILE = 512  # rays per packet (the reference's 4 sublane rows x 128 lanes)
MAX_TILE = 1024  # threads per block
SLOTS = 8  # nodes / prims per 128-float row
SLOT_F = 16  # f32 fields per slot
SLOTS16 = 16  # bf16 node format: nodes per row
SLOT_F16 = 8  # bf16 node format: f32 fields per slot (3 packed boxes + 3 ints)
NODE_FMTS = ("f32", "bf16")
VMEM_BUDGET_BYTES = 10 * 1024 * 1024
HIT_EPS = isect.HIT_EPS  # the reference kernel's own 1e-4, the same constant
_BIG = 1e30
_BF16_MAX = 3.3895314e38  # largest finite bf16
_FAR = 1e8  # t_far when none is given

LAUNCHES = {"traverse_forest": 0}


def scene_fits_vmem(geom: Geometry, bvh: BVHArrays) -> bool:
    """The reference's rule for a single-chunk walk without a compiled
    forest: nodes and prims at 64 B each under 10 MiB (a TPU VMEM limit; it
    only decides which walk runs, not what it computes)."""
    return (bvh.num_nodes + geom.num_prims) * SLOT_F * 4 < VMEM_BUDGET_BYTES


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pack_rows(cols, pad_vals) -> np.ndarray:
    """Per-item field columns -> (rows, 128) f32: 8 slots of 16 fields per
    row, at least one full group of padding slots filled with pad_vals
    (sentinels that make padding inert), other fields 0."""
    M = cols[0].shape[0]
    Mp = -(-max(M, 1) // SLOTS) * SLOTS + SLOTS
    out = [np.concatenate([np.asarray(c, np.float32), np.full(Mp - M, pv, np.float32)])
           for c, pv in zip(cols, pad_vals)]
    while len(out) < SLOT_F:
        out.append(np.zeros(Mp, np.float32))
    return np.stack(out, axis=1).reshape(Mp // SLOTS, SLOTS * SLOT_F)


def pack_nodes(bvh: BVHArrays) -> np.ndarray:
    """(Rn, 128) f32 node rows; padding nodes have an empty (inverted) box
    and skip past the packed nodes."""
    M = bvh.num_nodes
    Mp = -(-max(M, 1) // SLOTS) * SLOTS + SLOTS
    nmin, nmax = _np(bvh.node_min), _np(bvh.node_max)
    return _pack_rows(
        [nmin[:, 0], nmin[:, 1], nmin[:, 2], nmax[:, 0], nmax[:, 1], nmax[:, 2],
         _np(bvh.node_skip).astype(np.float32), _np(bvh.node_base).astype(np.float32),
         _np(bvh.node_count).astype(np.float32)],
        [_BIG, _BIG, _BIG, -_BIG, -_BIG, -_BIG, float(Mp), 0.0, 0.0])


def pack_prims(geom: Geometry, gid=None) -> np.ndarray:
    """(Rp, 128) f32 prim rows; field 10 is the global prim id (exact below
    2^24). Padding prims are degenerate triangles with gid -1."""
    p0, e1, e2 = _np(geom.p0), _np(geom.e1), _np(geom.e2)
    if gid is None:
        gid = np.arange(p0.shape[0], dtype=np.float32)
    return _pack_rows(
        [p0[:, 0], p0[:, 1], p0[:, 2], e1[:, 0], e1[:, 1], e1[:, 2],
         e2[:, 0], e2[:, 1], e2[:, 2], _np(geom.is_sphere).astype(np.float32),
         np.asarray(gid, np.float32)],
        [0.0] * 9 + [0.0, -1.0])


def _bf16_directed(x, up: bool) -> np.ndarray:
    """f32 -> bf16-representable f32 with directed rounding: up=False gives
    a value <= x (box minima), up=True one >= x (maxima)."""
    x = np.clip(np.asarray(x, np.float32), -_BF16_MAX, _BF16_MAX)
    u = x.view(np.uint32)
    t = u & np.uint32(0xFFFF0000)  # truncation: toward zero for both signs
    tv = t.view(np.float32)
    # on the wrong side, one bf16 ulp away from zero: +1 in the unsigned
    # (sign-magnitude) bit order
    sv = (((t >> 16) + np.uint32(1)) << 16).view(np.float32)
    need_up = up & (tv < x)
    need_dn = (not up) & (tv > x)
    out = np.where(need_up | need_dn, sv, tv)
    return np.clip(out, -_BF16_MAX, _BF16_MAX).astype(np.float32)


def _pack2(hi_f32, lo_f32) -> np.ndarray:
    """Two bf16 payloads in one f32 lane: the first in bits 31..16, the
    second in bits 15..0."""
    h = np.asarray(hi_f32, np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
    l_ = np.asarray(lo_f32, np.float32).view(np.uint32) >> 16
    return (h | l_).view(np.float32)


def pack_nodes_bf16(bvh: BVHArrays) -> np.ndarray:
    """(R, 128) rows of 16 node slots x 8 f32 fields, 32 B per node: fields
    0-2 = lo|hi of x, y, z (lo rounded down in the high bits, hi rounded up
    in the low bits), 3 = skip, 4 = base, 5 = count."""
    nmin, nmax = _np(bvh.node_min), _np(bvh.node_max)
    M = nmin.shape[0]
    Mp = -(-max(M, 1) // SLOTS16) * SLOTS16 + SLOTS16
    lo = _bf16_directed(nmin, up=False)
    hi = _bf16_directed(nmax, up=True)
    cols = [_pack2(lo[:, 0], hi[:, 0]), _pack2(lo[:, 1], hi[:, 1]), _pack2(lo[:, 2], hi[:, 2]),
            _np(bvh.node_skip).astype(np.float32), _np(bvh.node_base).astype(np.float32),
            _np(bvh.node_count).astype(np.float32)]
    pads = [_pack2(_BIG, -_BIG)] * 3 + [float(Mp), 0.0, 0.0]
    out = [np.concatenate([c, np.full(Mp - M, pv, np.float32)]) for c, pv in zip(cols, pads)]
    while len(out) < SLOT_F16:
        out.append(np.zeros(Mp, np.float32))
    return np.stack(out, axis=1).reshape(Mp // SLOTS16, SLOTS16 * SLOT_F16)


def single_chunk_forest(geom: Geometry, bvh: BVHArrays, device=None) -> TraversalForest:
    """The scene's own BVH as a one-chunk forest on device (default: the
    geometry's)."""
    device = geom.p0.device if device is None else device
    return TraversalForest(
        nodes=torch.as_tensor(pack_nodes(bvh)[None], device=device),
        prims=torch.as_tensor(pack_prims(geom)[None], device=device),
        n_nodes=torch.tensor([bvh.num_nodes], dtype=torch.int32, device=device))


def build_forest(geom: Geometry, chunk_prims: int = 65536, max_leaf: int = 4,
                 node_fmt: str = "f32", device=None) -> TraversalForest:
    """Host build of the forest: prims in Morton order of their centroids
    over the scene bounds, cut into chunks of chunk_prims, a skip-encoded
    SAH tree per chunk (accel/bvh_build.py, leaves of at most max_leaf),
    rows packed in node_fmt ("f32" or "bf16") and every chunk padded to the
    same row counts. On device (default: the geometry's)."""
    from ..accel import bvh_build

    if node_fmt not in NODE_FMTS:
        raise ValueError(f"node_fmt must be one of {NODE_FMTS}, got {node_fmt!r}")
    device = geom.p0.device if device is None else device
    p0, e1, e2, sph = _np(geom.p0), _np(geom.e1), _np(geom.e2), _np(geom.is_sphere)
    N = p0.shape[0]
    lo, hi, cent = bvh_build.prim_bounds(p0, e1, e2, sph)

    # spatial order: Morton codes of the centroids over the scene bounds
    smin = lo.min(axis=0)
    ext = np.maximum(hi.max(axis=0) - smin, 1e-8)
    q = np.clip((cent - smin) / ext * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = np.argsort(code, kind="stable")

    node_arrs, prim_arrs, counts = [], [], []
    for i in range(0, N, chunk_prims):
        ids = order[i:i + chunk_prims]
        nodes = bvh_build.build_bvh(lo[ids], hi[ids], cent[ids], max_leaf=max_leaf)
        sub = ids[nodes["order"]]  # chunk-local tree order -> global prim ids
        bvh_c = BVHArrays(node_min=nodes["node_min"], node_max=nodes["node_max"],
                          node_skip=nodes["node_skip"], node_base=nodes["node_base"],
                          node_count=nodes["node_count"])
        node_arrs.append(pack_nodes_bf16(bvh_c) if node_fmt == "bf16" else pack_nodes(bvh_c))
        prim_arrs.append(_pack_rows(
            [p0[sub, 0], p0[sub, 1], p0[sub, 2], e1[sub, 0], e1[sub, 1], e1[sub, 2],
             e2[sub, 0], e2[sub, 1], e2[sub, 2], sph[sub].astype(np.float32),
             sub.astype(np.float32)],
            [0.0] * 9 + [0.0, -1.0]))
        counts.append(nodes["node_min"].shape[0])

    rn = max(a.shape[0] for a in node_arrs)
    rp = max(a.shape[0] for a in prim_arrs)
    if node_fmt == "bf16":
        pad_node_row = np.tile(np.asarray(
            [float(_pack2(_BIG, -_BIG))] * 3 + [float(rn * SLOTS16), 0.0, 0.0]
            + [0.0] * (SLOT_F16 - 6), np.float32), SLOTS16)
    else:
        pad_node_row = np.tile(np.asarray(
            [_BIG, _BIG, _BIG, -_BIG, -_BIG, -_BIG, float(rn * SLOTS), 0.0, 0.0]
            + [0.0] * (SLOT_F - 9), np.float32), SLOTS)
    # padding prims: degenerate with gid -1 (no node references them)
    pad_prim_row = np.tile(np.asarray([0.0] * 10 + [-1.0] + [0.0] * (SLOT_F - 11), np.float32),
                           SLOTS)

    def padto(a, rows, row):
        return np.concatenate([a, np.tile(row[None], (rows - a.shape[0], 1))], axis=0)

    return TraversalForest(
        nodes=torch.as_tensor(np.stack([padto(a, rn, pad_node_row) for a in node_arrs]),
                              device=device),
        prims=torch.as_tensor(np.stack([padto(a, rp, pad_prim_row) for a in prim_arrs]),
                              device=device),
        n_nodes=torch.tensor(counts, dtype=torch.int32, device=device), node_fmt=node_fmt)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _node_fields(forest: TraversalForest) -> torch.Tensor:
    """(C, nodes per chunk row set, 9) f32: lo(3) hi(3) skip base count, the
    bf16 boxes unpacked (exactly: a bf16 is the high half of an f32)."""
    C, rn, _ = forest.nodes.shape
    if forest.node_fmt == "f32":
        return forest.nodes.reshape(C, rn * SLOTS, SLOT_F)[..., :9]
    raw = forest.nodes.reshape(C, rn * SLOTS16, SLOT_F16)
    bits = raw[..., :3].contiguous().view(torch.int32)
    lo = (bits & -65536).view(torch.float32)
    hi = (bits << 16).view(torch.float32)
    return torch.cat([lo, hi, raw[..., 3:6]], dim=-1)


def _safe_inv(v: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(v) < 1e-8, torch.where(v < 0, -1e-8, 1e-8), v)


def _prim_tests(pf: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Rays o, d (..., 3) against prims pf (..., 11), broadcast: the
    reference kernel's Möller-Trumbore with the |a| < 1e-12 guard and its
    sphere test, in its operation order -> (t, ok, b1, b2)."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    ax, ay, az, ux, uy, uz, vx, vy, vz = pf[..., :9].unbind(-1)
    is_sph = pf[..., 9] > 0.0
    hx = dy * vz - dz * vy
    hy = dz * vx - dx * vz
    hz = dx * vy - dy * vx
    a = ux * hx + uy * hy + uz * hz
    f = 1.0 / torch.where(torch.abs(a) < 1e-12, 1e-12, a)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * uz - sz * uy
    qy = sz * ux - sx * uz
    qz = sx * uy - sy * ux
    v = f * (dx * qx + dy * qy + dz * qz)
    t_tri = f * (vx * qx + vy * qy + vz * qz)
    tri_ok = (torch.abs(a) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t_tri > HIT_EPS)
    # sphere: centre p0, radius e1.x
    bh = sx * dx + sy * dy + sz * dz
    cc = sx * sx + sy * sy + sz * sz - ux * ux
    disc = bh * bh - cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0s = -bh - sq
    t1s = -bh + sq
    t_sph = torch.where(t0s > HIT_EPS, t0s, t1s)
    sph_ok = (disc > 0.0) & (t_sph > HIT_EPS)
    t = torch.where(is_sph, t_sph, t_tri)
    ok = torch.where(is_sph, sph_ok, tri_ok)
    return t, ok, torch.where(is_sph, 0.0, u), torch.where(is_sph, 0.0, v)


def _pad_packets(o, d, t_far, tile: int):
    """The batch padded to a multiple of tile as the reference pads it:
    zero rays; t_far 0 on padding (1e8 everywhere without t_far)."""
    B = o.shape[0]
    pad = (-B) % tile
    o = torch.cat([o, o.new_zeros((pad, 3))])
    d = torch.cat([d, d.new_zeros((pad, 3))])
    if t_far is None:
        t_far = torch.full((B + pad,), _FAR, dtype=o.dtype, device=o.device)
    else:
        t_far = torch.cat([t_far, t_far.new_zeros(pad)])
    return o, d, t_far


def traverse_forest_reference(forest: TraversalForest, o: torch.Tensor, d: torch.Tensor,
                              t_far=None, max_leaf: int = 4, occlusion: bool = False,
                              count_iters: bool = False, tile: int = TILE) -> dict:
    """Plain PyTorch version of K1, the arithmetic of the reference kernel:
    safe_inv, the slab test (tn <= tf) & (tf > HIT_EPS) & (tn < t_best), the
    prim tests of _prim_tests, strict t < t_best in slot order inside a
    leaf (k < count and k < max_leaf), chunks in order; any hit starts from
    t_far * (1 - 1e-3) and a ray stops at its first occluder. count_iters
    walks packets of tile rays (module docstring) and adds tile_iters."""
    B = o.shape[0]
    if count_iters:
        o, d, t_far = _pad_packets(o, d, t_far, tile)
    else:
        tile = 1
        if t_far is None:
            t_far = torch.full((B,), _FAR, dtype=o.dtype, device=o.device)
    n = o.shape[0]
    P = n // tile
    dev = o.device
    nodes = _node_fields(forest)
    C = nodes.shape[0]
    prims = forest.prims.reshape(C, -1, SLOT_F)[..., :11]
    stops = [nodes.shape[1]] * C if count_iters else forest.n_nodes.tolist()
    inv = _safe_inv(d)
    t_best = t_far * (1.0 - isect.SHADOW_T_SCALE) if occlusion else torch.full((n,), torch.inf, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    b1 = torch.zeros(n, device=dev)
    b2 = torch.zeros(n, device=dev)
    iters = torch.zeros(P, dtype=torch.int64, device=dev)
    lane = torch.arange(tile, device=dev)
    ks = torch.arange(max_leaf, device=dev)
    for c in range(C):
        nd, pr = nodes[c], prims[c]
        ptr = torch.zeros(P, dtype=torch.int64, device=dev)
        act = torch.arange(P, device=dev)  # packets still walking this chunk
        while True:
            keep = ptr[act] < stops[c]
            if occlusion:
                keep &= (prim.view(P, tile)[act] < 0).any(dim=1)
            act = act[keep]
            if act.numel() == 0:
                break
            pc = ptr[act]
            node = nd[pc]
            lanes = (act[:, None] * tile + lane).reshape(-1)
            A = act.numel()
            o_l, inv_l = o[lanes].view(A, tile, 3), inv[lanes].view(A, tile, 3)
            t0 = (node[:, None, 0:3] - o_l) * inv_l
            t1 = (node[:, None, 3:6] - o_l) * inv_l
            tn = torch.amax(torch.minimum(t0, t1), dim=-1)
            tf = torch.amin(torch.maximum(t0, t1), dim=-1)
            live = prim[lanes].view(A, tile) < 0 if occlusion else torch.ones_like(tn, dtype=bool)
            box = (tn <= tf) & (tf > HIT_EPS) & (tn < t_best[lanes].view(A, tile)) & live
            any_hit = box.any(dim=1)
            cnt = node[:, 8].long()
            is_leaf = cnt > 0
            do = any_hit & is_leaf
            if bool(do.any()):
                qi = torch.nonzero(do)[:, 0]
                lq = lanes.view(A, tile)[qi].reshape(-1)
                Q = qi.numel()
                pid = torch.clamp(node[qi, 7].long()[:, None] + ks, max=pr.shape[0] - 1)
                pf = pr[pid][:, None]  # (Q, 1, K, 11)
                t_k, ok, u_k, v_k = _prim_tests(pf, o[lq].view(Q, tile, 1, 3),
                                                d[lq].view(Q, tile, 1, 3))
                ok = ok & (ks < cnt[qi][:, None])[:, None, :] & live[qi][..., None]
                # the sequential strict update: the first of the smallest
                t_c = torch.where(ok, t_k, torch.inf)
                k = torch.argmin(t_c, dim=-1, keepdim=True)
                t_new = torch.gather(t_c, 2, k)[..., 0].reshape(-1)
                better = t_new < t_best[lq]
                t_best[lq] = torch.where(better, t_new, t_best[lq])
                gid = torch.gather(pf[..., 10].expand(-1, tile, -1), 2, k)[..., 0].reshape(-1)
                prim[lq] = torch.where(better, gid.long(), prim[lq])
                b1[lq] = torch.where(better, torch.gather(u_k, 2, k)[..., 0].reshape(-1), b1[lq])
                b2[lq] = torch.where(better, torch.gather(v_k, 2, k)[..., 0].reshape(-1), b2[lq])
            ptr[act] = torch.where(any_hit & ~is_leaf, pc + 1, node[:, 6].long())
            iters[act] += 1
    res = _result(t_best[:B], prim[:B], b1[:B], b2[:B], occlusion)
    if count_iters:
        res["tile_iters"] = iters.to(torch.int32)
    return res


def _result(t, prim, b1, b2, occlusion: bool) -> dict:
    if occlusion:
        return {"occluded": prim >= 0}
    return {"t": t, "prim": prim, "hit": prim >= 0, "b1": b1, "b2": b2}


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def traverse_forest(forest: TraversalForest, o: torch.Tensor, d: torch.Tensor, t_far=None,
                    max_leaf: int = 4, occlusion: bool = False, count_iters: bool = False,
                    tile: int | None = None, stats: torch.Tensor | None = None) -> dict:
    """Walk of the forest by (B, 3) rays: dict(t, prim (int64, -1 = miss),
    hit, b1, b2) for the closest hit, dict(occluded) for any hit before
    t_far * (1 - 1e-3) (t_far (B,), default 1e8). count_iters runs the
    packet form (tile rays per block, default TILE, a multiple of 128 up to
    MAX_TILE) and adds "tile_iters" (int32, one per tile). stats (CUDA,
    per-ray form): an int32 (B, 2) tensor the kernel adds each ray's node
    fetches and prim tests to. CPU tensors run traverse_forest_reference;
    CUDA tensors launch the kernel."""
    tile = TILE if tile is None else int(tile)
    if tile % 128 or not 0 < tile <= MAX_TILE:
        raise ValueError(f"tile must be a multiple of 128 up to {MAX_TILE}, got {tile}")
    if forest.node_fmt not in NODE_FMTS:
        raise ValueError(f"unknown node format {forest.node_fmt!r}")
    if o.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats counts kernel work; it needs CUDA tensors")
        return traverse_forest_reference(forest, o, d, t_far, max_leaf, occlusion, count_iters,
                                         tile)
    if o.device.type != "cuda":
        raise ValueError(f"rays must be CPU or CUDA tensors, got {o.device}")
    if o.dtype != torch.float32 or d.dtype != torch.float32 or o.shape != d.shape \
            or o.dim() != 2 or o.shape[1] != 3:
        raise ValueError("expected o, d (B, 3) float32")
    if t_far is not None and (t_far.dtype != torch.float32 or t_far.shape != o.shape[:1]):
        raise ValueError("expected t_far (B,) float32")
    if count_iters and stats is not None:
        raise ValueError("stats are counted by the per-ray form; count_iters takes the packet form")
    B = o.shape[0]
    if stats is not None and (stats.dtype != torch.int32 or tuple(stats.shape) != (B, 2)
                              or not stats.is_contiguous()):
        raise ValueError("expected stats (B, 2) int32, contiguous")
    if count_iters:
        o, d, t_far = _pad_packets(o, d, t_far, tile)
    nodes, prims, n_nodes, o, d = (x.contiguous() for x in (forest.nodes, forest.prims,
                                                            forest.n_nodes, o, d))
    t_far = t_far.contiguous() if t_far is not None else None
    for x in (nodes, prims, n_nodes, o, d, t_far, stats):
        if x is not None and (x.device != o.device or x.data_ptr() % 16):
            raise ValueError("kernel inputs must lie on one device, 16-byte aligned")
    n = o.shape[0]
    C, rn, rp = nodes.shape[0], nodes.shape[1], prims.shape[1]
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    t = b1 = b2 = None
    if not occlusion:
        t, b1, b2 = (torch.empty(n, dtype=torch.float32, device=o.device) for _ in range(3))
    iters = torch.empty(n // tile, dtype=torch.int32, device=o.device) if count_iters else None

    def ptr(x):
        return None if x is None else x.data_ptr()

    if n > 0:
        rc = cuda_build.load().k1_traverse(
            nodes.data_ptr(), prims.data_ptr(), n_nodes.data_ptr(), C, rn, rp, o.data_ptr(),
            d.data_ptr(), ptr(t_far), n, int(max_leaf), int(occlusion),
            int(forest.node_fmt == "bf16"), tile if count_iters else 0, ptr(t), prim.data_ptr(),
            ptr(b1), ptr(b2), ptr(iters), ptr(stats),
            torch.cuda.current_stream(o.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"k1_traverse launch failed: cudaError {rc}")
        LAUNCHES["traverse_forest"] += 1
    prim = prim[:B].long()
    res = _result(t[:B] if t is not None else None, prim, b1[:B] if b1 is not None else None,
                  b2[:B] if b2 is not None else None, occlusion)
    if count_iters:
        res["tile_iters"] = iters
    return res


def traverse_pallas(geom: Geometry, bvh: BVHArrays, o: torch.Tensor, d: torch.Tensor,
                    t_far=None, max_leaf: int = 4, occlusion: bool = False,
                    count_iters: bool = False) -> dict:
    """traverse_forest of the scene's own BVH as one chunk (the reference's
    single-chunk wrapper; the reference asks scene_fits_vmem of it)."""
    return traverse_forest(single_chunk_forest(geom, bvh, o.device), o, d, t_far,
                           max_leaf=max_leaf, occlusion=occlusion, count_iters=count_iters)
