"""The plain reference of a cell: the radiance of chosen (pixel, sample)
paths, worked out again from the cell's configuration and seed, on the
frozen plain estimator of ptref/.

It follows the program's sorted-wavefront estimator lane by lane, as the
program's own plain driver does: the camera ray and pcg stream of (pixel,
sample), then per bounce one segment step (ptref's pt_bounce / vpt_bounce
in the segment form of kernel K5) on the live lanes, the recorded texels resolved
between bounces, and the recorded envmap misses added at the end. The
driver's re-sort of the lanes changes no lane's result, so the live lanes
are stepped in place. Nothing here imports the program: the scene, its
tables, the emitter pick, the bf16 normals and the rays are made again.

precision="bf16" is the control: the same paths with the float state
planes rounded to bfloat16 after every bounce, as a state carried in
bfloat16 would be. It has to fail the comparison (benchmark/PERF.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ptref.core import camera as cam_mod
from .ptref.core import qmc
from .ptref.core import rng as prng
from .ptref.core.config import MaxDepthParams
from .ptref.emitters import emitters
from .ptref.models import path_tracer as pt
from .ptref.models import volume_pt
from .ptref.scene import testscenes
from .ptref.scene import textures as tex
from .ptref.scene import types as T

# the state planes (the program's segment layout): pcg bits 0-1, origin,
# direction, throughput, radiance, active, previous pdf, previous delta,
# lobe counts, wavelength; then the envmap miss record, the medium stack
# and the texture record where the scene has them
S_O, S_D, S_THP, S_L, S_ACT = 2, 5, 8, 11, 14
S_PPDF, S_PDELTA, S_NDIFF, S_WL, S_ENV = 15, 16, 17, 20, 21
PRECISIONS = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class Layout:
    n_state: int
    env: int  # miss direction (3), miss throughput (3); -1 without an envmap
    med: int  # medium stack (3), top, volume count; -1 without media
    tex: int  # NEE contribution (3), bsdf id, u, v; -1 without textures


def layout(has_env: bool, has_media: bool, textured: bool) -> Layout:
    med = S_ENV + (6 if has_env else 0)
    rec = med + (5 if has_media else 0)
    n = rec + (6 if textured else 0)
    return Layout(n, S_ENV if has_env else -1, med if has_media else -1,
                  rec if textured else -1)


@dataclasses.dataclass
class RefScene:
    """The scene as the segment estimator sees it, and its flags."""

    scene: T.Scene
    camera: cam_mod.Camera
    md: MaxDepthParams
    lay: Layout
    tdiff: torch.Tensor


def _bf16_truncated(x: torch.Tensor) -> torch.Tensor:
    """f32 values cut to their high 16 bits: a bf16 field as the packed
    attrs store it (truncated, not rounded)."""
    return (x.contiguous().view(torch.int32) & -65536).view(torch.float32)


def _kernel_emitters(scene: T.Scene) -> T.Scene:
    """The estimator's emitter pick: an envmap's slot becomes a null
    emitter and the pick is renormalized over the geometric emitters (the
    envmap is never NEE-sampled; ptref builds no importance tables)."""
    if scene.env_emitter <= 0:
        return scene
    e = scene.emitters
    et = e.etype.cpu().numpy()
    pmf = e.sel_pmf.cpu().numpy().astype(np.float32).copy()
    cdf = e.sel_cdf.cpu().numpy().astype(np.float32)
    env_mask = et == T.EMITTER_ENVMAP
    if env_mask.any():
        pmf[env_mask] = 0.0
        pmf = pmf / max(float(pmf.sum()), 1e-12)
        cdf = np.cumsum(pmf).astype(np.float32)
        if cdf[-1] > 0:
            cdf /= cdf[-1]
        else:
            cdf[:] = 1.0
    et = np.where(env_mask, T.EMITTER_NULL, et).astype(np.int32)
    dev = scene.device
    em = dataclasses.replace(e, etype=torch.as_tensor(et, device=dev),
                             sel_pmf=torch.as_tensor(pmf, device=dev),
                             sel_cdf=torch.as_tensor(cdf, device=dev))
    return dataclasses.replace(scene, emitters=em)


GEOM_FIELDS = ("p0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "obj_idx", "is_sphere")
EMITTER_FIELDS = ("etype", "obj_id", "prim_sel", "prim_cdf", "sel_pmf", "sel_cdf")


def _rows(geom: dict) -> np.ndarray:
    """One byte string per prim of every per-prim field."""
    cols = [np.ascontiguousarray(np.asarray(geom[k]).reshape(len(geom["p0"]), -1))
            .view(np.uint8) for k in GEOM_FIELDS]
    rows = np.ascontiguousarray(np.concatenate(cols, axis=1))
    return rows.view(np.dtype((np.void, rows.shape[1])))[:, 0]


def match_order(ref_geom: dict, prog_geom: dict) -> np.ndarray:
    """The order (new -> old) that puts ref_geom's prims (in the order the
    generator adds them) where prog_geom has them, matching whole prims
    (positions, normals, uvs, object): the one thing the reference takes
    from the program. check_tables then holds every table of the program
    to the reference's own under it."""
    kr, kp = _rows(ref_geom), _rows(prog_geom)
    if kr.shape != kp.shape:
        raise ValueError(f"the program has {kp.shape[0]} prims, the reference {kr.shape[0]}")
    _, inv = np.unique(np.concatenate([kr, kp]), return_inverse=True)
    ir, ip = inv[:kr.shape[0]], inv[kr.shape[0]:]
    sr, sp = np.argsort(ir, kind="stable"), np.argsort(ip, kind="stable")
    if not np.array_equal(ir[sr], ip[sp]):
        raise ValueError("the program's prims are not the reference's prims")
    order = np.empty(kr.shape[0], np.int64)
    order[sp] = sr
    return order


def scene_tables(scene) -> dict:
    """The per-prim and emitter tables of a compiled scene as NumPy."""
    out = {f"geom.{k}": getattr(scene.geom, k).detach().cpu().numpy() for k in GEOM_FIELDS}
    out.update({f"emitters.{k}": getattr(scene.emitters, k).detach().cpu().numpy()
                for k in EMITTER_FIELDS})
    return out


def check_tables(ref: dict, prog: dict) -> int:
    """The tables of the program's scene that differ from the reference's,
    bit for bit (0 where the program's scene compile is sound)."""
    return sum(1 for k, v in ref.items()
               if k not in prog or v.shape != prog[k].shape or v.dtype != prog[k].dtype
               or not np.array_equal(v.view(np.uint8), prog[k].view(np.uint8)))


def make_scene(cfg: dict, width: int, height: int, device,
               prog_tables: dict | None = None) -> tuple:
    """(RefScene, number of the program's tables that differ from the
    reference's): the configuration's scene at width x height from ptref's
    frozen scene generators, its prims in the program's order where
    prog_tables (scene_tables of the program's scene) is given.
    cfg["scene"] names the generator, cfg["scene_args"] its arguments,
    cfg["renderer"] "pt" or "vpt", cfg["md"] the depth caps, cfg["attr_fmt"]
    "bf16" where the configuration states shading normals truncated to
    bf16."""
    fn = getattr(testscenes, cfg["scene"])
    scene, cam, builder = fn(width, height, device=device, **cfg.get("scene_args", {}))
    if bool((scene.media.mtype == T.MEDIUM_GRID).any()):
        raise NotImplementedError("the reference renders no grid medium")
    cut = {T.BSDF_OREN_NAYAR, T.BSDF_GGX_DIELECTRIC} & set(scene.present_bsdfs)
    if cut:
        raise NotImplementedError(f"the reference renders no BSDF of types {sorted(cut)}")
    off = 0
    if prog_tables is not None:
        ref_geom = {k: getattr(scene.geom, k).cpu().numpy() for k in GEOM_FIELDS}
        prog_geom = {k: prog_tables[f"geom.{k}"] for k in GEOM_FIELDS}
        scene = builder.compile(device=device, order=match_order(ref_geom, prog_geom))
        off = check_tables(scene_tables(scene), prog_tables)
    scene = _kernel_emitters(scene)
    if cfg.get("attr_fmt", "f32") == "bf16":
        g = scene.geom
        geom = dataclasses.replace(g, n0=_bf16_truncated(g.n0), n1=_bf16_truncated(g.n1),
                                   n2=_bf16_truncated(g.n2))
        scene = dataclasses.replace(scene, geom=geom)
    has_media = cfg["renderer"] == "vpt" and (int(scene.objects.medium_in.max()) >= 0
                                              or scene.cam_medium >= 0)
    tdiff = scene.bsdfs.tex_ids[:, T.TEX_DIFFUSE].to(torch.int32)
    textured = bool((tdiff >= 0).any())
    lay = layout(scene.env_emitter > 0, has_media, textured)
    return RefScene(scene, cam, MaxDepthParams(**cfg.get("md", {})), lay, tdiff), off


def _vec(f: torch.Tensor, k: int) -> torch.Tensor:
    return f[k:k + 3].T.contiguous()


def _bits(rng: torch.Tensor) -> torch.Tensor:
    """(B, 2) u32-in-int64 pcg states -> the same bits as int32."""
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32)


def _init(rs: RefScene, o, d, rng) -> torch.Tensor:
    lay = rs.lay
    f = torch.zeros((lay.n_state, o.shape[0]), dtype=torch.float32, device=o.device)
    f[S_O:S_O + 3] = o.T
    f[S_D:S_D + 3] = d.T
    f[S_THP:S_THP + 3] = 1.0
    f[S_ACT] = 1.0
    f[S_PPDF] = 1.0
    f[S_PDELTA] = 1.0
    if lay.env >= 0:
        f[lay.env + 2] = 1.0  # the unused miss direction (0, 0, 1)
    if lay.med >= 0:
        f[lay.med:lay.med + 4] = -1.0
    if lay.tex >= 0:
        f[lay.tex + 3] = -1.0
    st = f.view(torch.int32)
    st[0:2] = _bits(rng).T
    return st


def _state(rs: RefScene, st: torch.Tensor, bounce: int):
    """The planes as the segment step's path state."""
    lay = rs.lay
    f = st.view(torch.float32)
    common = dict(
        o=_vec(f, S_O), d=_vec(f, S_D), thp=_vec(f, S_THP), L=_vec(f, S_L),
        rng=(st[0:2].T.to(torch.int64) & prng.MASK32).contiguous(),
        active=f[S_ACT] > 0.5, prev_pdf=f[S_PPDF].clone(), prev_delta=f[S_PDELTA] > 0.5,
        n_diff=f[S_NDIFF].to(torch.int32), n_spec=f[S_NDIFF + 1].to(torch.int32),
        n_trans=f[S_NDIFF + 2].to(torch.int32), wl=f[S_WL].clone(), bounce=bounce)
    rec = None
    if lay.env >= 0:
        rec = {"miss_d": _vec(f, lay.env), "miss_thp": _vec(f, lay.env + 3)}
    if lay.med < 0:
        return pt.PTState(**common, rec=rec)
    return volume_pt.VPTState(
        **common, n_vol=f[lay.med + 4].to(torch.int32),
        med_stack=f[lay.med:lay.med + 3].T.to(torch.int32).contiguous(),
        med_top=f[lay.med + 3].to(torch.int32), rec=rec)


def _store(rs: RefScene, st: torch.Tensor, s):
    lay = rs.lay
    f = st.view(torch.float32)
    st[0:2] = _bits(s.rng).T
    for k, v in ((S_O, s.o), (S_D, s.d), (S_THP, s.thp), (S_L, s.L)):
        f[k:k + 3] = v.T
    f[S_ACT] = s.active.float()
    f[S_PPDF] = s.prev_pdf
    f[S_PDELTA] = s.prev_delta.float()
    for k, v in enumerate((s.n_diff, s.n_spec, s.n_trans)):
        f[S_NDIFF + k] = v.float()
    f[S_WL] = s.wl
    rec = s.rec or {}
    if lay.env >= 0:
        f[lay.env:lay.env + 3] = rec["miss_d"].T
        f[lay.env + 3:lay.env + 6] = rec["miss_thp"].T
    if lay.med >= 0:
        f[lay.med:lay.med + 3] = s.med_stack.T.float()
        f[lay.med + 3] = s.med_top.float()
        f[lay.med + 4] = s.n_vol.float()
    if lay.tex >= 0:
        f[lay.tex:lay.tex + 3] = rec["nee"].T
        f[lay.tex + 3] = rec["bid"].float()
        f[lay.tex + 4:lay.tex + 6] = rec["uv"].T


def _step(rs: RefScene, st: torch.Tensor, bounce: int):
    """One segment bounce of every lane of st, in place."""
    s = _state(rs, st, bounce)
    if rs.lay.med >= 0:
        s = volume_pt.vpt_bounce(rs.scene, rs.md, s)
    else:
        s = pt.pt_bounce(rs.scene, rs.md, s)
    _store(rs, st, s)


def _resolve_texels(rs: RefScene, st: torch.Tensor):
    """The diffuse texel of each lane's recorded hit multiplies its
    recorded NEE contribution, added to L, and its throughput."""
    lay = rs.lay
    if lay.tex < 0:
        return
    f = st.view(torch.float32)
    bidq = f[lay.tex + 3]
    bid = torch.clamp(bidq.to(torch.int32), 0, rs.tdiff.shape[0] - 1).long()
    tid = torch.where(bidq >= 0.0, rs.tdiff[bid], -1)
    m = tex.sample_texture(rs.scene.textures, tid, _vec(f, lay.tex + 4)[:, :2])[:, :3]
    m = torch.where((tid >= 0)[:, None], m, 1.0).T
    f[S_L:S_L + 3] += f[lay.tex:lay.tex + 3] * m
    f[S_THP:S_THP + 3] *= m


def _round_bf16(rs: RefScene, st: torch.Tensor):
    """The control: the float planes of the path (origin, direction,
    throughput, radiance, pdf, wavelength, the records) rounded to bf16."""
    f = st.view(torch.float32)
    lay = rs.lay
    rows = list(range(S_O, S_L + 3)) + [S_PPDF, S_WL]
    if lay.env >= 0:
        rows += list(range(lay.env, lay.env + 6))
    if lay.tex >= 0:
        rows += [lay.tex, lay.tex + 1, lay.tex + 2, lay.tex + 4, lay.tex + 5]
    idx = torch.tensor(rows, device=st.device)
    f[idx] = f[idx].to(torch.bfloat16).to(torch.float32)


def trace(rs: RefScene, o, d, rng, precision: str = "f32") -> torch.Tensor:
    """Radiance (B, 3) of rays (B, 3) with pcg states (B, 2)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    st = _init(rs, o, d, rng)
    for bounce in range(rs.md.max_depth):
        live = torch.nonzero(st.view(torch.float32)[S_ACT] > 0.5)[:, 0]
        if live.numel() == 0:
            break
        sub = st[:, live].contiguous()
        _step(rs, sub, bounce)
        _resolve_texels(rs, sub)
        if precision == "bf16":
            _round_bf16(rs, sub)
        st[:, live] = sub
    f = st.view(torch.float32)
    L = _vec(f, S_L)
    if rs.lay.env >= 0:
        L = L + _vec(f, rs.lay.env + 3) * emitters.env_radiance(rs.scene, _vec(f, rs.lay.env))
    return L


def pixel_paths(rs: RefScene, seed: int, pixels: torch.Tensor, samples: int,
                precision: str = "f32", block: int = 8192) -> torch.Tensor:
    """Radiance (P, samples, 3) of the paths (pixel, sample index s) for s
    in range(samples), on the pcg stream of (seed, pixel, s), traced in
    blocks of at most block paths."""
    P = pixels.shape[0]
    lanes = pixels.repeat_interleave(samples)
    sidx = torch.arange(samples, device=pixels.device).repeat(P)
    out = torch.empty((lanes.shape[0], 3), dtype=torch.float32, device=pixels.device)
    with torch.no_grad():
        for b0 in range(0, lanes.shape[0], block):
            lane = lanes[b0:b0 + block]
            rng = qmc.make_state("pcg", seed, lane, sidx[b0:b0 + block])
            o, d, rng = cam_mod.generate_rays(rs.camera, lane, rng)
            out[b0:b0 + lane.shape[0]] = trace(rs, o, d, rng, precision)
    return out.reshape(P, samples, 3)


def film_means(paths: torch.Tensor, counts) -> list:
    """The film's running mean (P, 3) after each count of passes in counts,
    folded as the program's film folds a pass: mean += (x - mean) / n."""
    mean = torch.zeros_like(paths[:, 0])
    out, n = [], 0
    for c in sorted(counts):
        while n < c:
            n += 1
            mean = mean + (paths[:, n - 1] - mean) / float(np.float32(n))
        out.append(mean.clone())
    return out
