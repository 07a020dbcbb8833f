"""Host-side scene assembly: shapes + materials + emitters -> Scene,
frozen from the program's builder. compile(order=...) puts the prims in
a given order and remaps the emitter prims after it, as the program's
builder does after its tree build; no tree is built.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import types as T


@dataclasses.dataclass
class BSDFSpec:
    btype: int = T.BSDF_LAMBERTIAN
    k_d: tuple = (0.7, 0.7, 0.7)
    k_s: tuple = (0.0, 0.0, 0.0)
    k_g: tuple = (1.0, 1.0, 1.0)
    eta: tuple = (1.0, 1.0, 1.0)
    k: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.5
    roughness_x: float = 0.1
    roughness_y: float = 0.1
    thickness: float = 0.0
    cauchy_a: float = 1.5046
    cauchy_b: float = 0.00420
    penetration: float = 0.0
    tex_ids: tuple = (-1, -1, -1, -1, -1)
    name: str = ""


@dataclasses.dataclass
class EmitterSpec:
    etype: int = T.EMITTER_AREA
    emission: tuple = (1.0, 1.0, 1.0)
    scaler: float = 1.0
    pos: tuple = (0.0, 0.0, 0.0)
    extra: tuple = (0.0, 0.0, 0.0, 0.0)
    tex_id: int = -1
    name: str = ""


@dataclasses.dataclass
class MediumSpec:
    mtype: int = T.MEDIUM_HOMOGENEOUS
    sigma_a: tuple = (0.0, 0.0, 0.0)
    sigma_s: tuple = (0.0, 0.0, 0.0)
    scale: float = 1.0
    phase_type: int = T.PHASE_ISOTROPIC
    phase_g: tuple = (0.0, 0.0)
    phase_w: float = 1.0
    emission_scale: float = 0.0
    grid_id: int = -1
    name: str = ""


@dataclasses.dataclass
class _Object:
    p: np.ndarray  # (T, 3, 3) or sphere encoding (1, 3, 3)
    n: np.ndarray
    uv: np.ndarray
    is_sphere: bool
    bsdf_id: int
    emitter_id: int = 0
    medium_in: int = T.MEDIUM_NONE
    cullable: bool = False


class SceneBuilder:
    def __init__(self):
        self.bsdfs: List[BSDFSpec] = []
        self.emitters: List[EmitterSpec] = [EmitterSpec(etype=T.EMITTER_NULL, name="__null__")]
        self.objects: List[_Object] = []
        self.media: List[MediumSpec] = []
        self.textures: List[np.ndarray] = []  # (H, W, 4) float32 each
        self.env_emitter: int = 0
        self.cam_medium: int = T.MEDIUM_NONE

    # -- registration ------------------------------------------------------
    def add_bsdf(self, spec: BSDFSpec) -> int:
        self.bsdfs.append(spec)
        return len(self.bsdfs) - 1

    def add_emitter(self, spec: EmitterSpec) -> int:
        self.emitters.append(spec)
        eid = len(self.emitters) - 1
        if spec.etype == T.EMITTER_ENVMAP:
            self.env_emitter = eid
        return eid

    def add_medium(self, spec: MediumSpec) -> int:
        self.media.append(spec)
        return len(self.media) - 1

    def add_texture(self, image: np.ndarray) -> int:
        img = np.asarray(image, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], axis=-1)
        self.textures.append(img)
        return len(self.textures) - 1

    def add_mesh(
        self,
        p: np.ndarray,
        bsdf_id: int,
        n: Optional[np.ndarray] = None,
        uv: Optional[np.ndarray] = None,
        emitter_id: int = 0,
        medium_in: int = T.MEDIUM_NONE,
        cullable: bool = False,
    ) -> int:
        p = np.asarray(p, np.float32).reshape(-1, 3, 3)
        if n is None:
            fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = fn / np.maximum(ln, 1e-12)
            n = np.repeat(fn[:, None, :], 3, axis=1)
        if uv is None:
            uv = np.zeros((p.shape[0], 3, 2), np.float32)
        self.objects.append(
            _Object(p, np.asarray(n, np.float32), np.asarray(uv, np.float32),
                    False, bsdf_id, emitter_id, medium_in, cullable)
        )
        return len(self.objects) - 1

    # -- compile -----------------------------------------------------------
    def compile(self, device="cpu", order=None) -> T.Scene:
        """Compile to a Scene on ``device`` with its prims in ``order`` (new
        -> old index; None keeps the order the shapes were added in). No
        tree is built: the reference walks none."""

        def t(x, dtype=None):
            a = np.asarray(x, dtype)
            if dtype is None and a.dtype == np.float64:
                a = a.astype(np.float32)
            if dtype is None and a.dtype == np.int64:
                a = a.astype(np.int32)
            return torch.as_tensor(a, device=device)

        if not self.objects:
            # degenerate but compilable scene (e.g. every mesh asset missing):
            # one far-away micro-triangle so all shapes stay static
            if not self.bsdfs:
                self.bsdfs.append(BSDFSpec())
            tri = np.array(
                [[[1e6, 1e6, 1e6], [1e6 + 1e-3, 1e6, 1e6], [1e6, 1e6 + 1e-3, 1e6]]],
                np.float32,
            )
            self.add_mesh(tri, 0)
        num_obj = len(self.objects)

        # concatenate prims; track per-object ranges (pre-reorder)
        p0s, e1s, e2s = [], [], []
        n0s, n1s, n2s = [], [], []
        uv0s, uv1s, uv2s = [], [], []
        obj_ids, sph = [], []
        for oi, ob in enumerate(self.objects):
            nt = ob.p.shape[0]
            p0s.append(ob.p[:, 0])
            if ob.is_sphere:
                r = np.linalg.norm(ob.p[0, 1] - ob.p[0, 0])
                e1s.append(np.array([[r, 0, 0]], np.float32))
                e2s.append(np.array([[0, r, 0]], np.float32))
            else:
                e1s.append(ob.p[:, 1] - ob.p[:, 0])
                e2s.append(ob.p[:, 2] - ob.p[:, 0])
            n0s.append(ob.n[:, 0]); n1s.append(ob.n[:, 1]); n2s.append(ob.n[:, 2])
            uv0s.append(ob.uv[:, 0]); uv1s.append(ob.uv[:, 1]); uv2s.append(ob.uv[:, 2])
            obj_ids.append(np.full(nt, oi, np.int32))
            sph.append(np.full(nt, ob.is_sphere, bool))

        p0 = np.concatenate(p0s); e1 = np.concatenate(e1s); e2 = np.concatenate(e2s)
        n0 = np.concatenate(n0s); n1 = np.concatenate(n1s); n2 = np.concatenate(n2s)
        uv0 = np.concatenate(uv0s); uv1 = np.concatenate(uv1s); uv2 = np.concatenate(uv2s)
        obj_idx = np.concatenate(obj_ids); is_sphere = np.concatenate(sph)

        # per-prim area on ORIGINAL prims (pre-reorder: SBVH may duplicate
        # references, which must not inflate sampling areas — reference
        # emissive-prim dedup, src/impl/bvh_spatial.cu:996-1013)
        tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
        sph_area = 4.0 * np.pi * e1[:, 0] ** 2
        orig_area = np.where(is_sphere, sph_area, tri_area)
        inv_area = np.zeros(num_obj, np.float32)
        for oi in range(num_obj):
            a = orig_area[obj_idx == oi].sum()
            inv_area[oi] = 1.0 / max(a, 1e-12)

        # primitive reorder
        n_prims = p0.shape[0]
        order = np.arange(n_prims, dtype=np.int64) if order is None else np.asarray(order)
        if order.shape != (n_prims,) or not np.array_equal(np.sort(order), np.arange(n_prims)):
            raise ValueError("order must be a permutation of the prims")
        p0, e1, e2 = p0[order], e1[order], e2[order]
        n0, n1, n2 = n0[order], n1[order], n2[order]
        uv0, uv1, uv2 = uv0[order], uv1[order], uv2[order]
        obj_idx, is_sphere = obj_idx[order], is_sphere[order]
        prim_area = orig_area[order]
        # first-occurrence slots of each original prim (emitter sampling
        # must count duplicated SBVH refs exactly once)
        _, first_slots = np.unique(order, return_index=True)
        is_first = np.zeros(order.shape[0], bool)
        is_first[first_slots] = True
        objects = T.ObjectTable(
            bsdf_id=t([o.bsdf_id for o in self.objects], np.int32),
            emitter_id=t([o.emitter_id for o in self.objects], np.int32),
            medium_in=t([o.medium_in for o in self.objects], np.int32),
            cullable=t([o.cullable for o in self.objects], bool),
            prim_base=t(np.zeros(num_obj), np.int32),  # contiguity broken by reorder
            prim_count=t([o.p.shape[0] for o in self.objects], np.int32),
            inv_area=t(inv_area),
        )

        # emitter table with post-reorder prim CDFs
        E = len(self.emitters)
        emitter_obj = np.full(E, -1, np.int32)
        for oi, ob in enumerate(self.objects):
            if ob.emitter_id > 0:
                emitter_obj[ob.emitter_id] = oi
        kmax = 1
        sel_lists = []
        for e in range(E):
            if emitter_obj[e] >= 0:
                sel = np.nonzero((obj_idx == emitter_obj[e]) & is_first)[0].astype(
                    np.int32
                )
                sel_lists.append(sel)
                kmax = max(kmax, sel.size)
            else:
                sel_lists.append(np.zeros(0, np.int32))
        prim_cdf = np.ones((E, kmax), np.float32)
        prim_sel = np.zeros((E, kmax), np.int32)
        for e, sel in enumerate(sel_lists):
            if sel.size:
                a = prim_area[sel]
                cdf = np.cumsum(a) / max(a.sum(), 1e-12)
                prim_cdf[e, : sel.size] = cdf
                prim_cdf[e, sel.size :] = 1.0
                prim_sel[e, : sel.size] = sel
                prim_sel[e, sel.size :] = sel[-1]

        # power-weighted selection pmf (75% power + 25% uniform mix; see
        # EmitterTable docstring). Powers are approximate by design — any
        # positive pmf is unbiased — so textured emitters use their base
        # emission and the envmap its mean texel luminance.
        sel_pmf = np.zeros(E, np.float32)
        lum_w = np.array([0.212671, 0.715160, 0.072169])
        powers = np.zeros(E)
        for e_i, e in enumerate(self.emitters):
            if e.etype == T.EMITTER_NULL:
                continue
            lum = float(np.dot(np.asarray(e.emission), lum_w)) * e.scaler
            if e.etype in (T.EMITTER_AREA, T.EMITTER_AREA_SPOT):
                oi = emitter_obj[e_i]
                area = 1.0 / max(float(inv_area[oi]), 1e-12) if oi >= 0 else 0.0
                frac = 1.0
                if e.etype == T.EMITTER_AREA_SPOT:
                    frac = max((1.0 - float(e.extra[0])) * 0.5, 1e-3)
                powers[e_i] = lum * np.pi * area * frac
            elif e.etype == T.EMITTER_POINT:
                powers[e_i] = lum * 4.0 * np.pi
            elif e.etype == T.EMITTER_ENVMAP:
                mean_tex = 1.0
                if 0 <= e.tex_id < len(self.textures):
                    mean_tex = float(
                        np.dot(
                            np.asarray(self.textures[e.tex_id])[..., :3]
                            .reshape(-1, 3)
                            .mean(axis=0),
                            lum_w,
                        )
                    )
                powers[e_i] = lum * max(float(e.extra[0]), 0.0) * mean_tex * 4.0 * np.pi
        real = np.array([e.etype != T.EMITTER_NULL for e in self.emitters])
        n_real = max(int(real.sum()), 1)
        total = powers.sum()
        if total > 0.0:
            sel_pmf = (0.75 * powers / total + 0.25 * real / n_real).astype(
                np.float32
            )
        else:
            sel_pmf = (real / n_real).astype(np.float32)
        sel_cdf = np.cumsum(sel_pmf).astype(np.float32)
        if sel_cdf[-1] > 0:
            sel_cdf /= sel_cdf[-1]
        else:
            sel_cdf[:] = 1.0

        emitters = T.EmitterTable(
            etype=t([e.etype for e in self.emitters], np.int32),
            emission=t([e.emission for e in self.emitters], np.float32),
            scaler=t([e.scaler for e in self.emitters], np.float32),
            pos=t([e.pos for e in self.emitters], np.float32),
            extra=t([e.extra for e in self.emitters], np.float32),
            obj_id=t(emitter_obj),
            tex_id=t([e.tex_id for e in self.emitters], np.int32),
            prim_cdf=t(prim_cdf),
            prim_sel=t(prim_sel),
            sel_pmf=t(sel_pmf),
            sel_cdf=t(sel_cdf),
        )

        # bsdf table
        if not self.bsdfs:
            self.bsdfs.append(BSDFSpec())
        params = np.zeros((len(self.bsdfs), T.NUM_BSDF_PARAMS), np.float32)
        for i, b in enumerate(self.bsdfs):
            params[i, T.P_IOR] = b.ior
            params[i, T.P_ROUGH_X] = b.roughness_x
            params[i, T.P_ROUGH_Y] = b.roughness_y
            params[i, T.P_THICKNESS] = b.thickness
            params[i, T.P_CAUCHY_A] = b.cauchy_a
            params[i, T.P_CAUCHY_B] = b.cauchy_b
            params[i, T.P_PENETRATION] = b.penetration
        bsdfs = T.BSDFTable(
            btype=t([b.btype for b in self.bsdfs], np.int32),
            k_d=t([b.k_d for b in self.bsdfs], np.float32),
            k_s=t([b.k_s for b in self.bsdfs], np.float32),
            k_g=t([b.k_g for b in self.bsdfs], np.float32),
            eta=t([b.eta for b in self.bsdfs], np.float32),
            k=t([b.k for b in self.bsdfs], np.float32),
            params=t(params),
            tex_ids=t([b.tex_ids for b in self.bsdfs], np.int32),
        )

        # texture atlas
        if self.textures:
            offs, ws, hs, pool = [], [], [], []
            cur = 0
            for img in self.textures:
                h, w = img.shape[:2]
                offs.append(cur); ws.append(w); hs.append(h)
                pool.append(img.reshape(-1, 4))
                cur += h * w
            atlas = T.TextureAtlas(
                texels=t(np.concatenate(pool, axis=0)),
                offset=t(offs, np.int32),
                width=t(ws, np.int32),
                height=t(hs, np.int32),
            )
        else:
            atlas = T.TextureAtlas(
                texels=t(np.zeros((1, 4)), np.float32),
                offset=t(np.zeros(1), np.int32),
                width=t(np.ones(1), np.int32),
                height=t(np.ones(1), np.int32),
            )

        # media
        med = self.media or [MediumSpec(mtype=-1)]
        media = T.MediumTable(
            mtype=t([m.mtype for m in med], np.int32),
            sigma_a=t([m.sigma_a for m in med], np.float32),
            sigma_s=t([m.sigma_s for m in med], np.float32),
            scale=t([m.scale for m in med], np.float32),
            phase_type=t([m.phase_type for m in med], np.int32),
            phase_g=t([m.phase_g for m in med], np.float32),
            phase_w=t([m.phase_w for m in med], np.float32),
            emission_scale=t([m.emission_scale for m in med], np.float32),
            grid_id=t([m.grid_id for m in med], np.int32),
        )


        geom = T.Geometry(
            p0=t(p0), e1=t(e1), e2=t(e2),
            n0=t(n0), n1=t(n1), n2=t(n2),
            uv0=t(uv0), uv1=t(uv1), uv2=t(uv2),
            obj_idx=t(obj_idx), is_sphere=t(is_sphere),
        )
        num_emitters = sum(1 for e in self.emitters if e.etype != T.EMITTER_NULL)
        present = tuple(sorted({b.btype for b in self.bsdfs}))

        scene = T.Scene(
            present_bsdfs=present,
            geom=geom,
            objects=objects,
            emitters=emitters,
            bsdfs=bsdfs,
            textures=atlas,
            media=media,
            env_emitter=int(self.env_emitter),
            cam_medium=int(self.cam_medium),
            num_emitters=int(num_emitters),
        )
        return scene
