"""High-level renderer API (port of cuda_pt_tpu/api.py: every renderer
family of the reference: MEGAKERNEL_PT, VOLUME_PT, WAVEFRONT_PT,
MEGAKERNEL_LT, DEPTH and BVH_COST, with render_aovs, denoise,
render_adaptive and film checkpoints).

One stateful Renderer over a compiled scene: the film and the camera stay
on the render device between passes. ``traversal`` picks the route, with
the reference's names:
- None (default): the fused kernel routes below for a MEGAKERNEL_PT or
  VOLUME_PT scene inside the kernel's envelope; outside it (Plastic-
  forward, say) and for the other families the composed path on the
  default walk (models/path_tracer.TRAVERSAL_IMPL, the skip walk);
- "fused": the kernel routes, raising outside the envelope and for every
  family but MEGAKERNEL_PT and VOLUME_PT, as the reference does;
- "xla" / "pallas" / "wide": the composed path on that walk:
  path_tracer.render_band (MEGAKERNEL_PT), volume_pt.trace_paths
  (VOLUME_PT), wavefront.render_sample with compact=True (WAVEFRONT_PT),
  light_tracer.render_pass (MEGAKERNEL_LT, its splat over the whole film).
  Only MEGAKERNEL_PT and VOLUME_PT are banded (_BANDABLE), as in the
  reference: a light path splats anywhere on the film. "pallas" is
  kernel K1, the CUDA port of the reference's Pallas walk
  (ops/traverse_kernel.py; the light tracer's closest and connection
  walks and render_aovs' first hits walk on it too), over
  the scene's forest (SceneBuilder.compile(forest_chunk=...)) or its BVH
  as one chunk; "wide" the 8-wide walk over a wide tree collapsed at
  construction. "xla" and "wide" (and so the default composed routes)
  are plain PyTorch walks that launch no kernel, slow on the card at
  full size; only "pallas" walks on a kernel there. A ToF-gated config
  (md.max_time > 0) takes these routes: the fused kernels take no ToF
  window;
- "auto": each eligible walk timed on the render device
  (accel/autotune.with_tuned_traversal) and the fastest kept for the
  composed path; info()["traversal"] reports the pick;
- "mxu": the composed path on the matmul-form brute force
  (ops/intersect_mxu.py, torch.matmul in full f32), at any prim count.
DEPTH (debug_renderers.render_depth) and BVH_COST (render_bvh_cost) walk
the skip walk or the brute force whatever ``traversal`` says, as in the
reference. render_aovs (the first hits through the scene's walk, K1 under
"pallas") and denoise (models/denoise.atrous_denoise of the film mean
with fresh AOVs) render on any route.

The kernel routes run the reference's driver pick
(ops/megakernel.auto_trace): a scene of fewer than
SWF_AUTO_BOXES (512) boxes takes the whole-path megakernel (K2 / K3, K4
for media), a scene of 512 boxes or more the sorted-wavefront driver
(kernel K5, one bounce per launch with the lanes re-sorted between
bounces), and a scene with a grid medium that driver's split form
(kernel K6 and K5's shade phase around delta-tracked flight and
ratio-tracked NEE). On a CUDA device the kernels run, on the CPU their
plain PyTorch versions. ``device=None`` means CUDA and raises where CUDA
is absent; pass ``device="cpu"`` to render on the CPU. The two drivers
compute the same estimator per lane on untextured scenes; on textured ones
(kitchen_stress) the driver resolves each bounce's texel inline, so its
Russian roulette sees the texels of the earlier bounces, and it agrees
with the whole-path kernel in the mean only, as in the reference.

The kernel routes pack the scene as the reference's Renderer does
(make_pack(node_fmt="w8")): w8 nodes, and attrs and prims by the
reference's rule, so a scene whose f32 pack exceeds AUTO_COMPACT_BYTES
(2 MiB; kitchen_stress, medium_cbox) renders with bf16 attrs (shading
normals truncated to bf16) and, if all triangles, t9 prims.

The kernel's envelope (megakernel_ok): all surface BSDF families but
Plastic-forward, area / area-spot / point emitters, envmaps, diffuse
textures, dispersion; under RendererType.VOLUME_PT (a vpt pack,
nee_candidates=1) homogeneous media at any size and grid media without
an envmap or emission. The composed routes render every surface scene
and every media scene: a grid scene outside the envelope (an emissive
grid, a grid under an envmap) takes VOLUME_PT's composed route on the
default walk, as in the reference's auto-pick, and any scene does under
traversal "xla" / "pallas" / "wide".

sampler="sobol" draws from the Owen-scrambled Sobol sampler
(core/qmc.py) on every route. The kernel routes take pcg streams only, so
there it runs the reference's hybrid scheme: Sobol camera jitter on the
Z-order lanes, and the kernels' path streams from pcg seeded
seed ^ 0x9E3779B9.

A str source is a Mitsuba-style XML scene (scene/xml_parser.load_xml),
compiled on the host with override_res applied before the camera is made.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import deque

import numpy as np
import torch

from .core import camera as cam_mod
from .core import film as film_mod
from .core import qmc
from .core.config import MaxDepthParams, RendererType
from .models import debug_renderers, light_tracer, volume_pt, wavefront
from .models import denoise as dn
from .models import path_tracer as pt
from .ops import megakernel as mk
from .scene import types as T
from .scene.xml_parser import ParsedScene, load_xml

# the families whose pass may be split into row bands, and the only ones
# the kernel routes take (the reference's _BANDABLE and auto-pick)
_BANDABLE = (RendererType.MEGAKERNEL_PT, RendererType.VOLUME_PT)


def _envelope_message(scene: T.Scene, md: MaxDepthParams, vpt: bool) -> str:
    """Why a scene is outside the kernel's envelope, with the renderer or
    the ROADMAP item that would bring it in."""
    if md.max_time > 0.0:
        item = ("the fused kernels take no ToF window, as in the reference; traversal=None "
                "renders a gated scene through the composed path")
    elif T.BSDF_PLASTIC_FORWARD in scene.present_bsdfs:
        item = ("Plastic-forward stays outside the fused kernel, as in the reference; "
                "traversal=None renders it through the composed path")
    elif mk.scene_has_media(scene) and not vpt:
        item = "participating media render with renderer=RendererType.VOLUME_PT"
    elif vpt and bool((scene.bsdfs.tex_ids >= 0).any()):
        item = "the fused volume path tracer takes no textures, as in the reference"
    else:
        item = "see megakernel_ok for the limits; ROADMAP Queue 2 lists them"
    return f"scene outside the fused-megakernel envelope: {item}"


class Renderer:
    """Stateful renderer over a compiled scene."""

    def __init__(self, source, renderer: RendererType | None = None, seed_offset: int = 0,
                 override_res=None, traversal: str | None = None, sampler: str = "pcg",
                 nee_candidates: int = 1, max_lanes_per_call: int | None = None, device=None):
        """The reference's parameters in the reference's order, then device.

        source: a ParsedScene (scene, camera, RenderingConfig) or the path
        of an XML scene (scene/xml_parser.load_xml). override_res: (width,
        height) for an XML source, applied by the parser; ignored for a
        ParsedScene, as in the reference. traversal: the route (module
        docstring).
        sampler: "pcg" (the stream sampler) or "sobol" (Owen-scrambled
        Sobol; on the kernel routes the hybrid scheme of the module
        docstring); any other raises.

        nee_candidates: M > 1 = RIS light sampling (M candidates, one
        shadow ray); the fused volume path tracer takes 1 (traversal="fused"
        raises), so under the default route VOLUME_PT with M > 1 renders the
        composed volume path tracer, which ignores M, and info() reports M,
        as in the reference. max_lanes_per_call: split a pass into full-width row
        bands of at most this many lanes, one call each (0 = one call
        per pass; default from CUDA_PT_MAX_LANES_PER_CALL, else 0); only
        MEGAKERNEL_PT and VOLUME_PT are banded. Bands are bit-identical to
        the unbanded pass."""
        qmc.check_sampler(sampler)
        self.sampler = sampler
        self.parsed: ParsedScene = (load_xml(source, override_res=override_res)
                                    if isinstance(source, str) else source)
        self.config = self.parsed.config
        self.rtype = RendererType(renderer or self.config.renderer)
        if traversal not in (None, "fused", "auto", *pt.TRAVERSALS):
            raise ValueError(f"unknown traversal {traversal!r}")
        self._traversal = traversal
        self.nee_candidates = int(nee_candidates)
        self.md: MaxDepthParams = self.config.md
        self.fused = self._fused_route(self.parsed.scene)
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device=None) renders on CUDA, which is not available; "
                               "pass device='cpu' to render on the CPU")
        self.scene: T.Scene = T.to_device(self.parsed.scene, self.device)
        self.camera: cam_mod.Camera = self.parsed.camera.to(self.device)
        if traversal in pt.TRAVERSALS:
            self.scene.traversal = traversal
        elif traversal == "auto":
            from .accel.autotune import with_tuned_traversal

            self.scene = with_tuned_traversal(self.scene, self.camera)
        if traversal == "wide" and self.scene.wide is None:
            from .accel import wide_build

            self.scene.wide = wide_build.from_bvharrays(self.scene.bvh)
        self.seed = int(self.config.seed) + int(seed_offset)
        self.use_bvh = self.scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS
        if max_lanes_per_call is None:
            max_lanes_per_call = int(os.environ.get("CUDA_PT_MAX_LANES_PER_CALL", "0"))
        self.max_lanes_per_call = int(max_lanes_per_call)
        self._repack()
        self.film = film_mod.make_film(self.camera.height, self.camera.width, self.device)
        self._frame_times = deque(maxlen=32)
        self._swizzles = {}  # (width, rows) -> Z-order (perm, inv) on the device

    # -- the route ----------------------------------------------------------
    def _fused_route(self, scene: T.Scene) -> bool:
        """Whether scene, self.md, self.rtype and self.nee_candidates take
        the kernel routes under the requested traversal; ValueError where
        the request cannot be met (an explicit "fused" outside the envelope
        or off MEGAKERNEL_PT / VOLUME_PT, media off VOLUME_PT)."""
        traversal, vpt = self._traversal, self.rtype == RendererType.VOLUME_PT
        if vpt and self.nee_candidates != 1 and traversal == "fused":
            raise ValueError("the fused volume path tracer takes nee_candidates=1, as in the "
                             "reference")
        if traversal == "fused" and self.rtype not in _BANDABLE:
            raise ValueError("traversal='fused' requires the megakernel PT or volume PT "
                             f"renderer, got {self.rtype}")
        # the volume path tracer with nee_candidates > 1 takes the composed
        # route, which ignores it (the reference's auto-pick, api.py:106-110)
        fused_ok = (self.rtype in _BANDABLE and (not vpt or self.nee_candidates == 1)
                    and mk.megakernel_ok(scene, self.md, renderer="vpt" if vpt else "pt"))
        fused = traversal == "fused" or (traversal is None and fused_ok)
        if (fused and not fused_ok) or (not vpt and mk.scene_has_media(scene)):
            raise ValueError(_envelope_message(scene, self.md, vpt))
        return fused

    def _repack(self):
        """The route's device tables from the current scene: K1's forest on
        the composed "pallas" route (packed once, on our copy), the kernel
        routes' pack (w8 nodes, attr and prim formats by the reference's
        rule, make_pack)."""
        if (self.scene.traversal or pt.TRAVERSAL_IMPL) == "pallas" and not self.fused \
                and self.scene.forest is None:
            self.scene = dataclasses.replace(self.scene, forest=pt.pallas_forest(self.scene))
        vpt = self.rtype == RendererType.VOLUME_PT
        self._pack = mk.make_pack(self.scene, node_fmt="w8", vpt=vpt) if self.fused else None

    def _reroute(self):
        """Re-decide the route and rebuild its tables from the current
        scene, md, family and sampler (the rule of __init__): after an edit
        of any of them (the viewer's hot reload), so the next pass sees the
        edit on the kernel routes too. Swaps references only: a pass in
        flight keeps the tables it started with."""
        self.fused = self._fused_route(self.scene)
        self._repack()

    # -- one pass ---------------------------------------------------------
    def _swizzle(self, width: int, rows: int):
        key = (width, rows)
        if key not in self._swizzles:
            self._swizzles[key] = mk.tile_swizzle(width, rows, self.device)
        return self._swizzles[key]

    def _trace_lanes(self, perm: torch.Tensor, idx: int) -> torch.Tensor:
        """The kernel route over the lanes perm (absolute pixel ids). Under
        "sobol" the hybrid scheme: Sobol jitter for the camera rays, the
        kernel's paths on pcg streams seeded seed ^ 0x9E3779B9."""
        o, d, rng = self._hybrid_rays(perm, idx)
        return mk.auto_trace(self._pack, self.md, o, d, rng, self.nee_candidates)

    def _hybrid_rays(self, perm: torch.Tensor, idx):
        """(o, d, pcg states) of the kernel route's lanes perm at sample idx."""
        if self.sampler == "sobol":
            o, d, _ = cam_mod.generate_rays(self.camera, perm,
                                            qmc.make_state("sobol", self.seed, perm, idx))
            rng = qmc.make_state("pcg", (self.seed & 0xFFFFFFFF) ^ 0x9E3779B9, perm, idx)
            return o, d, rng
        rng = qmc.make_state("pcg", self.seed, perm, idx)
        return cam_mod.generate_rays(self.camera, perm, rng)

    def _composed_band(self, start: int, count: int, idx: int) -> torch.Tensor:
        """The composed path over lanes [start, start + count) in raster
        order (the reference's streams: lane = pixel index)."""
        if self.rtype == RendererType.VOLUME_PT:
            lane = start + torch.arange(count, device=self.device)
            rng = qmc.make_state(self.sampler, self.seed, lane, idx)
            o, d, rng = cam_mod.generate_rays(self.camera, lane, rng)
            return volume_pt.trace_paths(self.scene, self.md, o, d, rng,
                                         wl_u=pt.wl_stratum_u(self.seed, idx, lane))
        return pt.render_band(self.scene, self.camera, self.md, self.seed, idx, None, start, count,
                              sampler=self.sampler, nee_candidates=self.nee_candidates)

    def _whole_pass(self, idx: int) -> torch.Tensor:
        """One pass of a family that is never banded -> (H, W, 3)."""
        H, W = self.camera.height, self.camera.width
        if self.rtype == RendererType.WAVEFRONT_PT:
            return wavefront.render_sample(self.scene, self.camera, self.md, self.seed, idx,
                                           compact=True, sampler=self.sampler,
                                           nee_candidates=self.nee_candidates)
        if self.rtype == RendererType.MEGAKERNEL_LT:
            img = light_tracer.render_pass(self.scene, self.camera, self.md, self.seed, idx,
                                           self.use_bvh, max(self.config.specular_constraint, 0),
                                           self.config.caustic_scaling, sampler=self.sampler)
            return img.reshape(H, W, 3)
        if self.rtype == RendererType.DEPTH:
            return debug_renderers.render_depth(self.scene, self.camera, use_bvh=self.use_bvh)[0]
        return debug_renderers.render_bvh_cost(self.scene, self.camera)[0]

    def render_raw(self) -> torch.Tensor:
        """One 1-spp pass folded into the film; returns the pass (H, W, 3).
        The kernel routes run lanes in Z-order screen blocks
        (mk.tile_swizzle); when H*W exceeds max_lanes_per_call the pass of
        a _BANDABLE family is split into row bands."""
        t0 = time.perf_counter()
        H, W = self.camera.height, self.camera.width
        idx = self.film.count
        budget = self.max_lanes_per_call
        if self.rtype not in _BANDABLE:
            img = self._whole_pass(idx)
        elif budget and H * W > budget:
            rows_per = max(budget // W, 1)
            parts = []
            for r0 in range(0, H, rows_per):
                rows = min(rows_per, H - r0)
                if self.fused:
                    perm, inv = self._swizzle(W, rows)
                    parts.append(self._trace_lanes(r0 * W + perm, idx)[inv])
                else:
                    parts.append(self._composed_band(r0 * W, rows * W, idx))
            img = torch.cat(parts, dim=0).reshape(H, W, 3)
        elif self.fused:
            perm, inv = self._swizzle(W, H)
            img = self._trace_lanes(perm, idx)[inv].reshape(H, W, 3)
        else:
            img = self._composed_band(0, H * W, idx).reshape(H, W, 3)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._frame_times.append((time.perf_counter() - t0) * 1e3)
        self.film = film_mod.accumulate(self.film, img)
        return img

    def render(self, spp: int | None = None) -> np.ndarray:
        """Accumulate spp passes; return the running-mean image (H, W, 3)."""
        for _ in range(spp or 1):
            self.render_raw()
        return self.film.mean.cpu().numpy()

    def render_adaptive(self, spp_budget: int, **kw) -> np.ndarray:
        """Variance-driven adaptive render (models/adaptive.render_adaptive,
        its tracer "pt" unless kw says otherwise): the budget of
        render(spp_budget), sent to the highest-error tiles; under the pcg
        sampler on the kernel routes each round runs the kernels
        (mk.auto_trace). Replaces the film: mean the image, weight the
        per-pixel counts, count the largest count (at least 2) so that a
        later render() draws no (pixel, sample) stream twice, and m2 rebuilt
        so that variance(film) / count is the variance of the mean."""
        from .models import adaptive

        img, n, var = adaptive.render_adaptive(
            self.scene, self.camera, self.md, spp_budget, seed=self.seed, use_bvh=self.use_bvh,
            sampler=self.sampler, return_variance=True,
            fused_pack=self._pack if self.sampler == "pcg" else None, **kw)
        cnt = max(int(np.ceil(float(n.max()))), 2)
        self.film = film_mod.Film(mean=img, m2=var * cnt * (cnt - 1), weight=n, count=cnt)
        return img.cpu().numpy()

    def render_aovs(self, spp: int = 1) -> dict:
        """First-hit denoiser AOVs (albedo, normal, emission, depth,
        coverage) as numpy arrays (models/debug_renderers.render_aovs)."""
        aovs = debug_renderers.render_aovs(self.scene, self.camera, spp=spp, seed=self.seed,
                                           use_bvh=self.use_bvh)
        return {k: v.cpu().numpy() for k, v in aovs.items()}

    def denoise(self, aov_spp: int = 4, variance_guided: bool = True) -> np.ndarray:
        """Edge-avoiding à-trous denoise of the film mean with fresh
        first-hit AOVs (models/denoise.atrous_denoise) on the seed + 7919
        streams (decorrelated from the film's, as in the reference).
        variance_guided feeds the film's per-pixel variance of the mean to
        the filter; a film of fewer than 2 passes has no variance estimate
        and takes the plain filter."""
        aovs = debug_renderers.render_aovs(self.scene, self.camera, spp=aov_spp,
                                           seed=self.seed + 7919, use_bvh=self.use_bvh)
        variance = None
        if variance_guided and self.film.count >= 2:
            variance = film_mod.variance(self.film) / max(self.film.count, 1)
        return dn.atrous_denoise(self.film.mean, aovs, variance=variance).cpu().numpy()

    # -- TracerBase surface -------------------------------------------------
    def variance(self) -> np.ndarray:
        return film_mod.variance(self.film).cpu().numpy()

    def counter(self) -> int:
        return int(self.film.count)

    def avg_frame_time(self) -> float:
        """Mean wall ms of the last passes (kernel + host, synchronized)."""
        times = list(self._frame_times)
        return float(np.mean(times)) if times else 0.0

    def info(self) -> dict:
        return {
            "renderer": str(self.rtype.value),
            "width": self.camera.width,
            "height": self.camera.height,
            "num_prims": self.scene.geom.num_prims,
            "num_nodes": self.scene.bvh.num_nodes,
            "spp_accumulated": self.counter(),
            "use_bvh": self.use_bvh,
            "traversal": "fused" if self.fused else self.scene.traversal or pt.TRAVERSAL_IMPL,
            "driver": mk.driver_of(self._pack) if self.fused else "composed",
            "device": str(self.device),
            "sampler": self.sampler,
            "nee_candidates": self.nee_candidates,
            **self._flags(),
        }

    def _flags(self) -> dict:
        """The kernel's format flags (K3's, media, grid), from the pack on
        the kernel routes, from the scene on the composed ones."""
        if self.fused:
            return {**self._pack.flags, "has_media": self._pack.has_media,
                    "has_grid": self._pack.has_grid}
        s = self.scene
        media = mk.scene_has_media(s)
        return {"has_env": s.env_emitter > 0, "textured": pt.scene_textured(s),
                "has_disp": T.BSDF_DISPERSION in set(s.present_bsdfs), "has_media": media,
                "has_grid": media and bool((s.media.mtype == T.MEDIUM_GRID).any())}

    def update_camera(self, camera: cam_mod.Camera):
        self.camera = camera.to(self.device)
        self.reset_out_buffer()

    def reset_out_buffer(self):
        self.film = film_mod.make_film(self.camera.height, self.camera.width, self.device)

    def set_seed_offset(self, off: int):
        self.seed = int(self.config.seed) + int(off)

    def get_image_buffer(self, gamma: bool | None = None) -> np.ndarray:
        g = self.config.gamma if gamma is None else gamma
        return film_mod.export_numpy(self.film, gamma=g)

    def save(self, path: str, gamma: bool | None = None):
        from .utils.image import save_png

        save_png(path, self.get_image_buffer(gamma))

    def save_checkpoint(self, path: str):
        film_mod.save_checkpoint(self.film, path)

    def load_checkpoint(self, path: str):
        """The checkpoint's film, on the Renderer's device."""
        self.film = film_mod.load_checkpoint(path, device=self.device)

    def release(self):
        self.film = None
        self._pack = None
