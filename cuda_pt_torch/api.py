"""High-level renderer API (port of cuda_pt_tpu/api.py: every renderer
family of the reference: MEGAKERNEL_PT, VOLUME_PT, WAVEFRONT_PT,
MEGAKERNEL_LT, DEPTH and BVH_COST, with render_aovs and denoise).

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
  full size; only "pallas" walks on a kernel there;
- "auto" and "mxu" wait for ROADMAP Queue 1 items 6 and 13.
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
an envmap or emission. The composed routes render every surface scene;
VOLUME_PT's composed route takes no grid medium.

Still to port (ROADMAP Queue 1): emissive grids and the composed volume
path tracer's grid route, render_adaptive, film checkpoints, the XML
parser, the Sobol sampler (the Renderer draws from pcg streams only).
"""

from __future__ import annotations

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
# traversal -> the ROADMAP Queue 1 item that ports it
_TRAVERSAL_WAITING = {
    "auto": "item 6 (accel/autotune.py)",
    "mxu": "item 13 (ops/intersect_mxu.py)",
}


def _envelope_message(scene: T.Scene, vpt: bool) -> str:
    """Why a scene is outside the kernel's envelope, with the renderer or
    the ROADMAP item that would bring it in."""
    if T.BSDF_PLASTIC_FORWARD in scene.present_bsdfs:
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

        source: a ParsedScene (scene, camera, RenderingConfig) or an XML
        path (raises until the parser is ported). override_res: raises
        unless None (ROADMAP Queue 1 item 5). traversal: the route (module
        docstring). sampler: "pcg" (the pcg streams); any other raises as
        qmc.make_state does ("sobol" waits for ROADMAP Queue 1 item 1).

        nee_candidates: M > 1 = RIS light sampling (M candidates, one
        shadow ray); the fused volume path tracer takes 1 (traversal="fused"
        raises), so under the default route VOLUME_PT with M > 1 renders the
        composed volume path tracer, which ignores M, and info() reports M,
        as in the reference. max_lanes_per_call: split a pass into full-width row
        bands of at most this many lanes, one call each (0 = one call
        per pass; default from CUDA_PT_MAX_LANES_PER_CALL, else 0); only
        MEGAKERNEL_PT and VOLUME_PT are banded. Bands are bit-identical to
        the unbanded pass."""
        if override_res is not None:
            raise NotImplementedError("override_res waits for ROADMAP Queue 1 item 5 (the tail "
                                      "of the API)")
        qmc.check_sampler(sampler)
        self.sampler = sampler
        self.parsed: ParsedScene = load_xml(source) if isinstance(source, str) else source
        self.config = self.parsed.config
        self.rtype = RendererType(renderer or self.config.renderer)
        if traversal in _TRAVERSAL_WAITING:
            raise NotImplementedError(f"traversal {traversal!r} waits for ROADMAP Queue 1 "
                                      f"{_TRAVERSAL_WAITING[traversal]}")
        if traversal not in (None, "fused", *pt.TRAVERSALS):
            raise ValueError(f"unknown traversal {traversal!r}")
        vpt = self.rtype == RendererType.VOLUME_PT
        if vpt and int(nee_candidates) != 1 and traversal == "fused":
            raise ValueError("the fused volume path tracer takes nee_candidates=1, as in the "
                             "reference")
        if traversal == "fused" and self.rtype not in _BANDABLE:
            raise ValueError("traversal='fused' requires the megakernel PT or volume PT "
                             f"renderer, got {self.rtype}")
        scene = self.parsed.scene
        self.md: MaxDepthParams = self.config.md
        # the volume path tracer with nee_candidates > 1 takes the composed
        # route, which ignores it (the reference's auto-pick, api.py:106-110)
        fused_ok = (self.rtype in _BANDABLE
                    and (not vpt or int(nee_candidates) == 1)
                    and mk.megakernel_ok(scene, self.md, renderer="vpt" if vpt else "pt"))
        self.fused = traversal == "fused" or (traversal is None and fused_ok)
        has_grid = vpt and bool((scene.media.mtype == T.MEDIUM_GRID).any())
        if has_grid and not (self.fused and fused_ok):
            raise NotImplementedError(
                "a grid medium renders on the fused route only, and one with an envmap or "
                "with emission stays outside it, as in the reference; the composed volume path "
                "tracer's grid route waits for ROADMAP Queue 1 item 8")
        if (self.fused and not fused_ok) or (not vpt and mk.scene_has_media(scene)):
            raise ValueError(_envelope_message(scene, vpt))
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device=None) renders on CUDA, which is not available; "
                               "pass device='cpu' to render on the CPU")
        self.scene: T.Scene = T.to_device(scene, self.device)
        if traversal in pt.TRAVERSALS:
            self.scene.traversal = traversal
        if traversal == "wide" and self.scene.wide is None:
            from .accel import wide_build

            self.scene.wide = wide_build.from_bvharrays(self.scene.bvh)
        if (self.scene.traversal or pt.TRAVERSAL_IMPL) == "pallas" and not self.fused:
            self.scene.forest = pt.pallas_forest(self.scene)  # packed once, on our copy
        self.camera: cam_mod.Camera = self.parsed.camera.to(self.device)
        self.seed = int(self.config.seed) + int(seed_offset)
        self.use_bvh = self.scene.geom.num_prims > pt.BRUTE_FORCE_MAX_PRIMS
        self.nee_candidates = int(nee_candidates)
        if max_lanes_per_call is None:
            max_lanes_per_call = int(os.environ.get("CUDA_PT_MAX_LANES_PER_CALL", "0"))
        self.max_lanes_per_call = int(max_lanes_per_call)
        # w8 nodes, attr and prim formats by the reference's rule (make_pack)
        self._pack = mk.make_pack(self.scene, node_fmt="w8", vpt=vpt) if self.fused else None
        self.film = film_mod.make_film(self.camera.height, self.camera.width, self.device)
        self._frame_times = deque(maxlen=32)
        self._swizzles = {}  # (width, rows) -> Z-order (perm, inv) on the device

    # -- one pass ---------------------------------------------------------
    def _swizzle(self, width: int, rows: int):
        key = (width, rows)
        if key not in self._swizzles:
            self._swizzles[key] = mk.tile_swizzle(width, rows, self.device)
        return self._swizzles[key]

    def _trace_lanes(self, perm: torch.Tensor, idx: int) -> torch.Tensor:
        rng = qmc.make_state(self.sampler, self.seed, perm, idx)
        o, d, rng = cam_mod.generate_rays(self.camera, perm, rng)
        return mk.auto_trace(self._pack, self.md, o, d, rng, self.nee_candidates)

    def _composed_band(self, start: int, count: int, idx: int) -> torch.Tensor:
        """The composed path over lanes [start, start + count) in raster
        order (the reference's streams: lane = pixel index)."""
        if self.rtype == RendererType.VOLUME_PT:
            lane = start + torch.arange(count, device=self.device)
            rng = qmc.make_state(self.sampler, self.seed, lane, idx)
            o, d, rng = cam_mod.generate_rays(self.camera, lane, rng)
            return volume_pt.trace_paths(self.scene, self.md, o, d, rng,
                                         wl_u=pt.wl_stratum_u(self.seed, idx, lane))
        return pt.render_band(self.scene, self.camera, self.md, self.seed, idx, start, count,
                              self.nee_candidates)

    def _whole_pass(self, idx: int) -> torch.Tensor:
        """One pass of a family that is never banded -> (H, W, 3)."""
        H, W = self.camera.height, self.camera.width
        if self.rtype == RendererType.WAVEFRONT_PT:
            return wavefront.render_sample(self.scene, self.camera, self.md, self.seed, idx,
                                           compact=True, nee_candidates=self.nee_candidates)
        if self.rtype == RendererType.MEGAKERNEL_LT:
            img = light_tracer.render_pass(self.scene, self.camera, self.md, self.seed, idx,
                                           self.use_bvh, max(self.config.specular_constraint, 0),
                                           self.config.caustic_scaling)
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
        return float(np.mean(self._frame_times)) if self._frame_times else 0.0

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

    def release(self):
        self.film = None
        self._pack = None
