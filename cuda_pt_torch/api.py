"""High-level renderer API (port of cuda_pt_tpu/api.py, MEGAKERNEL_PT and
VOLUME_PT).

One stateful Renderer over a compiled scene: the film and the camera stay
on the render device between passes, and every pass runs the reference's
driver pick (ops/megakernel.auto_trace): a scene of fewer than
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

Every scene inside the fused kernel's envelope renders (all surface BSDF
families but Plastic-forward, area / area-spot / point emitters, envmaps,
diffuse textures, dispersion; megakernel_ok). RendererType.VOLUME_PT
renders participating media (a vpt pack, nee_candidates=1): homogeneous
media at any size, and grid media without an envmap or emission.

Still to port (ROADMAP Queue 1): other renderer families, emissive grids
and the composed volume path tracer's grid route, render_adaptive,
render_aovs, denoise, film checkpoints, the XML parser, the Sobol sampler
(the Renderer draws from pcg streams only).
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
from .ops import megakernel as mk
from .scene import types as T
from .scene.xml_parser import ParsedScene, load_xml

# renderer family -> the ROADMAP Queue 1 item that ports it
_WAITING = {
    RendererType.WAVEFRONT_PT: "item 7 (models/wavefront.py)",
    RendererType.MEGAKERNEL_LT: "item 9 (models/light_tracer.py)",
    RendererType.DEPTH: "item 10 (models/debug_renderers.py)",
    RendererType.BVH_COST: "item 10 (models/debug_renderers.py)",
}


def _envelope_message(scene: T.Scene, vpt: bool) -> str:
    """Why a scene is outside the kernel's envelope, with the renderer or
    the ROADMAP item that would bring it in."""
    if T.BSDF_PLASTIC_FORWARD in scene.present_bsdfs:
        item = ("Plastic-forward stays outside the fused kernel, as in the reference; the "
                "Renderer's composed-path route for it waits for ROADMAP Queue 1 item 5")
    elif mk.scene_has_media(scene) and not vpt:
        item = "participating media render with renderer=RendererType.VOLUME_PT"
    elif vpt and bool((scene.bsdfs.tex_ids >= 0).any()):
        item = "the fused volume path tracer takes no textures, as in the reference"
    else:
        item = "see megakernel_ok for the limits; ROADMAP Queue 2 lists what is to port"
    return f"scene outside the fused-megakernel envelope: {item}"


class Renderer:
    """Stateful renderer over a compiled scene."""

    def __init__(self, source, renderer: RendererType | None = None, seed_offset: int = 0,
                 nee_candidates: int = 1, max_lanes_per_call: int | None = None, device=None):
        """source: a ParsedScene (scene, camera, RenderingConfig) or an XML
        path (raises until the parser is ported).

        nee_candidates: M > 1 = RIS light sampling (M candidates, one
        shadow ray); the volume path tracer takes 1. max_lanes_per_call: split a pass into full-width row
        bands of at most this many lanes, one kernel launch each (0 = one
        launch per pass; default from CUDA_PT_MAX_LANES_PER_CALL, else 0).
        Bands are bit-identical to the unbanded pass."""
        self.parsed: ParsedScene = load_xml(source) if isinstance(source, str) else source
        self.config = self.parsed.config
        self.rtype = RendererType(renderer or self.config.renderer)
        if self.rtype not in (RendererType.MEGAKERNEL_PT, RendererType.VOLUME_PT):
            raise NotImplementedError(
                f"renderer {self.rtype.value!r} waits for ROADMAP Queue 1 {_WAITING[self.rtype]}")
        vpt = self.rtype == RendererType.VOLUME_PT
        if vpt and int(nee_candidates) != 1:
            raise ValueError("the fused volume path tracer takes nee_candidates=1, as in the "
                             "reference")
        scene = self.parsed.scene
        self.md: MaxDepthParams = self.config.md
        if not mk.megakernel_ok(scene, self.md, renderer="vpt" if vpt else "pt"):
            if vpt and bool((scene.media.mtype == T.MEDIUM_GRID).any()):
                raise NotImplementedError(
                    "a grid medium with an envmap or with emission stays outside the fused "
                    "route, as in the reference; the composed volume path tracer's grid route "
                    "waits for ROADMAP Queue 1 item 8")
            raise ValueError(_envelope_message(scene, vpt))
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Renderer(device=None) renders on CUDA, which is not available; "
                               "pass device='cpu' to render on the CPU")
        self.scene: T.Scene = T.to_device(self.parsed.scene, self.device)
        self.camera: cam_mod.Camera = self.parsed.camera.to(self.device)
        self.seed = int(self.config.seed) + int(seed_offset)
        self.nee_candidates = int(nee_candidates)
        if max_lanes_per_call is None:
            max_lanes_per_call = int(os.environ.get("CUDA_PT_MAX_LANES_PER_CALL", "0"))
        self.max_lanes_per_call = int(max_lanes_per_call)
        self._pack = mk.make_pack(self.scene, node_fmt="w8", vpt=vpt)
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
        rng = qmc.make_state("pcg", self.seed, perm, idx)
        o, d, rng = cam_mod.generate_rays(self.camera, perm, rng)
        return mk.auto_trace(self._pack, self.md, o, d, rng, self.nee_candidates)

    def render_raw(self) -> torch.Tensor:
        """One 1-spp pass folded into the film; returns the pass (H, W, 3).
        Lanes run in Z-order screen blocks (mk.tile_swizzle); when H*W
        exceeds max_lanes_per_call the pass is split into row bands."""
        t0 = time.perf_counter()
        H, W = self.camera.height, self.camera.width
        idx = self.film.count
        budget = self.max_lanes_per_call
        if budget and H * W > budget:
            rows_per = max(budget // W, 1)
            parts = []
            for r0 in range(0, H, rows_per):
                rows = min(rows_per, H - r0)
                perm, inv = self._swizzle(W, rows)
                parts.append(self._trace_lanes(r0 * W + perm, idx)[inv])
            img = torch.cat(parts, dim=0).reshape(H, W, 3)
        else:
            perm, inv = self._swizzle(W, H)
            img = self._trace_lanes(perm, idx)[inv].reshape(H, W, 3)
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
            "traversal": "fused",
            "driver": mk.driver_of(self._pack),
            "device": str(self.device),
            "sampler": "pcg",
            "nee_candidates": self.nee_candidates,
            **self._pack.flags,
            "has_media": self._pack.has_media,
            "has_grid": self._pack.has_grid,
        }

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
