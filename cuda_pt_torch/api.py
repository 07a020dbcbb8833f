"""High-level renderer API (port of cuda_pt_tpu/api.py, MEGAKERNEL_PT).

One stateful Renderer over a compiled scene: the film and the camera stay
on the render device between passes, and every pass runs the path loop
through the whole-path megakernel (ops/megakernel.py): the CUDA kernel on
a CUDA device, its plain PyTorch version on the CPU. ``device=None`` means
CUDA and raises where CUDA is absent; pass ``device="cpu"`` to render on
the CPU.

Still to port (ROADMAP Queue 1): other renderer families, render_adaptive,
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
    RendererType.VOLUME_PT: "item 8 (media and the volume path tracer)",
    RendererType.MEGAKERNEL_LT: "item 9 (models/light_tracer.py)",
    RendererType.DEPTH: "item 10 (models/debug_renderers.py)",
    RendererType.BVH_COST: "item 10 (models/debug_renderers.py)",
}


class Renderer:
    """Stateful renderer over a compiled scene."""

    def __init__(self, source, renderer: RendererType | None = None, seed_offset: int = 0,
                 nee_candidates: int = 1, max_lanes_per_call: int | None = None, device=None):
        """source: a ParsedScene (scene, camera, RenderingConfig) or an XML
        path (raises until the parser is ported).

        nee_candidates: M > 1 = RIS light sampling (M candidates, one
        shadow ray). max_lanes_per_call: split a pass into full-width row
        bands of at most this many lanes, one kernel launch each (0 = one
        launch per pass; default from CUDA_PT_MAX_LANES_PER_CALL, else 0).
        Bands are bit-identical to the unbanded pass."""
        self.parsed: ParsedScene = load_xml(source) if isinstance(source, str) else source
        self.config = self.parsed.config
        self.rtype = RendererType(renderer or self.config.renderer)
        if self.rtype != RendererType.MEGAKERNEL_PT:
            raise NotImplementedError(
                f"renderer {self.rtype.value!r} waits for ROADMAP Queue 1 {_WAITING[self.rtype]}")
        self.md: MaxDepthParams = self.config.md
        if not mk.megakernel_ok(self.parsed.scene, self.md):
            raise ValueError("scene outside the fused-megakernel envelope "
                             "(see cuda_pt_torch/ops/megakernel.megakernel_ok)")
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
        self._pack = mk.make_pack(self.scene, node_fmt="w8")
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
            "device": str(self.device),
            "sampler": "pcg",
            "nee_candidates": self.nee_candidates,
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
