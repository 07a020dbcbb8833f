"""Drop-in PythonRenderer surface (port of cuda_pt_tpu/pyrender.py; the
design's python binding: render, variance, counter, avg_frame_time, info,
release). Arrays come back as NumPy float32.

The source is what api.Renderer takes: a ParsedScene, or the path of an
XML scene (scene/xml_parser.load_xml; override_res applies to it).
device_id picks cuda:<device_id> unless the keyword arguments give a
device; the other keyword arguments (sampler="sobol", traversal=, ...)
pass through to api.Renderer.
"""

from __future__ import annotations

import numpy as np

from .api import Renderer
from .core import film as film_mod


class PythonRenderer:
    def __init__(self, xml_path, device_id: int = 0, seed_offset: int = 0, override_res=None,
                 **renderer_kw):
        renderer_kw.setdefault("device", f"cuda:{int(device_id)}")
        self._r = Renderer(xml_path, seed_offset=seed_offset, override_res=override_res,
                           **renderer_kw)

    def render(self) -> np.ndarray:
        """One 1-spp pass; returns the accumulated (H, W, 4) float32 image:
        RGB and the accumulated weight in alpha."""
        self._r.render_raw()
        film = self._r.film
        return np.concatenate([film.mean.cpu().numpy(), film.weight.cpu().numpy()[..., None]],
                              axis=-1).astype(np.float32)

    def variance(self) -> np.ndarray:
        """(H, W, 1) float32 per-pixel luminance variance."""
        return film_mod.variance(self._r.film).cpu().numpy()[..., None].astype(np.float32)

    def counter(self) -> int:
        return self._r.counter()

    def avg_frame_time(self) -> float:
        return self._r.avg_frame_time()

    def info(self) -> dict:
        return self._r.info()

    def release(self):
        self._r.release()
