"""Build the port's Scene and Camera from flat NumPy arrays.

The arrays are keyed by field path (``"geom.p0"``, ``"bvh.node_skip"``,
``"env_emitter"``, ...), so any producer that can flatten a compiled scene
into a dict — the tests flatten the JAX reference's Scene this way — hands
both packages the same arrays. Keys for the optional ``wide`` tree and
unknown keys are ignored; every field of the port's tables is required.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import camera as cam_mod
from . import types as T

_TABLES = {
    "geom": T.Geometry,
    "objects": T.ObjectTable,
    "emitters": T.EmitterTable,
    "bsdfs": T.BSDFTable,
    "textures": T.TextureAtlas,
    "media": T.MediumTable,
    "grids": T.GridMediumData,
    "bvh": T.BVHArrays,
    "env_importance": T.EnvImportance,
}
_STATIC = ("max_leaf", "max_stack")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.as_tensor(np.array(a, order="C"), device=device)  # a writable copy


def scene_from_numpy(arrays: dict, device="cpu") -> T.Scene:
    """Scene from {"<table>.<field>": ndarray, "env_emitter": int, ...}.
    ``present_bsdfs`` is taken from the key of that name when given, else
    derived from ``bsdfs.btype``; ``bvh.max_leaf`` likewise from the
    node counts."""
    tables = {}
    for name, cls in _TABLES.items():
        kw = {}
        for f in dataclasses.fields(cls):
            key = f"{name}.{f.name}"
            if f.name in _STATIC:
                continue
            kw[f.name] = _tensor(arrays[key], device)
        tables[name] = cls(**kw)
    counts = np.asarray(arrays["bvh.node_count"])
    tables["bvh"].max_leaf = int(arrays.get("bvh.max_leaf", counts.max(initial=1)))
    present = arrays.get("present_bsdfs")
    if present is None:
        present = sorted({int(x) for x in np.asarray(arrays["bsdfs.btype"])})
    return T.Scene(
        env_emitter=int(np.asarray(arrays["env_emitter"])),
        cam_medium=int(np.asarray(arrays["cam_medium"])),
        num_emitters=int(np.asarray(arrays["num_emitters"])),
        present_bsdfs=tuple(int(x) for x in present),
        **tables,
    )


def camera_from_numpy(arrays: dict, device="cpu") -> cam_mod.Camera:
    """Camera from {"R", "t", "focal", "aperture", "focal_dist", "hsign",
    "width", "height"}."""
    def f32(k):
        return torch.as_tensor(np.array(arrays[k], np.float32), device=device)

    return cam_mod.Camera(
        R=f32("R"), t=f32("t"), focal=f32("focal"), aperture=f32("aperture"),
        focal_dist=f32("focal_dist"), hsign=f32("hsign"),
        width=int(arrays["width"]), height=int(arrays["height"]))
