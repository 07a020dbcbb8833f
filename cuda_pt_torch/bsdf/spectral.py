"""Wavelength -> RGB weights for the dispersion BSDF (port of
cuda_pt_tpu/bsdf/spectral.py): the multi-lobe Gaussian fit of the CIE 1931
matching functions (Wyman, Sloan & Shirley, JCGT 2013), converted to
linear sRGB and normalized so a uniform wavelength average is (1, 1, 1).

The port keeps its own copy of the constant tables. ``NORM`` is computed
at import in float32 NumPy over the same 2048 wavelengths as the
reference. The CUDA kernel receives ``XYZ_TO_SRGB`` and ``NORM`` as nvcc
-D flags (ops/cuda_build._defines) and evaluates the same fit."""

from __future__ import annotations

import numpy as np
import torch

WL_MIN = 360.0
WL_MAX = 830.0

XYZ_TO_SRGB = np.array(
    [
        [3.2404542, -1.5371385, -0.4985314],
        [-0.9692660, 1.8760108, 0.0415560],
        [0.0556434, -0.2040259, 1.0572252],
    ],
    np.float32,
)

# (alpha, mu, sigma below mu, sigma above mu) per Gaussian lobe
XYZ_LOBES = (
    ((1.056, 599.8, 37.9, 31.0), (0.362, 442.0, 16.0, 26.7), (-0.065, 501.1, 20.4, 26.2)),
    ((0.821, 568.8, 46.9, 40.5), (0.286, 530.9, 16.3, 31.1)),
    ((1.217, 437.0, 11.8, 36.0), (0.681, 459.0, 26.0, 13.8)),
)


def _xyz_fit(wl, where, exp):
    out = []
    for lobes in XYZ_LOBES:
        acc = None
        for alpha, mu, s1, s2 in lobes:
            t = (wl - mu) / where(wl < mu, s1, s2)
            g = alpha * exp(-0.5 * t * t)
            acc = g if acc is None else acc + g
        out.append(acc)
    return tuple(out)


def xyz_fit(wl: torch.Tensor):
    """CIE 1931 xbar, ybar, zbar at wavelength wl (nm)."""
    return _xyz_fit(wl, lambda c, a, b: torch.where(c, a, b), torch.exp)


def _compute_norm() -> np.ndarray:
    """Per-channel normalization: mean RGB over uniform wavelengths -> 1."""
    wl = np.linspace(WL_MIN, WL_MAX, 2048).astype(np.float32)
    x, y, z = _xyz_fit(wl, lambda c, a, b: np.where(c, np.float32(a), np.float32(b)),
                       lambda v: np.exp(v.astype(np.float32)))
    xyz = np.stack([x, y, z], axis=-1).astype(np.float32).mean(axis=0)
    rgb_mean = XYZ_TO_SRGB.astype(np.float64) @ xyz
    return (1.0 / np.maximum(rgb_mean, 1e-6)).astype(np.float32)


NORM = _compute_norm()


def wavelength_to_rgb(wl: torch.Tensor) -> torch.Tensor:
    """RGB weight (..., 3) of a uniformly sampled wavelength, mean-one
    normalized; negative components are kept (the film clips at export)."""
    x, y, z = xyz_fit(wl)
    xyz = torch.stack([x, y, z], dim=-1)
    m = torch.as_tensor(XYZ_TO_SRGB, device=wl.device)
    rgb = xyz @ m.T
    return rgb * torch.as_tensor(NORM, device=wl.device)
