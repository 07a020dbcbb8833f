"""Edge-avoiding à-trous wavelet denoiser (Dammertz et al. 2010; port of
cuda_pt_tpu/models/denoise.py).

Filters the beauty pass with the first-hit AOVs of
models/debug_renderers.render_aovs: N dilated 5x5 B3-spline iterations
whose per-tap weights fall off with the colour, normal and depth
differences. Each tap is a ``torch.roll`` and elementwise weights; taps
that wrap around the border are masked. The signal is demodulated by the
albedo (where the albedo is meaningful) and the emission is taken out
before filtering and added back after. With a per-pixel variance of the
mean the colour test is relative to each pixel's noise (3x3-prefiltered
and carried through the iterations), and the result is blended back
toward the raw estimate where the filter moved a pixel far beyond its
noise (a shrinkage by _SHRINK_C times the variance).
"""

from __future__ import annotations

import torch

from ..core import math as vm

# B3 spline coefficients of the 5-tap 1-D kernel (separable 5x5)
_B3 = (1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16)
# noise multiplier of the shrinkage blend (the reference's swept value)
_SHRINK_C = 4.0


def atrous_denoise(beauty: torch.Tensor, aovs: dict, iterations: int = 3,
                   sigma_color: float = 4.0, sigma_normal: float = 128.0,
                   sigma_depth: float = 1.0, variance: torch.Tensor | None = None) -> torch.Tensor:
    """Denoised (H, W, 3) image of beauty (H, W, 3) with aovs (albedo,
    normal, depth and optionally emission, from render_aovs). sigma_color
    is in luminance of the filtered signal, sigma_normal the exponent on
    n . n', sigma_depth relative to the image's depth range. variance (H,
    W), the variance of the mean, switches on the variance guidance."""
    raw_albedo = aovs["albedo"]
    # demodulate only where the albedo is meaningful: near-black albedo
    # (emitters, untinted mirrors) filters in radiance
    albedo = torch.where((raw_albedo > 0.01).all(dim=-1, keepdim=True), raw_albedo, 1.0)
    emission = aovs.get("emission")
    normal = aovs["normal"]
    depth = aovs["depth"]
    z = depth / torch.clamp(depth.amax() - depth.amin(), min=1e-6)

    signal = beauty
    if emission is not None:
        # Le stays out of the filter; the residual is not clamped, so the
        # noise around emitters keeps its sign
        signal = signal - emission
    signal = signal / albedo

    var = None
    if variance is not None:
        # demodulation scales the beauty's variance by 1 / lum(albedo)^2
        alb_lum = torch.clamp(vm.luminance(albedo), min=1e-3)
        var = torch.clamp(variance, min=0.0) / (alb_lum * alb_lum)

    taps = [(dy, dx, _B3[dy + 2] * _B3[dx + 2]) for dy in range(-2, 3) for dx in range(-2, 3)]
    H, W = signal.shape[:2]
    yy = torch.arange(H, device=signal.device)[:, None]
    xx = torch.arange(W, device=signal.device)[None, :]

    for it in range(iterations):
        step = 1 << it
        lum_c = vm.luminance(signal)
        if var is not None:
            # 3x3 prefilter of the variance (SVGF's colour weight)
            g = sum(torch.roll(var, (a, b), (0, 1)) for a in (-1, 0, 1) for b in (-1, 0, 1)) / 9.0
            denom_c = sigma_color * torch.sqrt(torch.clamp(g, min=0.0)) + 1e-4
        else:
            denom_c = sigma_color
        acc = torch.zeros_like(signal)
        vacc = torch.zeros(signal.shape[:2], dtype=signal.dtype, device=signal.device)
        wsum = torch.zeros(signal.shape[:2], dtype=signal.dtype, device=signal.device)
        for dy, dx, h in taps:
            sh = (dy * step, dx * step)
            s_q = torch.roll(signal, sh, (0, 1))
            n_q = torch.roll(normal, sh, (0, 1))
            z_q = torch.roll(z, sh, (0, 1))
            l_q = torch.roll(lum_c, sh, (0, 1))
            src_y = yy - sh[0]
            src_x = xx - sh[1]
            inside = (src_y >= 0) & (src_y < H) & (src_x >= 0) & (src_x < W)
            w_c = torch.exp(-torch.abs(l_q - lum_c) / denom_c)
            w_n = torch.clamp(torch.sum(n_q * normal, dim=-1), min=0.0) ** sigma_normal
            w_z = torch.exp(-torch.abs(z_q - z) / sigma_depth)
            w = h * w_c * w_n * w_z * inside
            acc = acc + s_q * w[..., None]
            if var is not None:
                vacc = vacc + torch.roll(var, sh, (0, 1)) * w * w
            wsum = wsum + w
        signal = acc / torch.clamp(wsum, min=1e-8)[..., None]
        if var is not None:
            var = vacc / torch.clamp(wsum * wsum, min=1e-12)

    out = signal * albedo
    if emission is not None:
        out = out + emission
    if variance is not None:
        # shrink toward the raw estimate where the filter's move exceeds
        # the pixel's own noise (mostly bias there)
        d_lum = vm.luminance(out - beauty)
        nv = _SHRINK_C * torch.clamp(variance, min=0.0)
        k = nv / (nv + d_lum * d_lum + 1e-12)
        out = beauty + k[..., None] * (out - beauty)
    return out
