"""Film: sample accumulation, online Welford variance, gamma and ACES
export, checkpoints (port of core/film.py). The film lives on the render
device between passes; ``accumulate`` returns a new Film (the tensors are
not updated in place, so a caller may keep the previous film). A
checkpoint is the reference's .npz (mean, m2, weight as float32, count as
an int32 scalar), so either package loads the other's."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Film:
    mean: torch.Tensor  # (H, W, 3) running mean radiance
    m2: torch.Tensor  # (H, W) running M2 of luminance (Welford)
    weight: torch.Tensor  # (H, W) accumulated sample weight
    count: int  # accumulated passes


def make_film(height: int, width: int, device="cpu") -> Film:
    return Film(
        mean=torch.zeros((height, width, 3), dtype=torch.float32, device=device),
        m2=torch.zeros((height, width), dtype=torch.float32, device=device),
        weight=torch.zeros((height, width), dtype=torch.float32, device=device),
        count=0,
    )


def _lum(rgb: torch.Tensor) -> torch.Tensor:
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]


def accumulate(film: Film, radiance: torch.Tensor) -> Film:
    """Fold one 1-spp pass (H, W, 3) into the film with Welford updates."""
    n = film.count + 1
    lum = _lum(radiance)
    old_lum = _lum(film.mean)
    delta = lum - old_lum
    nf = float(np.float32(n))
    mean = film.mean + (radiance - film.mean) / nf
    new_lum = old_lum + delta / nf
    m2 = film.m2 + delta * (lum - new_lum)
    return Film(mean=mean, m2=m2, weight=film.weight + 1.0, count=n)


def variance(film: Film) -> torch.Tensor:
    """Per-pixel sample variance of luminance (H, W)."""
    return film.m2 / float(max(film.count - 1, 1))


def to_srgb(mean: torch.Tensor, gamma: bool = True, tonemap: str = "gamma") -> torch.Tensor:
    """Tonemap linear radiance to [0, 1]: tonemap="gamma" clips, "aces"
    rolls highlights off by Narkowicz's ACES fit first; then the
    reference's gamma 1/2.1."""
    img = torch.clamp(mean, min=0.0)
    if tonemap == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        img = (img * (a * img + b)) / (img * (c * img + d) + e)
    if gamma:
        img = torch.pow(torch.clamp(img, 0.0, 1e9), 1.0 / 2.1)
    return torch.clamp(img, 0.0, 1.0)


def save_checkpoint(film: Film, path: str):
    """Write the film to path (np.savez: ".npz" is appended when missing),
    so a render resumes at pass granularity."""
    np.savez(path, mean=film.mean.detach().cpu().numpy(), m2=film.m2.detach().cpu().numpy(),
             weight=film.weight.detach().cpu().numpy(), count=np.asarray(film.count, np.int32))


def load_checkpoint(path: str, device="cpu") -> Film:
    """The film of a checkpoint, on device."""
    z = np.load(path)
    return Film(mean=torch.as_tensor(z["mean"], device=device),
                m2=torch.as_tensor(z["m2"], device=device),
                weight=torch.as_tensor(z["weight"], device=device), count=int(z["count"]))


def export_numpy(film: Film, gamma: bool = True) -> np.ndarray:
    """Tonemapped image on the host as uint8 (H, W, 3)."""
    img = to_srgb(film.mean, gamma=gamma).cpu().numpy()
    return (img * 255.0 + 0.5).astype(np.uint8)
