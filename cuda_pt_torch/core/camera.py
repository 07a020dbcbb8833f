"""Perspective / orthographic / thin-lens camera (port of core/camera.py).

A dataclass of tensors; ray generation is batched over all lanes. Matrix
products are written as explicit column sums so the arithmetic is the same
on every device (the JAX reference lets XLA pick the order, hence the 1-ulp
tolerance in the tests).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import math as vm
from . import rng as prng
from . import sampling


@dataclasses.dataclass
class Camera:
    R: torch.Tensor  # (3, 3) float32, columns = (right, up, forward)
    t: torch.Tensor  # (3,) position
    focal: torch.Tensor  # () focal length in pixels
    aperture: torch.Tensor  # () lens radius; 0 = pinhole
    focal_dist: torch.Tensor  # () focus distance; 0 = orthographic
    hsign: torch.Tensor  # () -1 when hflip else +1
    width: int = 512
    height: int = 512

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, R=self.R.to(device), t=self.t.to(device), focal=self.focal.to(device),
            aperture=self.aperture.to(device), focal_dist=self.focal_dist.to(device),
            hsign=self.hsign.to(device))


def _lookat(origin, target, up):
    origin = np.asarray(origin, np.float64)
    forward = np.asarray(target, np.float64) - origin
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, np.float64)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    true_up = np.cross(forward, right)
    R = np.stack([right, true_up, forward], axis=1)
    return R.astype(np.float32), origin.astype(np.float32)


def make_camera(origin, target, up=(0.0, 1.0, 0.0), fov=40.0, width=512, height=512,
                hflip=False, aperture=0.0, focal_dist=-1.0, device="cpu") -> Camera:
    """Mitsuba-style lookat + horizontal fov (degrees). focal_dist < 0 ->
    pinhole, 0 -> orthographic, > 0 -> thin lens focused at that distance."""
    R, t = _lookat(origin, target, up)
    focal_px = 0.5 * float(width) / np.tan(0.5 * np.deg2rad(float(fov)))

    def f32(x):
        return torch.tensor(np.float32(x), device=device)

    return Camera(
        R=torch.as_tensor(R, device=device),
        t=torch.as_tensor(t, device=device),
        focal=f32(focal_px),
        aperture=f32(max(float(aperture), 0.0)),
        focal_dist=f32(focal_dist),
        hsign=f32(-1.0 if hflip else 1.0),
        width=int(width),
        height=int(height),
    )


def _rotate(v: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """v @ R.T for (..., 3) v, as an explicit sum over R's columns."""
    return v[..., 0:1] * R[:, 0] + v[..., 1:2] * R[:, 1] + v[..., 2:3] * R[:, 2]


def generate_rays(cam: Camera, pixel_idx: torch.Tensor, rng_state: torch.Tensor):
    """One jittered primary ray per flat pixel id (row-major y * W + x).
    Consumes two pcg advances (pixel jitter, then lens), always.
    Returns (o (B,3), d (B,3), new_rng_state)."""
    px = (pixel_idx % cam.width).to(torch.float32)
    py = torch.div(pixel_idx, cam.width, rounding_mode="floor").to(torch.float32)
    u, rng_state = prng.next2d(rng_state)
    x = cam.hsign * (px + u[..., 0] - 0.5 * cam.width)
    y = 0.5 * cam.height - (py + u[..., 1])
    d_cam = torch.stack([x, y, cam.focal.expand(x.shape)], dim=-1)

    is_ortho = cam.focal_dist == 0.0
    d_world = vm.normalize_rounded(_rotate(d_cam, cam.R))
    o_world = cam.t.expand(d_world.shape)
    ortho_off = torch.stack([x / cam.focal, y / cam.focal, torch.zeros_like(x)], dim=-1)
    o_ortho = cam.t + _rotate(ortho_off, cam.R)
    d_ortho = cam.R[:, 2].expand(d_world.shape)
    o = torch.where(is_ortho, o_ortho, o_world)
    d = torch.where(is_ortho, d_ortho, d_world)

    use_lens = (cam.aperture > 0.0) & (cam.focal_dist > 0.0)
    u2, rng_state = prng.next2d(rng_state)
    lens_uv = sampling.concentric_disk(u2) * cam.aperture
    z = torch.clamp(d_cam[..., 2:3], min=1e-6)
    p_focus_cam = d_cam * (cam.focal_dist / z)
    lens_cam = torch.cat([lens_uv, torch.zeros_like(lens_uv[..., :1])], dim=-1)
    o_lens = cam.t + _rotate(lens_cam, cam.R)
    d_lens = vm.normalize_rounded(_rotate(p_focus_cam - lens_cam, cam.R))
    o = torch.where(use_lens, o_lens, o)
    d = torch.where(use_lens, d_lens, d)
    return o, d, rng_state


def splat_pixel(cam: Camera, p: torch.Tensor):
    """Project world points (B, 3) onto the film (the light tracer's camera
    connection). Returns (px, py, valid): continuous pixel coordinates and
    whether the point lies in front of the camera and inside the film;
    hsign is applied as in generate_rays. Reference: core/camera.py:125."""
    rel = p - cam.t
    # rel @ R: the point in the camera's (right, up, forward) frame
    x_c, y_c, z = (vm.dot(rel, cam.R[:, j]) for j in range(3))
    inv_z = 1.0 / torch.clamp(z, min=1e-5)
    x = x_c * cam.focal * inv_z * cam.hsign
    y = y_c * cam.focal * inv_z
    px = x + 0.5 * cam.width
    py = 0.5 * cam.height - y
    valid = (z > 1e-5) & (px >= 0.0) & (px < cam.width) & (py >= 0.0) & (py < cam.height)
    return px, py, valid


def _matmul3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B of two (3, 3) matrices as an explicit sum: full f32 on every
    device, whatever the process's TF32 setting."""
    return (A[:, :, None] * B[None, :, :]).sum(dim=1)


def move(cam: Camera, delta_local) -> Camera:
    """Translate in the camera frame (x right, y up, z forward): the
    viewer's WASD. A new Camera on the camera's device."""
    delta = torch.as_tensor(delta_local, dtype=torch.float32, device=cam.t.device)
    return dataclasses.replace(cam, t=cam.t + _rotate(delta, cam.R))


def rotate(cam: Camera, yaw: float, pitch: float) -> Camera:
    """Yaw about world up, then pitch about the camera's right axis
    (Rodrigues): the viewer's mouse drag. A new Camera on the camera's
    device, in float32."""
    dev = cam.R.device
    y, p = (torch.tensor(float(a), dtype=torch.float32, device=dev) for a in (yaw, pitch))
    cy, sy, cp, sp = torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p)
    zero, one = torch.zeros((), device=dev), torch.ones((), device=dev)
    Ry = torch.stack([torch.stack([cy, zero, sy]), torch.stack([zero, one, zero]),
                      torch.stack([-sy, zero, cy])])
    r = cam.R[:, 0]
    K = torch.stack([torch.stack([zero, -r[2], r[1]]), torch.stack([r[2], zero, -r[0]]),
                     torch.stack([-r[1], r[0], zero])])
    Rp = torch.eye(3, device=dev) + sp * K + (1.0 - cp) * _matmul3(K, K)
    return dataclasses.replace(cam, R=_matmul3(_matmul3(Rp, Ry), cam.R))
