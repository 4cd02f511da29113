"""Camera intrinsic models: pinhole + radial distortion.

Port of sfm_tpu/geometry/cameras.py. One fixed layout covers PINHOLE,
SIMPLE_RADIAL and RADIAL:  intrinsics[..., 6] = [fx, fy, cx, cy, k1, k2].
"""

from __future__ import annotations

import torch

CAM_FX, CAM_FY, CAM_CX, CAM_CY, CAM_K1, CAM_K2 = 0, 1, 2, 3, 4, 5
NUM_INTRINSICS = 6


def make_intrinsics(fx, fy=None, cx=0.0, cy=0.0, k1=0.0, k2=0.0) -> torch.Tensor:
    """[fx, fy, cx, cy, k1, k2] float32 (fy defaults to fx)."""
    fy = fx if fy is None else fy
    return torch.tensor([fx, fy, cx, cy, k1, k2], dtype=torch.float32)


def distort(xy: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Apply radial distortion to normalized camera coords (..., 2)."""
    k1 = intr[..., CAM_K1]
    k2 = intr[..., CAM_K2]
    r2 = (xy * xy).sum(-1)
    scale = 1.0 + r2 * (k1 + r2 * k2)
    return xy * scale[..., None]


def undistort(xy_d: torch.Tensor, intr: torch.Tensor, num_iters: int = 8) -> torch.Tensor:
    """Invert radial distortion by a fixed number of fixed-point steps."""
    xy = xy_d
    k1 = intr[..., CAM_K1]
    k2 = intr[..., CAM_K2]
    for _ in range(num_iters):
        r2 = (xy * xy).sum(-1)
        scale = 1.0 + r2 * (k1 + r2 * k2)
        xy = xy_d / scale[..., None]
    return xy


def camera_to_pixel(xyz: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixel coords (..., 2), with the
    sign-preserving guarded perspective divide."""
    z = xyz[..., 2:3]
    z_safe = torch.where(z.abs() < 1e-8,
                         torch.where(z < 0, torch.full_like(z, -1e-8), torch.full_like(z, 1e-8)), z)
    xy = distort(xyz[..., :2] / z_safe, intr)
    f = torch.stack([intr[..., CAM_FX], intr[..., CAM_FY]], dim=-1)
    c = torch.stack([intr[..., CAM_CX], intr[..., CAM_CY]], dim=-1)
    return xy * f + c


def pixel_to_camera(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixel coords (..., 2) -> normalized (undistorted) camera coords (..., 2)."""
    f = torch.stack([intr[..., CAM_FX], intr[..., CAM_FY]], dim=-1)
    c = torch.stack([intr[..., CAM_CX], intr[..., CAM_CY]], dim=-1)
    return undistort((uv - c) / f, intr)
