"""Multi-view triangulation: batched masked DLT (port of
sfm_tpu/ops/triangulate.py).

Each track triangulates from up to V observations (padded + masked). The
per-track 4x4 normal matrix is a masked sum of per-observation rank-2
contributions, then one batched eigh. Filters (cheirality, min
triangulation angle, max reprojection error) are returned as masks, never
as shape changes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry.rotations import so3_exp


class TriangulationResult(NamedTuple):
    points: torch.Tensor         # [T, 3]
    valid: torch.Tensor          # [T] passed all filters
    max_angle_deg: torch.Tensor  # [T] best pairwise ray angle
    max_error: torch.Tensor      # [T] worst reprojection error among obs (normalized coords)


def triangulate_tracks(
    rvecs: torch.Tensor,     # [T, V, 3] world->cam pose per observation slot
    tvecs: torch.Tensor,     # [T, V, 3]
    xy: torch.Tensor,        # [T, V, 2] normalized camera coords
    mask: torch.Tensor,      # [T, V] observation validity
    min_angle_deg: float = 1.5,
    max_error_norm: float = 0.01,
) -> TriangulationResult:
    R = so3_exp(rvecs)                                        # [T, V, 3, 3]
    P = torch.cat([R, tvecs[..., None]], dim=-1)              # [T, V, 3, 4]

    # DLT rows: x*P2 - P0, y*P2 - P1.
    r0 = xy[..., 0:1] * P[..., 2, :] - P[..., 0, :]           # [T, V, 4]
    r1 = xy[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.stack([r0, r1], dim=2) * mask[..., None, None].to(xy.dtype)   # [T, V, 2, 4]
    AtA = torch.einsum("tvik,tvil->tkl", A, A)                # [T, 4, 4]
    # Condition: normalize by trace so eigh is well-scaled.
    tr = AtA.diagonal(dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(4, dtype=xy.dtype, device=xy.device)
    AtA = AtA / tr.clamp_min(1e-12)[:, None, None] + 1e-12 * eye
    _, V4 = torch.linalg.eigh(AtA)
    Xh = V4[..., 0]
    w = Xh[:, 3:4]
    X = Xh[:, :3] / torch.where(w.abs() < 1e-9, torch.full_like(w, 1e-9), w)   # [T, 3]

    # Filters.
    xc = torch.einsum("tvij,tj->tvi", R, X) + tvecs           # [T, V, 3]
    z = xc[..., 2]
    cheiral = torch.where(mask, z > 1e-4, True).all(-1) & (mask.sum(-1) >= 2)

    zs = z[..., None]
    proj = xc[..., :2] / torch.where(zs.abs() < 1e-8, torch.full_like(zs, 1e-8), zs)
    err = torch.sqrt(((proj - xy) ** 2).sum(-1))
    max_err = torch.where(mask, err, torch.zeros_like(err)).amax(-1)

    # Max pairwise ray angle via camera centers.
    centers = -torch.einsum("tvji,tvj->tvi", R, tvecs)        # [T, V, 3]
    rays = X[:, None, :] - centers
    rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True).clamp_min(1e-12)
    cosang = torch.einsum("tvi,twi->tvw", rays, rays)
    pair_mask = mask[:, :, None] & mask[:, None, :]
    cosang = torch.where(pair_mask, cosang, torch.ones_like(cosang))
    max_angle = torch.rad2deg(torch.arccos(cosang.amin((1, 2)).clamp(-1.0, 1.0)))

    valid = cheiral & (max_angle >= min_angle_deg) & (max_err < max_error_norm)
    return TriangulationResult(points=X, valid=valid, max_angle_deg=max_angle, max_error=max_err)
