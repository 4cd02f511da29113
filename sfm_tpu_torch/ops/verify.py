"""Two-view geometric verification (port of sfm_tpu/ops/verify.py).

For a block of pairs (leading axis P): essential-matrix RANSAC on
normalized coordinates with LO refits, homography RANSAC on pixels (the H/E
planar-degeneracy statistic), the degeneracy gate (planar pairs take the
pose from the homography decomposition; pure rotations keep their
correspondences with pose_ok=False), and the relative pose from the
cheirality vote otherwise. Minimal sets come in as indices (see
ops/ransac.draw_minimal_sets).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import RansacConfig
from sfm_tpu_torch.geometry.cameras import pixel_to_camera
from sfm_tpu_torch.geometry.rotations import matrix_to_aa
from sfm_tpu_torch.ops import solvers
from sfm_tpu_torch.ops import ransac as ransac_ops


class TwoViewGeometry(NamedTuple):
    """Verified two-view geometry for a block of pairs. Leading axis = pairs."""

    rvec: torch.Tensor           # [P, 3] relative pose (cam_i -> cam_j)
    tvec: torch.Tensor           # [P, 3] unit-norm translation
    inliers: torch.Tensor        # [P, M] bool
    num_inliers: torch.Tensor    # [P]
    num_h_inliers: torch.Tensor  # [P]
    ok: torch.Tensor             # [P]
    pose_ok: torch.Tensor        # [P] False for rotation-only edges
    E: torch.Tensor              # [P, 3, 3]


def _kmat(intr: torch.Tensor) -> torch.Tensor:
    zero, one = torch.zeros_like(intr[..., 0]), torch.ones_like(intr[..., 0])
    return torch.stack([torch.stack([intr[..., 0], zero, intr[..., 2]], -1),
                        torch.stack([zero, intr[..., 1], intr[..., 3]], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _kinv(intr: torch.Tensor) -> torch.Tensor:
    zero, one = torch.zeros_like(intr[..., 0]), torch.ones_like(intr[..., 0])
    fx, fy, cx, cy = intr[..., 0], intr[..., 1], intr[..., 2], intr[..., 3]
    return torch.stack([torch.stack([1.0 / fx, zero, -cx / fx], -1),
                        torch.stack([zero, 1.0 / fy, -cy / fy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _polar_rotation(H: torch.Tensor) -> torch.Tensor:
    """Nearest rotation U diag(1, 1, det(U V^T)) V^T to H [..., 3, 3], from
    the symmetric eigendecomposition of H^T H (a LAPACK call, as the JAX
    package's jnp.linalg.svd here is)."""
    evals, V = torch.linalg.eigh(H.transpose(-1, -2) @ H)        # ascending
    s = torch.sqrt(evals.clamp_min(0.0)).clamp_min(1e-20)
    U = (H @ V) / s[..., None, :]
    Q = U @ V.transpose(-1, -2)
    det = (Q[..., 0] * torch.linalg.cross(Q[..., 1], Q[..., 2])).sum(-1)     # closed-form 3x3 det
    c = torch.stack([det, torch.ones_like(det), torch.ones_like(det)], -1)   # smallest first
    return (U * c[..., None, :]) @ V.transpose(-1, -2)


def verify_pair(idx_e: torch.Tensor, idx_h: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                mask: torch.Tensor, intr1: torch.Tensor, intr2: torch.Tensor,
                cfg: RansacConfig) -> TwoViewGeometry:
    """Verify P pairs: minimal sets idx_e [P, B, 8] and idx_h [P, B//2, 4],
    matched pixels uv1/uv2 [P, M, 2], mask [P, M], intrinsics [P, 6]."""
    if cfg.model != "essential":
        raise NotImplementedError(
            "ransac.model='fundamental' is not ported yet (ROADMAP.md queue 1 item 4: the F-RANSAC uncalibrated path)")
    x1 = pixel_to_camera(uv1, intr1[:, None, :])
    x2 = pixel_to_camera(uv2, intr2[:, None, :])
    f1 = (intr1[:, 0] + intr1[:, 1]) * 0.5
    f2 = (intr2[:, 0] + intr2[:, 1]) * 0.5
    thr_norm = (cfg.error_threshold_px / f1) * (cfg.error_threshold_px / f2)
    thr_px = cfg.error_threshold_px ** 2

    res_e = ransac_ops.ransac(idx_e, x1, x2, mask,
                   solver=lambda a, b: solvers.essential_minimal(a, b, gn_iters=4),
                   error_fn=solvers.sampson_error,
                   threshold_sq=thr_norm, min_inliers=cfg.min_inliers)
    E, inl = ransac_ops.irls_refit(res_e.model, x1, x2, mask,
                        fit_fn=lambda a, b, w: solvers.essential_minimal(a, b, w),
                        error_fn=solvers.sampson_error,
                        threshold_sq=thr_norm, iters=cfg.refine_iters)
    n_e = inl.sum(-1)

    res_h = ransac_ops.ransac(idx_h, uv1, uv2, mask,
                   solver=solvers.homography_4pt, error_fn=solvers.homography_error,
                   threshold_sq=thr_px, min_inliers=cfg.min_inliers)
    H, inl_h = ransac_ops.irls_refit(res_h.model, uv1, uv2, mask,
                          fit_fn=solvers.homography_4pt, error_fn=solvers.homography_error,
                          threshold_sq=thr_px, iters=2)
    n_h = inl_h.sum(-1)

    R, t, n_cheiral = solvers.decompose_essential(E, x1, x2, inl)
    ok_e = (n_e >= cfg.min_inliers) & (n_cheiral >= torch.clamp_min(n_e // 2, 1))

    h_ratio = n_h.float() / n_e.float().clamp_min(1.0)
    planar = h_ratio >= cfg.degenerate_h_ratio
    Hn = _kinv(intr2) @ H @ _kmat(intr1)
    R_h, t_h, _n_plane, h_votes, h_valid = solvers.decompose_homography(Hn, x1, x2, mask)
    ok_h_pose = h_valid & (h_votes >= torch.clamp_min(n_h // 2, 1))
    ok_h = (n_h >= cfg.min_inliers) & ok_h_pose

    rot_only = planar & (n_h >= cfg.min_inliers) & ~ok_h_pose
    x1_h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)
    x2_h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)
    h_dot = (mask * (x2_h * (x1_h @ Hn.transpose(-1, -2))).sum(-1)).sum(-1)
    Hn_signed = Hn * torch.where(h_dot < 0, -1.0, 1.0)[:, None, None]
    R_rot = _polar_rotation(Hn_signed)

    use_h = planar & ok_h
    R = torch.where(use_h[:, None, None], R_h, torch.where(rot_only[:, None, None], R_rot, R))
    t = torch.where(use_h[:, None], t_h, t)
    inl = torch.where((use_h | rot_only)[:, None], inl_h, inl)
    n_out = torch.where(use_h | rot_only, n_h, n_e)
    ok = torch.where(planar, ok_h | rot_only, ok_e)
    pose_ok = ok & ~rot_only
    rvec = matrix_to_aa(R)
    E = torch.where(use_h[:, None, None], solvers.essential_from_rt(torch.cat([rvec, t], -1)), E)
    return TwoViewGeometry(rvec=rvec, tvec=t, inliers=inl, num_inliers=n_out, num_h_inliers=n_h,
                           ok=ok, pose_ok=pose_ok, E=E)


def verify_block(pair_index0: int, uv1, uv2, mask, intr1, intr2, cfg: RansacConfig,
                 seed: int) -> TwoViewGeometry:
    """Draw each pair's minimal sets (keyed by its global pair index
    pair_index0 + p) and verify the block."""
    draw = ransac_ops.draw_minimal_sets
    B = cfg.num_hypotheses
    idx_e = torch.stack([draw(seed, pair_index0 + p, mask[p], B, 8, "e")
                         for p in range(mask.shape[0])])
    idx_h = torch.stack([draw(seed, pair_index0 + p, mask[p], B // 2, 4, "h")
                         for p in range(mask.shape[0])])
    return verify_pair(idx_e, idx_h, uv1, uv2, mask, intr1, intr2, cfg)
