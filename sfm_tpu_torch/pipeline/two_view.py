"""Two-view bootstrap reconstruction: relative pose + initial triangulation
+ two-view bundle adjustment, the end-to-end path for 2-image inputs
(port of sfm_tpu/pipeline/two_view.py)."""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ba import build_problem, dispatch_bundle_adjust, writeback
from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry.cameras import pixel_to_camera
from sfm_tpu_torch.geometry.projection import project
from sfm_tpu_torch.geometry.rotations import so3_exp
from sfm_tpu_torch.ops.solvers import triangulate_linear
from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
from sfm_tpu_torch.scene.state import Reconstruction


def triangulation_angles(X: np.ndarray, c1: np.ndarray, c2: np.ndarray) -> np.ndarray:
    """Angle at each point between the two camera rays, degrees."""
    r1 = X - c1
    r2 = X - c2
    cos = np.sum(r1 * r2, -1) / np.maximum(
        np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1), 1e-12)
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def bootstrap_two_view(feats: FeatureSet, graph: MatchGraph, edge: int, intrinsics: np.ndarray,
                       cfg: PipelineConfig, device: torch.device) -> Reconstruction:
    """Build a two-camera reconstruction from verified edge `edge`."""
    i, j = graph.pairs[edge]
    rvec_rel = graph.rvec[edge]
    tvec_rel = graph.tvec[edge]
    inl = graph.inlier[edge]
    ki = graph.idx_i[edge][inl]
    kj = graph.idx_j[edge][inl]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)

    uv1 = feats.xy[i][ki]
    uv2 = feats.xy[j][kj]
    intr1, intr2 = t(intrinsics[i]), t(intrinsics[j])
    x1 = pixel_to_camera(t(uv1), intr1)
    x2 = pixel_to_camera(t(uv2), intr2)
    R2 = so3_exp(t(rvec_rel))
    X_t = triangulate_linear(torch.eye(3, device=device), torch.zeros(3, device=device),
                             R2, t(tvec_rel), x1, x2)
    p1 = project(X_t, torch.zeros(3, device=device), torch.zeros(3, device=device), intr1).cpu().numpy()
    p2 = project(X_t, t(rvec_rel), t(tvec_rel), intr2).cpu().numpy()
    X = X_t.cpu().numpy()
    R2 = R2.cpu().numpy()

    # Filters: cheirality, triangulation angle, reprojection error.
    z1 = X[:, 2]
    z2 = (X @ R2.T + tvec_rel)[:, 2]
    ang = triangulation_angles(X, np.zeros(3), -R2.T @ tvec_rel)
    e1 = np.linalg.norm(p1 - uv1, axis=-1)
    e2 = np.linalg.norm(p2 - uv2, axis=-1)
    keep = ((z1 > 1e-4) & (z2 > 1e-4)
            & (ang >= cfg.engine.min_triangulation_angle_deg)
            & (e1 < cfg.engine.max_reprojection_error_px)
            & (e2 < cfg.engine.max_reprojection_error_px))

    B = len(feats.xy)
    rvecs = np.zeros((B, 3), np.float32)
    tvecs = np.zeros((B, 3), np.float32)
    registered = np.zeros(B, bool)
    rvecs[j] = rvec_rel
    tvecs[j] = tvec_rel
    registered[i] = registered[j] = True

    X = X[keep]
    ki, kj = ki[keep], kj[keep]
    uv1, uv2 = uv1[keep], uv2[keep]
    n = len(X)
    rec = Reconstruction(
        intrinsics=intrinsics.copy(),
        rvecs=rvecs,
        tvecs=tvecs,
        registered=registered,
        points=X.astype(np.float32),
        point_errors=((e1 + e2)[keep] / 2).astype(np.float32),
        point_valid=np.ones(n, bool),
        obs_point=np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32),
        obs_image=np.concatenate([np.full(n, i), np.full(n, j)]).astype(np.int32),
        obs_kp=np.concatenate([ki, kj]).astype(np.int32),
        obs_uv=np.concatenate([uv1, uv2]).astype(np.float32),
    )

    if n >= 8:
        prob, cams, pids = build_problem(rec, device=device)
        out, _ = dispatch_bundle_adjust(prob, cfg)
        writeback(rec, out, cams, pids)
    return rec
