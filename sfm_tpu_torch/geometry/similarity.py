"""Similarity-transform (Sim(3)) estimation: Umeyama alignment (port of
sfm_tpu/geometry/similarity.py).

EPnP takes its rotation from the weighted Procrustes solve; tests align
reconstructions to ground truth up to gauge freedom.
"""

from __future__ import annotations

import numpy as np
import torch


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 determinant (torch.linalg.det's first call on a GPU
    loads a cuSOLVER LU: most of a second)."""
    return (M[..., 0] * torch.linalg.cross(M[..., 1], M[..., 2])).sum(-1)


def umeyama(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor | None = None):
    """Least-squares similarity transform mapping src -> dst, batched over
    leading dimensions: src, dst [..., N, 3], w [..., N] -> (s [...],
    R [..., 3, 3], t [..., 3]) with dst ~= s * R @ src + t."""
    if w is None:
        w = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    wsum = w.sum(-1).clamp_min(1e-12)
    mu_s = (src * w[..., None]).sum(-2) / wsum[..., None]
    mu_d = (dst * w[..., None]).sum(-2) / wsum[..., None]
    sc = src - mu_s[..., None, :]
    dc = dst - mu_d[..., None, :]
    cov = (dc * w[..., None]).transpose(-1, -2) @ sc / wsum[..., None, None]   # [..., 3, 3]
    U, D, Vt = torch.linalg.svd(cov)
    det = _det3(U) * _det3(Vt)
    sign = torch.where(det < 0, -1.0, 1.0).to(src.dtype)
    diag = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], -1)
    R = (U * diag[..., None, :]) @ Vt
    var_s = (w[..., None] * sc * sc).sum((-1, -2)) / wsum
    s = (D * diag).sum(-1) / var_s.clamp_min(1e-12)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


def apply_sim3(s, R, t, x: torch.Tensor) -> torch.Tensor:
    return s * x @ R.T + t


def umeyama_np(src, dst, w=None):
    """Host-numpy umeyama (same math as `umeyama`), float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    w = np.ones(len(src)) if w is None else np.asarray(w, np.float64)
    wsum = max(float(w.sum()), 1e-12)
    mu_s = (src * w[:, None]).sum(0) / wsum
    mu_d = (dst * w[:, None]).sum(0) / wsum
    sc, dc = src - mu_s, dst - mu_d
    cov = (dc * w[:, None]).T @ sc / wsum
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = float((w[:, None] * sc * sc).sum()) / wsum
    s = float((D * np.diag(S)).sum()) / max(var_s, 1e-12)
    t = mu_d - s * R @ mu_s
    return s, R, t
