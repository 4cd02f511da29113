"""Absolute pose (PnP) for next-view registration (port of sfm_tpu/ops/pnp.py).

Batched EPnP (the linear N=1 nullspace case) followed by a short
Gauss-Newton polish on (rvec, t), inside fixed-size RANSAC with IRLS
refits. All functions work in NORMALIZED camera coordinates (intrinsics
applied by the caller) and are batched over leading dimensions (the JAX
package vmapped them). The Gauss-Newton Jacobian is closed-form (JAX:
jacfwd): d(x_c / z) / d(rvec, t) through the SO(3) right Jacobian, as in
ba/core.residual_jac_analytic.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.rotations import matrix_to_aa, so3_exp, so3_hat, so3_right_jacobian
from sfm_tpu_torch.geometry.similarity import umeyama
from sfm_tpu_torch.ops import ransac as ransac_ops
from sfm_tpu_torch.ops.solvers import _inv3


def pnp_reprojection_error(pose: torch.Tensor, X: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Squared reprojection error in normalized coords: pose [..., 6]
    ([rvec, t]), X [..., M, 3], uv [..., M, 2] -> [..., M]. Points behind
    the camera get a large error (they must not count as inliers)."""
    R = so3_exp(pose[..., :3])
    xc = X @ R.transpose(-1, -2) + pose[..., None, 3:]
    z = xc[..., 2]
    zs = torch.where(z.abs() < 1e-8, torch.full_like(z, 1e-8), z)
    err = ((xc[..., :2] / zs[..., None] - uv) ** 2).sum(-1)
    return torch.where(z > 1e-6, err, torch.full_like(err, 1e6))


def _gn_residual_jacobian(pose, X, uv, w):
    """Weighted residuals r [..., k, 2] of the GN polish and d r / d pose
    [..., k, 2, 6]. The depth guard (|z| < 1e-6 -> 1e-6) is a constant, so
    its derivative is zero, as under jacfwd."""
    rvec = pose[..., :3]
    R = so3_exp(rvec)
    xc = X @ R.transpose(-1, -2) + pose[..., None, 3:]
    z = xc[..., 2]
    guard = z.abs() < 1e-6
    zs = torch.where(guard, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / zs
    x, y = xc[..., 0] * inv_z, xc[..., 1] * inv_z
    r = (torch.stack([x, y], -1) - uv) * w[..., None]
    dz = torch.where(guard, torch.zeros_like(z), torch.ones_like(z))
    zero = torch.zeros_like(x)
    A = torch.stack([torch.stack([inv_z, zero, -x * inv_z * dz], -1),
                     torch.stack([zero, inv_z, -y * inv_z * dz], -1)], -2)   # [..., k, 2, 3]
    # d(R X)/d rvec = -R [X]x Jr(rvec).
    dRX = -(R[..., None, :, :] @ so3_hat(X) @ so3_right_jacobian(rvec)[..., None, :, :])
    J = torch.cat([A @ dRX, A], -1) * w[..., None, None]
    return r, J


def epnp(X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor | None = None,
         gn_iters: int = 5) -> torch.Tensor:
    """EPnP(+GN) absolute pose from [..., k>=6, 3] world points and
    [..., k, 2] normalized image coords. Returns pose [..., 6] = [rvec, t]."""
    if w is None:
        w = torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device)
    wn = w / w.sum(-1, keepdim=True).clamp_min(1e-8)

    # Control points: weighted centroid + principal axes scaled to data spread.
    c0 = (X * wn[..., None]).sum(-2)
    Xc = X - c0[..., None, :]
    cov = (Xc * wn[..., None]).transpose(-1, -2) @ Xc
    evals, evecs = torch.linalg.eigh(cov)
    basis = evecs * torch.sqrt(evals.clamp_min(1e-8))[..., None, :]        # columns: s_i v_i
    ctrl = torch.cat([c0[..., None, :], c0[..., None, :] + basis.transpose(-1, -2)], -2)   # [..., 4, 3]

    # Barycentric coordinates: X = alphas @ ctrl with sum(alphas) = 1.
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    a123 = Xc @ _inv3(basis + 1e-9 * eye3).transpose(-1, -2)               # [..., k, 3]
    alphas = torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], -1)       # [..., k, 4]

    # Each point gives 2 rows over the 12 unknowns (4 ctrl pts in cam frame).
    u, v = uv[..., 0:1], uv[..., 1:2]
    zeros = torch.zeros_like(alphas)
    rows_u = torch.cat([alphas, zeros, -u * alphas], -1)                   # [..., k, 12]
    rows_v = torch.cat([zeros, alphas, -v * alphas], -1)
    M = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], -2)      # [..., 2k, 12]
    _, V = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    x = V[..., 0]                                                          # [..., 12]
    cc = torch.stack([x[..., 0:4], x[..., 4:8], x[..., 8:12]], -1)         # [..., 4, 3] up to scale/sign

    # Resolve scale from inter-control-point distances, sign from depth.
    dw = torch.linalg.vector_norm(ctrl[..., 1:, :] - ctrl[..., :1, :], dim=-1)
    dc = torch.linalg.vector_norm(cc[..., 1:, :] - cc[..., :1, :], dim=-1)
    s = (dw * dc).sum(-1) / (dc * dc).sum(-1).clamp_min(1e-12)
    pc = alphas @ (cc * s[..., None, None])                                # [..., k, 3] camera frame
    flip = (torch.sign(pc[..., 2]) * w).sum(-1) < 0
    pc = pc * torch.where(flip, -1.0, 1.0).to(X.dtype)[..., None, None]

    # Rigid alignment world -> camera (weighted Procrustes).
    _, R, _ = umeyama(X, pc, w)
    t = ((pc - X @ R.transpose(-1, -2)) * wn[..., None]).sum(-2)
    pose = torch.cat([matrix_to_aa(R), t], -1)

    # Gauss-Newton polish on the (weighted) sample reprojection.
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(gn_iters):
        r, J = _gn_residual_jacobian(pose, X, uv, w)
        J = J.flatten(-3, -2)                                              # [..., 2k, 6]
        step = torch.linalg.solve_ex(J.transpose(-1, -2) @ J + 1e-8 * eye6,
                                     J.transpose(-1, -2) @ r.flatten(-2)[..., None])[0][..., 0]
        pose = pose - step
    return pose


def pnp_ransac(idx: torch.Tensor, X: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor,
               threshold_sq: float, min_inliers: int, refine_iters: int = 3):
    """RANSAC-EPnP over the minimal sets idx [B, k] (from
    ops/ransac.draw_minimal_sets) + IRLS refinement. X [M, 3], uv [M, 2]
    normalized, mask [M]. Returns (pose [6], inliers [M], n, ok)."""
    res = ransac_ops.ransac(idx, X, uv, mask, solver=epnp, error_fn=pnp_reprojection_error,
                            threshold_sq=threshold_sq, min_inliers=min_inliers)
    pose, inl = ransac_ops.irls_refit(res.model, X, uv, mask,
                                      fit_fn=lambda a, b, ww: epnp(a, b, ww),
                                      error_fn=pnp_reprojection_error,
                                      threshold_sq=threshold_sq, iters=refine_iters)
    n = inl.sum()
    return pose, inl, n, n >= min_inliers
