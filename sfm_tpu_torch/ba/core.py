"""Schur-complement Levenberg-Marquardt bundle adjustment, single device,
dense reduced-camera solve (port of the small-problem path of
sfm_tpu/ba/core.py).

  residual r_o = project(point_p, cam_c) - uv_o, robustified by IRLS
  normal equations in segment-sum form (kernel K3 per observation, then
  the deterministic sorted-segment reduction K9 per camera and per point):
    Hcc = segsum_c Jc^T Jc  [C, 6, 6],  Hpp = segsum_p Jp^T Jp  [P, 3, 3]
    W_o = Jc_o^T Jp_o  [O, 6, 3] (kept per observation, feature-major)
    bc = -segsum_c Jc^T r,  bp = -segsum_p Jp^T r
  reduced camera system S dc = bc - W Hpp^-1 bp with S = Hcc - W Hpp^-1 W^T,
  S assembled column-block-wise through the implicit matvec and solved by
  Cholesky; back-substitution dp = Hpp^-1 (bp - W^T dc); LM accept/reject on
  the true robust cost (kernel K5), multiplicative damping.

Problems that would take the JAX package's PCG solver (more than
cfg.dense_schur_max_cameras cameras, or C*O past the dense gate) raise
NotImplementedError: PCG, its Schur-Jacobi preconditioner (whw_cam_reduce)
and the coupling-matvec kernel come with the incremental slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.ba.problem import BAProblem, CAM_DIM, PT_DIM
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.geometry.rotations import so3_hat, so3_right_jacobian
from sfm_tpu_torch.kernels.ba_kernels import (
    cam_segment_sum, fused_cost_sums, fused_ne_payloads, projection, segment_bounds,
)

_DENSE_MAX_VOLUME = 4 << 20   # C * O gate of the dense reduced solve


def residual_jac_analytic(cams_o, pts_o, intr_o, uv):
    """Closed-form residual and Jacobian blocks per observation.

    cams_o [O, 6] (rvec, tvec), pts_o [O, 3], intr_o [O, 6], uv [O, 2] ->
    (r [O, 2], Jc [O, 2, 6], Jp [O, 2, 3], depth [O]). d(R p)/d rvec uses
    the closed-form SO(3) right Jacobian: -R [p]x (I - B [w]x + C2 [w]x^2).
    """
    pr = projection(cams_o, intr_o, pts_o, uv)
    x, y, r2, s, inv_z = pr["x"], pr["y"], pr["r2"], pr["s"], pr["inv_z"]
    k1, k2 = intr_o[:, 4], intr_o[:, 5]
    xy = torch.stack([x, y], -1)
    ds_dxy = ((k1 + 2.0 * k2 * r2) * 2.0)[:, None] * xy
    eye2 = torch.eye(2, dtype=xy.dtype, device=xy.device)
    D_dist = s[:, None, None] * eye2 + xy[:, :, None] * ds_dxy[:, None, :]
    zero = torch.zeros_like(x)
    A_proj = torch.stack([torch.stack([inv_z, zero, -x * inv_z], -1),
                          torch.stack([zero, inv_z, -y * inv_z], -1)], -2)
    M = intr_o[:, :2, None] * (D_dist @ A_proj)                      # [O, 2, 3]
    R = pr["R"]
    Jp = M @ R
    dRX = -(R @ so3_hat(pts_o) @ so3_right_jacobian(cams_o[:, :3]))
    Jc = torch.cat([M @ dRX, M], dim=-1)
    return pr["r"], Jc, Jp, pr["xc2"]


class SolveInvariants(NamedTuple):
    """LM-iteration-invariant precomputations of one solve."""

    static_t: torch.Tensor      # [5, O] u, v, weight, camera-free, point-free
    point_bounds: torch.Tensor  # [P+1] int32 segment offsets (obs sorted by point)
    cam_perm: torch.Tensor      # [O] int32 permutation sorting obs by camera (stable)
    cam_bounds: torch.Tensor    # [C+1] int32 camera segment offsets
    z_floor: torch.Tensor | None = None   # near-plane depth floor (0-d)


def solve_invariants(prob: BAProblem, z_floor: torch.Tensor | None = None) -> SolveInvariants:
    oc = prob.obs_cam.long()
    op = prob.obs_point.long()
    static_t = torch.stack([
        prob.obs_uv[:, 0], prob.obs_uv[:, 1], prob.obs_w,
        (~prob.cam_fixed)[oc].float(), (~prob.point_fixed)[op].float(),
    ]).contiguous()
    cam_perm = torch.argsort(prob.obs_cam, stable=True)
    return SolveInvariants(
        static_t=static_t,
        point_bounds=segment_bounds(prob.obs_point, prob.num_points),
        cam_perm=cam_perm.to(torch.int32),
        cam_bounds=segment_bounds(prob.obs_cam[cam_perm], prob.num_cameras),
        z_floor=z_floor,
    )


def _pts_t(prob: BAProblem, points: torch.Tensor) -> torch.Tensor:
    return points[prob.obs_point.long()].T.contiguous()


def compute_cost(prob: BAProblem, cam_params, points, cfg: BAConfig,
                 inv: SolveInvariants | None = None) -> torch.Tensor:
    """Robustified mean cost over valid observations (0-d tensor), with the
    near-plane gate of inv.z_floor at these parameters."""
    if inv is None:
        inv = solve_invariants(prob)
    sums = fused_cost_sums(prob.obs_cam, _pts_t(prob, points), inv.static_t,
                           cam_params.contiguous(), prob.intrinsics, inv.z_floor,
                           cfg.robust_loss, cfg.robust_scale_px)
    return sums[0] / sums[1].clamp_min(1.0)


class NormalEq(NamedTuple):
    Hcc: torch.Tensor      # [C, 6, 6] damped
    Hpp_inv: torch.Tensor  # [P, 3, 3] damped, inverted
    W_t: torch.Tensor      # [18, O] row i*3+k = W[i, k]
    bc: torch.Tensor       # [C, 6]
    bp: torch.Tensor       # [P, 3]


def _sym_solve3(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Closed-form inverse of batched SPD 3x3 blocks (adjugate / det),
    Jacobi-equilibrated so the det cannot overflow fp32 for huge blocks:
    A^-1 = D (D A D)^-1 D with D = diag(A)^-1/2."""
    dg = torch.sqrt(A.diagonal(dim1=-2, dim2=-1).abs().clamp_min(1e-18))
    Dinv = 1.0 / dg
    A = A * Dinv[..., :, None] * Dinv[..., None, :]
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(det.abs() < eps, torch.full_like(det, eps), det)
    inv = torch.stack([
        torch.stack([co00, co01, co02], -1),
        torch.stack([co01, co11, co12], -1),
        torch.stack([co02, co12, co22], -1),
    ], -2) * inv_det[..., None, None]
    return inv * Dinv[..., :, None] * Dinv[..., None, :]


def _sym3(red6: torch.Tensor) -> torch.Tensor:
    """(00, 01, 02, 11, 12, 22) -> symmetric [..., 3, 3]."""
    s = red6.unbind(-1)
    return torch.stack([torch.stack([s[0], s[1], s[2]], -1),
                        torch.stack([s[1], s[3], s[4]], -1),
                        torch.stack([s[2], s[4], s[5]], -1)], -2)


def build_normal_equations(prob: BAProblem, cam_params, points, lam, cfg: BAConfig,
                           inv: SolveInvariants) -> NormalEq:
    """Damped normal-equation blocks at (cam_params, points)."""
    C, P = prob.num_cameras, prob.num_points
    w_t, yp_t, cam_t = fused_ne_payloads(
        prob.obs_cam, _pts_t(prob, points), inv.static_t, cam_params.contiguous(),
        prob.intrinsics, inv.z_floor, cfg.robust_loss, cfg.robust_scale_px)
    camred = cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds)       # [C, 42]
    Hcc = camred[:, :36].reshape(C, CAM_DIM, CAM_DIM)
    bc = camred[:, 36:42]
    red = cam_segment_sum(yp_t, None, inv.point_bounds)                 # [P, 9]
    Hpp = _sym3(red[:, :6])
    bp = red[:, 6:9]

    # Multiplicative LM damping on block diagonals, with an absolute floor so
    # padded/unconstrained blocks stay invertible.
    eyec = torch.eye(CAM_DIM, device=Hcc.device)
    eyep = torch.eye(PT_DIM, device=Hcc.device)
    dc = Hcc.diagonal(dim1=-2, dim2=-1)
    dp = Hpp.diagonal(dim1=-2, dim2=-1)
    Hcc_d = Hcc + (lam * dc[:, :, None] + 1e-6) * eyec
    Hpp_d = Hpp + (lam * dp[:, :, None] + 1e-6) * eyep
    return NormalEq(Hcc=Hcc_d, Hpp_inv=_sym_solve3(Hpp_d), W_t=w_t, bc=bc, bp=bp)


def _w_apply(W_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """y[..., i, o] = sum_k W_o[i, k] x[..., k, o]: W_t [18, O], x_t [..., 3, O] -> [..., 6, O]."""
    return torch.einsum("iko,...ko->...io", W_t.reshape(CAM_DIM, PT_DIM, -1), x_t)


def _w_apply_T(W_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """u[..., k, o] = sum_i W_o[i, k] x[..., i, o]: x_t [..., 6, O] -> [..., 3, O]."""
    return torch.einsum("iko,...io->...ko", W_t.reshape(CAM_DIM, PT_DIM, -1), x_t)


def _cam_reduce(y_t: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """[..., K, O] per-observation rows -> [..., C, K] per camera."""
    lead, (K, O) = y_t.shape[:-2], y_t.shape[-2:]
    out = cam_segment_sum(y_t.reshape(-1, O).contiguous(), inv.cam_perm, inv.cam_bounds)
    return out.reshape(out.shape[0], *lead, K).movedim(0, -2)


def _point_reduce(u_t: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """[..., K, O] per-observation rows -> [..., P, K] per point (obs sorted by point)."""
    lead, (K, O) = u_t.shape[:-2], u_t.shape[-2:]
    out = cam_segment_sum(u_t.reshape(-1, O).contiguous(), None, inv.point_bounds)
    return out.reshape(out.shape[0], *lead, K).movedim(0, -2)


def _schur_matvec(ne: NormalEq, prob: BAProblem, V: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """Implicit S @ v for a batch V [..., C, 6] without materializing S."""
    oc, op = prob.obs_cam.long(), prob.obs_point.long()
    v_obs_t = V[..., oc, :].transpose(-1, -2)                          # [..., 6, O]
    g = _point_reduce(_w_apply_T(ne.W_t, v_obs_t), inv)                # [..., P, 3]
    h = torch.einsum("pij,...pj->...pi", ne.Hpp_inv, g)
    y_t = _w_apply(ne.W_t, h[..., op, :].transpose(-1, -2))            # [..., 6, O]
    return torch.einsum("cij,...cj->...ci", ne.Hcc, V) - _cam_reduce(y_t, inv)


def _schur_rhs(ne: NormalEq, prob: BAProblem, inv: SolveInvariants) -> torch.Tensor:
    """rhs = bc - W Hpp^-1 bp."""
    h = torch.einsum("pij,pj->pi", ne.Hpp_inv, ne.bp)
    y_t = _w_apply(ne.W_t, h[prob.obs_point.long()].T)
    return ne.bc - _cam_reduce(y_t, inv)


def _dense_schur_solve(ne: NormalEq, prob: BAProblem, rhs: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """Dense Cholesky on the Jacobi-equilibrated reduced camera system; S is
    assembled from the implicit matvec on all unit vectors at once (by
    symmetry S e_i is row i of S)."""
    C, D = rhs.shape
    K = C * D
    eye = torch.eye(K, dtype=rhs.dtype, device=rhs.device)
    S = _schur_matvec(ne, prob, eye.reshape(K, C, D), inv).reshape(K, K)
    d = torch.sqrt(S.diagonal().clamp_min(1e-12))
    inv_d = 1.0 / d
    S_eq = S * inv_d[:, None] * inv_d[None, :] + 1e-6 * eye
    L, info = torch.linalg.cholesky_ex(S_eq)
    # A failed factorization gives a NaN step (rejected by the cost test), as
    # the JAX package's cho_factor does.
    L = torch.where(info == 0, L, torch.full((), float("nan"), device=L.device))
    y = torch.cholesky_solve((rhs.reshape(K) * inv_d)[:, None], L)[:, 0]
    return (y * inv_d).reshape(C, D)


def _back_substitute(ne: NormalEq, prob: BAProblem, dc: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """dp = Hpp^-1 (bp - W^T dc)."""
    u_t = _w_apply_T(ne.W_t, dc[prob.obs_cam.long()].T)
    g = ne.bp - _point_reduce(u_t, inv)
    return torch.einsum("pij,pj->pi", ne.Hpp_inv, g)


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    lam: torch.Tensor


def bundle_adjust(prob: BAProblem, cfg: BAConfig) -> tuple[BAProblem, BAStats]:
    """Single-device LM to convergence (or cfg.max_iterations)."""
    if prob.cam_params.shape[-1] != CAM_DIM:
        raise NotImplementedError(
            "intrinsics refinement (8-wide camera blocks) is not ported yet "
            "(ROADMAP.md queue 1 item 2: intrinsics refinement)")
    C, O = prob.num_cameras, prob.obs_w.shape[0]
    if not (C <= cfg.dense_schur_max_cameras and C * O <= _DENSE_MAX_VOLUME):
        raise NotImplementedError(
            f"BA with C={C}, O={O} needs the PCG reduced solver, not ported yet "
            "(ROADMAP.md queue 1 item 2: PCG with K7 whw_cam_reduce and K11 schur_coupling_matvec)")

    # Near-plane/cheirality gate, relative to the weighted RMS depth: points
    # at or behind a camera plane would inflate the normal equations by
    # decades. Applied at the current parameters in every NE build and cost.
    z0 = projection(prob.cam_params[prob.obs_cam.long()], prob.intrinsics[prob.obs_cam.long()],
                    prob.points[prob.obs_point.long()], prob.obs_uv)["xc2"]
    w_sum = prob.obs_w.sum()
    z_rms = torch.sqrt((prob.obs_w * z0 * z0).sum() / w_sum.clamp_min(1.0))
    z_floor = 1e-3 * z_rms.clamp_min(1e-9)
    inv = solve_invariants(prob, z_floor)

    cam_params, points = prob.cam_params, prob.points
    cost = cost0 = compute_cost(prob, cam_params, points, cfg, inv)
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=cam_params.device)
    zero = torch.zeros((), device=cam_params.device)
    it = 0
    while it < cfg.max_iterations:
        ne = build_normal_equations(prob, cam_params, points, lam, cfg, inv)
        rhs = _schur_rhs(ne, prob, inv)
        dc = _dense_schur_solve(ne, prob, rhs, inv)
        dp = _back_substitute(ne, prob, dc, inv)
        dc = torch.where(prob.cam_fixed[:, None], zero, dc)
        dp = torch.where(prob.point_fixed[:, None], zero, dp)
        new_cams = cam_params + dc
        new_points = points + dp
        new_cost = compute_cost(prob, new_cams, new_points, cfg, inv)

        accept = new_cost < cost
        cam_params = torch.where(accept, new_cams, cam_params)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, (lam / cfg.lambda_down).clamp_min(cfg.min_lambda),
                          (lam * cfg.lambda_up).clamp_max(cfg.max_lambda))
        rel_decrease = (cost - new_cost) / cost.clamp_min(1e-20)
        done = accept & (rel_decrease < cfg.function_tolerance)
        cost = torch.where(accept, new_cost, cost)
        it += 1
        if bool(done):
            break

    out = prob._replace(cam_params=cam_params, points=points)
    return out, BAStats(initial_cost=cost0, final_cost=cost, iterations=it, lam=lam)
