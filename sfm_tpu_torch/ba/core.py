"""Schur-complement Levenberg-Marquardt bundle adjustment (port of
sfm_tpu/ba/core.py), on one device or camera-sharded over a process group.

  residual r_o = project(point_p, cam_c) - uv_o, robustified by IRLS
  normal equations in segment-sum form (kernel K3: one pass over the point
  segments that sums each point's blocks and inverts them, then the camera
  rows summed per camera), for camera blocks of width D (6; 8 when the
  global BA refines intrinsics: the log focal scale and dk1 columns):
    Hcc = segsum_c Jc^T Jc  [C, D, D],  Hpp = segsum_p Jp^T Jp  [P, 3, 3]
    W_o = Jc_o^T Jp_o  [O, D, 3] (kept per observation, feature-major)
    bc = -segsum_c Jc^T r,  bp = -segsum_p Jp^T r
  reduced camera system S dc = bc - W Hpp^-1 bp with S = Hcc - W Hpp^-1 W^T,
  solved either
  - densely (at most cfg.dense_schur_max_cameras cameras and C*O within
    the volume gate, the JAX package's gate unchanged): S assembled
    column-block-wise through the implicit matvec, Cholesky; or
  - by preconditioned CG in the Jacobi-equilibrated space: the Schur-Jacobi
    preconditioner's blocks sum_c W Hpp^-1 W^T come out of K3's two
    launches (K7's device code, built only for a PCG solve), then all CG
    steps run in one pcg_solve launch (K11's coupling code and Hcc p per
    step, the dot products and updates between grid barriers);
  back-substitution dp = Hpp^-1 (bp - W^T dc) and the candidate's true
  robust cost in one launch (kernel K5; the intrinsic columns the config
  does not refine are zeroed in the camera update after dp has read them,
  as in sfm_tpu); LM accept/reject, multiplicative damping.

Past MAX_CAMS = 4096 cameras (the JAX package's _MAX_CAMS, where its one-hot
kernels stop) the normal equations and the candidate go through the
large-camera-count kernel set: camera and intrinsic rows are gathered per
observation by plain indexing and K4 (normal-equation payloads, then K9 and
the damping and inversion as torch ops), K6 (cost; the back-substitution as
torch ops) and K8 (preconditioner payloads, then K9) take the place of K3,
K5 and K7. The CG solve is one pcg_solve launch there too (its streaming
mode: W does not fit on the chip), whose coupling phase is K10's device
code; the standalone K10 entry (then K9) serves checks and tests.
The JAX package switches its coupling matvec later (past 16384 cameras or on
unaligned tiles, where its two-level in-kernel matvec cannot run); this
package has no two-level kernel, so the whole set switches at one threshold.

8-wide camera blocks run through the same kernels at width 8 on both sides
of MAX_CAMS (each kernel's `_w8` build; sfm_tpu runs them as plain XLA: its
kernels take six columns only). Past MAX_CAMS the candidate zeroes the
columns the config does not refine in torch ops, after the
back-substitution and the cam_fixed mask, in sfm_tpu's order.

The camera-sharded LM (dist/sharded_ba.py) passes `group`, the
torch.distributed process group whose processes each hold the observations
of their cameras (None: one device, as sfm_tpu's axis_name=None). Where
sfm_tpu psums, an all_reduce completes the sum: both depth sums of the
near-plane floor, the cost's numerator and denominator, the normal
equations (Hcc, bc and the point sums, all-reduced undamped: K3's sharded
mode, or K4 + K9 past MAX_CAMS; the damping and the 3x3 inversions after),
the Schur-Jacobi blocks (K7's standalone entry from the summed Hpp^-1, or
K8 + K9), the rhs, both halves of the coupling matvec (K11's point half and
camera half) and the back-substitution. The solve is always PCG (sfm_tpu's
dense route is single-device only), as pcg_loop's Python steps over the
sharded matvec: two all_reduces a step; the CG dot products are over
replicated [C, D] vectors. The candidate's cost is K5 in its cost mode (or
K6), its point step formed from the all-reduced point half.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from sfm_tpu_torch.ba.problem import BAProblem, PT_DIM
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.geometry.rotations import so3_hat, so3_right_jacobian
from sfm_tpu_torch.kernels import on_cuda
from sfm_tpu_torch.kernels.ba_kernels import (
    MAX_CAMS, LMStep, PcgPlan, cam_segment_sum, coupling_camera_half, coupling_point_half,
    fused_cost_sums, fused_cost_sums_big, fused_ne_payloads, fused_ne_payloads_big, fused_ne_sums,
    invert_permutation, pcg_launch_plan, pcg_loop, pcg_solve, projection, segment_bounds,
    whw_cam_reduce, whw_payloads_big,
)

_DENSE_MAX_VOLUME = 4 << 20   # C * O gate of the dense reduced solve


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    """sfm_tpu's _maybe_psum: t summed over the group's processes (in place;
    every process gets the same bits), or t itself for one device."""
    if group is not None:
        torch.distributed.all_reduce(t, group=group)
    return t


def residual_jac_analytic(cams_o, pts_o, intr_o, uv):
    """Closed-form residual and Jacobian blocks per observation.

    cams_o [O, D] (rvec, tvec; at D = 8 then the log focal scale and dk1),
    pts_o [O, 3], intr_o [O, 6], uv [O, 2] -> (r [O, 2], Jc [O, 2, D],
    Jp [O, 2, 3], depth [O]). d(R p)/d rvec uses the closed-form SO(3) right
    Jacobian: -R [p]x (I - B [w]x + C2 [w]x^2). At D = 8 the residual uses
    the refined intrinsics and dr/dc6 = f xy s, dr/dc7 = f xy r2
    (sfm_tpu/ba/core.py _residual_jac_analytic).
    """
    pr = projection(cams_o, intr_o, pts_o, uv)
    x, y, r2, s, inv_z = pr["x"], pr["y"], pr["r2"], pr["s"], pr["inv_z"]
    intr_o = pr["intr"]
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
    blocks = [M @ dRX, M]
    if cams_o.shape[-1] >= 8:
        f = intr_o[:, :2]
        blocks += [((xy * s[:, None]) * f)[:, :, None], (f * xy * r2[:, None])[:, :, None]]
    Jc = torch.cat(blocks, dim=-1)
    return pr["r"], Jc, Jp, pr["xc2"]


class SolveInvariants(NamedTuple):
    """LM-iteration-invariant precomputations of one solve.

    The segment tables cover the observations [0, N): N is one past the last
    observation with a nonzero weight. The zero-weight tail past it (the
    capacity padding) contributes exact zeros to every sum, and leaving it
    out keeps it from forming one long segment (padding rows carry the last
    point slot and camera 0) that a single warp or block would walk. For the
    same reason the camera tables list the weighted observations only: the
    zero-weight rows inside [0, N) (the gaps that align point segments to
    tiles, up to a fifth of the rows on long tracks) all carry camera 0."""

    static_t: torch.Tensor      # [5, O] u, v, weight, camera-free, point-free
    point_bounds: torch.Tensor  # [P+1] int32 segment offsets in [0, N) (obs sorted by point)
    cam_perm: torch.Tensor      # [M] int32 weighted obs of [0, N) sorted by camera (stable)
    cam_bounds: torch.Tensor    # [C+1] int32 camera segment offsets into cam_perm
    cam_inv_perm: torch.Tensor  # [N] int32 obs o's place in cam_perm, -1 for a zero-weight row
    z_floor: torch.Tensor | None = None   # near-plane depth floor (0-d)
    intr_t: torch.Tensor | None = None    # [6, O] intrinsics per observation (large-C set only)
    pcg_plan: PcgPlan | None = None       # point slices of pcg_solve (CUDA), and of K3, K5 up to MAX_CAMS


def uses_big_kernels(prob: BAProblem) -> bool:
    """Whether a solve of `prob` takes the large-camera-count kernel set
    (more than MAX_CAMS cameras, at either camera width)."""
    return prob.num_cameras > MAX_CAMS


def _rows_t(table: torch.Tensor, obs_cam: torch.Tensor) -> torch.Tensor:
    """Rows of a per-camera table [C, K] gathered per observation -> [K, O]
    (one gather, which writes the feature-major result contiguously)."""
    return table.T.index_select(1, obs_cam)


def solve_invariants(prob: BAProblem, z_floor: torch.Tensor | None = None) -> SolveInvariants:
    oc = prob.obs_cam.long()
    op = prob.obs_point.long()
    static_t = torch.stack([
        prob.obs_uv[:, 0], prob.obs_uv[:, 1], prob.obs_w,
        (~prob.cam_fixed)[oc].float(), (~prob.point_fixed)[op].float(),
    ]).contiguous()
    weighted = torch.nonzero(prob.obs_w).flatten()
    n = int(weighted[-1]) + 1 if weighted.numel() else 0
    cam_perm = weighted[torch.argsort(prob.obs_cam[weighted], stable=True)]
    point_bounds = segment_bounds(prob.obs_point[:n], prob.num_points)
    big = uses_big_kernels(prob)
    return SolveInvariants(
        static_t=static_t,
        point_bounds=point_bounds,
        cam_perm=cam_perm.to(torch.int32),
        cam_bounds=segment_bounds(prob.obs_cam[cam_perm], prob.num_cameras),
        cam_inv_perm=invert_permutation(cam_perm, n),
        z_floor=z_floor,
        intr_t=_rows_t(prob.intrinsics, prob.obs_cam) if big else None,
        # Once per bundle_adjust, not per LM iteration: the plan reads point_bounds back.
        pcg_plan=(pcg_launch_plan(point_bounds, cam_dim=prob.cam_params.shape[-1])
                  if on_cuda(point_bounds) else None),
    )


def _pts_t(prob: BAProblem, points: torch.Tensor) -> torch.Tensor:
    return points.T.index_select(1, prob.obs_point)


def compute_cost(prob: BAProblem, cam_params, points, cfg: BAConfig,
                 inv: SolveInvariants | None = None, group=None) -> torch.Tensor:
    """Robustified mean cost over valid observations (0-d tensor), with the
    near-plane gate of inv.z_floor at these parameters; with a group, the
    numerator and denominator summed over its processes before the
    division."""
    if inv is None:
        inv = solve_invariants(prob)
    if uses_big_kernels(prob):
        sums = fused_cost_sums_big(_pts_t(prob, points), inv.static_t,
                                   _rows_t(cam_params, prob.obs_cam), inv.intr_t, inv.z_floor,
                                   cfg.robust_loss, cfg.robust_scale_px)
        sums = _psum(sums, group)
        return sums[0] / sums[1].clamp_min(1.0)
    sums = fused_cost_sums(prob.obs_cam, prob.obs_point, points.contiguous(), inv.static_t,
                           cam_params.contiguous(), prob.intrinsics, inv.point_bounds, inv.z_floor,
                           cfg.robust_loss, cfg.robust_scale_px, plan=inv.pcg_plan)[2]
    if group is None:
        return sums[2]
    sums = _psum(sums[:2].clone(), group)
    return sums[0] / sums[1].clamp_min(1.0)


def ba_cost(prob: BAProblem, cfg: BAConfig) -> torch.Tensor:
    """The robustified mean cost at the problem's own parameters, without
    the near-plane gate (sfm_tpu's ba_cost)."""
    return compute_cost(prob, prob.cam_params, prob.points, cfg)


class NormalEq(NamedTuple):
    """Damped normal equations for camera blocks of width D (6 or 8)."""

    Hcc: torch.Tensor      # [C, D, D] damped
    Hpp_inv: torch.Tensor  # [P, 3, 3] damped, inverted
    W_t: torch.Tensor      # [3D, O] row i*3+k = W[i, k]
    bc: torch.Tensor       # [C, D]
    bp: torch.Tensor       # [P, 3]
    whw: torch.Tensor | None = None   # [C, D^2] sum_c W Hpp^-1 W^T, when built for PCG


def build_normal_equations(prob: BAProblem, cam_params, points, lam, cfg: BAConfig,
                           inv: SolveInvariants, schur_jacobi: bool = False,
                           group=None) -> NormalEq:
    """Damped normal-equation blocks at (cam_params, points); lam is a 0-d
    tensor. Multiplicative LM damping of the block diagonals with an
    absolute floor (kernels.ba_kernels.damp). schur_jacobi (a PCG solve's
    build, up to MAX_CAMS cameras): K3 also returns the Schur-Jacobi blocks
    in the same launches; past MAX_CAMS the preconditioner builds them
    (K8 + K9). With a group: _sharded_normal_equations."""
    if group is not None:
        return _sharded_normal_equations(prob, cam_params, points, lam, cfg, inv, group)
    if not uses_big_kernels(prob):
        out = fused_ne_payloads(
            prob.obs_cam, prob.obs_point, points.contiguous(), inv.static_t, cam_params.contiguous(),
            prob.intrinsics, inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm,
            lam, inv.z_floor, cfg.robust_loss, cfg.robust_scale_px, plan=inv.pcg_plan,
            schur_jacobi=schur_jacobi)
        return NormalEq(*out[:5], whw=out[6] if schur_jacobi else None)
    C, D = prob.num_cameras, cam_params.shape[-1]
    w_t, yp_t, cam_t = fused_ne_payloads_big(
        _pts_t(prob, points), inv.static_t, _rows_t(cam_params, prob.obs_cam), inv.intr_t,
        inv.z_floor, cfg.robust_loss, cfg.robust_scale_px)
    camred = cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)  # [C, D^2 + D]
    red = cam_segment_sum(yp_t, None, inv.point_bounds)                 # [P, 9]
    return NormalEq(Hcc=_damp_big(camred[:, :D * D].reshape(C, D, D), lam),
                    Hpp_inv=_sym_solve3_big(_damp_big(_sym3_big(red[:, :6]), lam)), W_t=w_t,
                    bc=camred[:, D * D:D * D + D], bp=red[:, 6:9])


def _sharded_normal_equations(prob: BAProblem, cam_params, points, lam, cfg: BAConfig,
                              inv: SolveInvariants, group) -> NormalEq:
    """The normal equations of the camera-sharded LM: this process's
    undamped sums (K3's sharded mode, or K4 then K9 past MAX_CAMS)
    all-reduced in one call, then damped and inverted (sfm_tpu's order: a
    point without observations here has a zero block, and damping before
    the sum would add one floor per process); the Schur-Jacobi blocks from
    the summed Hpp^-1 (K7's standalone entry, or K8 then K9), all-reduced."""
    C, P, D = prob.num_cameras, prob.num_points, cam_params.shape[-1]
    if not uses_big_kernels(prob):
        Hcc, W_t, bc, psums = fused_ne_sums(
            prob.obs_cam, prob.obs_point, points.contiguous(), inv.static_t, cam_params.contiguous(),
            prob.intrinsics, inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm,
            inv.z_floor, cfg.robust_loss, cfg.robust_scale_px, plan=inv.pcg_plan)
        sums = torch.cat([Hcc.reshape(-1), bc.reshape(-1), psums.reshape(-1)])
    else:
        W_t, yp_t, cam_t = fused_ne_payloads_big(
            _pts_t(prob, points), inv.static_t, _rows_t(cam_params, prob.obs_cam), inv.intr_t,
            inv.z_floor, cfg.robust_loss, cfg.robust_scale_px)
        camred = cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)  # [C, D^2 + D]
        red = cam_segment_sum(yp_t, None, inv.point_bounds)                           # [P, 9]
        sums = torch.cat([camred[:, :D * D].reshape(-1), camred[:, D * D:].reshape(-1), red.reshape(-1)])
    sums = _psum(sums, group)
    Hcc = sums[:C * D * D].reshape(C, D, D)
    bc = sums[C * D * D:C * D * (D + 1)].reshape(C, D)
    red = sums[C * D * (D + 1):].reshape(P, 9)
    Hpp_inv = _sym_solve3_big(_damp_big(_sym3_big(red[:, :6]), lam)).contiguous()
    if uses_big_kernels(prob):
        whw = cam_segment_sum(whw_payloads_big(W_t, Hpp_inv, prob.obs_point), inv.cam_perm,
                              inv.cam_bounds, inv.cam_inv_perm)
    else:
        whw = whw_cam_reduce(W_t, Hpp_inv, prob.obs_point, inv.cam_perm, inv.cam_bounds,
                             inv.cam_inv_perm)
    return NormalEq(Hcc=_damp_big(Hcc, lam), Hpp_inv=Hpp_inv, W_t=W_t, bc=bc,
                    bp=red[:, 6:9].contiguous(), whw=_psum(whw, group))


# The large-camera route's damping and inversion of its blocks (10,240
# camera blocks, ~16,000 point blocks on the merged polish): the arithmetic
# of kernels.ba_kernels' sym3, damp and sym_solve3 (which K3's plain
# version uses), the same roundings in the same order, in whole-block
# operations. Their per-entry forms took ~60 small launches per LM
# iteration there (tools/torch_perf.py polish).
_SYM3_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)   # (00, 01, 02, 11, 12, 22) -> row-major 3x3
# The entries A[i+a, j+b] (indices mod 3) for (a, b) = (1, 1), (2, 2), (1, 2),
# (2, 1), each read from the upper triangle as sym_solve3 reads them: the
# cofactor factors.
_COFACTOR_SHIFTS = tuple(3 * min(r, c) + max(r, c)
                         for a, b in ((1, 1), (2, 2), (1, 2), (2, 1)) for i in range(3) for j in range(3)
                         for r, c in [((i + a) % 3, (j + b) % 3)])


@functools.lru_cache(maxsize=None)
def _index(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant index tensor, made once per device (a list index would be
    copied to the card at every call)."""
    return torch.tensor(values, dtype=torch.long, device=device)


def _sym3_big(red6: torch.Tensor) -> torch.Tensor:
    """sym3 in one gather: (00, 01, 02, 11, 12, 22) -> symmetric [..., 3, 3]."""
    return red6.index_select(-1, _index(_SYM3_FULL, red6.device)).reshape(*red6.shape[:-1], 3, 3)


def _damp_big(H: torch.Tensor, lam) -> torch.Tensor:
    """damp on a copy's diagonal: H + (lam diag(H) + 1e-6) I."""
    out = H.clone()
    d = out.diagonal(dim1=-2, dim2=-1)
    d += lam * d + 1e-6
    return out


def _sym_solve3_big(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """sym_solve3 (adjugate / det of the Jacobi-equilibrated block) with the
    cofactors in cyclic form, cof[i, j] = A[i+1, j+1] A[i+2, j+2] -
    A[i+1, j+2] A[i+2, j+1] (indices mod 3), from one gather: for a
    symmetric block the products of the written-out adjugate (d f - e e,
    c e - b f, ...), and the determinant summed in its order."""
    dg = torch.sqrt(A.diagonal(dim1=-2, dim2=-1).abs().clamp_min(1e-18))
    Dinv = 1.0 / dg
    A = A * Dinv[..., :, None] * Dinv[..., None, :]
    lead = A.shape[:-2]
    X = A.reshape(*lead, 9).index_select(-1, _index(_COFACTOR_SHIFTS, A.device)).reshape(*lead, 4, 3, 3)
    cof = X[..., 0, :, :] * X[..., 1, :, :] - X[..., 2, :, :] * X[..., 3, :, :]
    terms = A[..., 0, :] * cof[..., 0, :]
    det = terms[..., 0] + terms[..., 1] + terms[..., 2]
    inv_det = 1.0 / torch.where(det.abs() < eps, eps, det)
    return cof * inv_det[..., None, None] * Dinv[..., :, None] * Dinv[..., None, :]


def pcg_preconditioner(ne: NormalEq, prob: BAProblem, inv: SolveInvariants
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Schur-Jacobi preconditioner: the exact block diagonal of S,
    M = Hcc - sum_c W Hpp^-1 W^T + 1e-6 I (the blocks from ne.whw, which K3
    built with the normal equations; past MAX_CAMS from K8 then K9),
    inverted Jacobi-equilibrated so huge blocks cannot overflow the fp32
    inversion: M^-1 = D (D M D)^-1 D with D = diag(M)^-1/2. Returns
    (M^-1 [C, K, K], sqrt|diag M| [C, K]) for camera blocks of width K."""
    C, K = prob.num_cameras, ne.Hcc.shape[-1]
    if ne.whw is not None:
        whw = ne.whw
    elif uses_big_kernels(prob):
        whw = cam_segment_sum(whw_payloads_big(ne.W_t, ne.Hpp_inv, prob.obs_point),
                              inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)
    else:
        raise ValueError("pcg_preconditioner: build the normal equations with schur_jacobi=True")
    M = ne.Hcc - whw.reshape(C, K, K)
    M.diagonal(dim1=-2, dim2=-1).add_(1e-6)
    dg = torch.sqrt(M.diagonal(dim1=-2, dim2=-1).abs().clamp_min(1e-18))
    Dinv = 1.0 / dg
    M_eq = M * Dinv[:, :, None] * Dinv[:, None, :]
    M_inv = (torch.linalg.inv_ex(M_eq).inverse * Dinv[:, :, None] * Dinv[:, None, :]).contiguous()
    return M_inv, dg   # (inv_ex hands back column-major blocks on the GPU)


# One vector (x_t 2-D) goes through a broadcast product and a sum: two
# launches, where the einsum's batched matrix-vector path took ~29 launches
# and ~1.7 ms of device time at the merged polish's 1.9 M observations
# (tools/torch_perf.py polish).
def _w_apply(W_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """y[..., i, o] = sum_k W_o[i, k] x[..., k, o]: W_t [3D, O], x_t [..., 3, O] -> [..., D, O]."""
    Wm = W_t.reshape(W_t.shape[0] // PT_DIM, PT_DIM, -1)
    if x_t.dim() == 2:
        return (Wm * x_t[None]).sum(1)
    return torch.einsum("iko,...ko->...io", Wm, x_t)


def _w_apply_T(W_t: torch.Tensor, x_t: torch.Tensor) -> torch.Tensor:
    """u[..., k, o] = sum_i W_o[i, k] x[..., i, o]: x_t [..., D, O] -> [..., 3, O]."""
    Wm = W_t.reshape(W_t.shape[0] // PT_DIM, PT_DIM, -1)
    if x_t.dim() == 2:
        return (Wm * x_t[:, None]).sum(0)
    return torch.einsum("iko,...io->...ko", Wm, x_t)


def _cam_reduce(y_t: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """[..., K, O] per-observation rows -> [..., C, K] per camera."""
    lead, (K, O) = y_t.shape[:-2], y_t.shape[-2:]
    out = cam_segment_sum(y_t.reshape(-1, O).contiguous(), inv.cam_perm, inv.cam_bounds,
                          inv.cam_inv_perm)
    return out.reshape(out.shape[0], *lead, K).movedim(0, -2)


def _point_reduce(u_t: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """[..., K, O] per-observation rows -> [..., P, K] per point (obs sorted by point)."""
    lead, (K, O) = u_t.shape[:-2], u_t.shape[-2:]
    out = cam_segment_sum(u_t.reshape(-1, O).contiguous(), None, inv.point_bounds)
    return out.reshape(out.shape[0], *lead, K).movedim(0, -2)


def _schur_matvec(ne: NormalEq, prob: BAProblem, V: torch.Tensor, inv: SolveInvariants) -> torch.Tensor:
    """Implicit S @ v for a batch V [..., C, D] without materializing S."""
    oc, op = prob.obs_cam.long(), prob.obs_point.long()
    v_obs_t = V[..., oc, :].transpose(-1, -2)                          # [..., D, O]
    g = _point_reduce(_w_apply_T(ne.W_t, v_obs_t), inv)                # [..., P, 3]
    h = torch.einsum("pij,...pj->...pi", ne.Hpp_inv, g)
    y_t = _w_apply(ne.W_t, h[..., op, :].transpose(-1, -2))            # [..., D, O]
    return torch.einsum("cij,...cj->...ci", ne.Hcc, V) - _cam_reduce(y_t, inv)


def _sharded_matvec(ne: NormalEq, prob: BAProblem, v: torch.Tensor, inv: SolveInvariants,
                    group) -> torch.Tensor:
    """S v for v [C, D] in the camera-sharded LM: K11's point half, its
    all_reduce, h = Hpp^-1 g, the camera half and its all_reduce."""
    g = _psum(coupling_point_half(ne.W_t, prob.obs_cam, inv.point_bounds, v), group)
    h = torch.einsum("pij,pj->pi", ne.Hpp_inv, g).contiguous()
    y = coupling_camera_half(ne.W_t, prob.obs_point, inv.point_bounds, inv.cam_perm,
                             inv.cam_bounds, inv.cam_inv_perm, h)
    return torch.einsum("cij,cj->ci", ne.Hcc, v) - _psum(y, group)


def _pcg(ne: NormalEq, prob: BAProblem, rhs: torch.Tensor, cfg: BAConfig,
         inv: SolveInvariants, group=None) -> torch.Tensor:
    """Preconditioned CG on the reduced camera system (kernels.ba_kernels
    pcg_loop's algorithm: Jacobi-equilibrated by D = sqrt|diag M| of the
    Schur-Jacobi preconditioner M, cfg.cg_iterations steps, converged or dead
    solves frozen, nothing read back to the host): at any camera count the
    whole solve is one pcg_solve launch (past MAX_CAMS in its streaming
    mode, with K10's coupling code)."""
    M_inv, d = pcg_preconditioner(ne, prob, inv)
    if group is not None:   # the sharded matvec needs two all_reduces a step
        return pcg_loop(lambda v: _sharded_matvec(ne, prob, v, inv, group), M_inv, d, rhs,
                        cfg.cg_iterations, cfg.cg_tolerance)
    return pcg_solve(ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds,
                     inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d,
                     rhs.contiguous(), cfg.cg_iterations, cfg.cg_tolerance, plan=inv.pcg_plan)


def _schur_rhs(ne: NormalEq, prob: BAProblem, inv: SolveInvariants, group=None) -> torch.Tensor:
    """rhs = bc - W Hpp^-1 bp (with a group, the W term K11's camera half,
    all-reduced)."""
    h = torch.einsum("pij,pj->pi", ne.Hpp_inv, ne.bp)
    if group is not None:
        return ne.bc - _psum(coupling_camera_half(ne.W_t, prob.obs_point, inv.point_bounds,
                                                  inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm,
                                                  h.contiguous()), group)
    y_t = _w_apply(ne.W_t, h.index_select(0, prob.obs_point).T)
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


def _back_substitute(ne: NormalEq, prob: BAProblem, dc: torch.Tensor, inv: SolveInvariants,
                     group=None) -> torch.Tensor:
    """dp = Hpp^-1 (bp - W^T dc) (with a group, W^T dc K11's point half,
    all-reduced)."""
    if group is not None:
        g = ne.bp - _psum(coupling_point_half(ne.W_t, prob.obs_cam, inv.point_bounds,
                                              dc.contiguous()), group)
        return torch.einsum("pij,pj->pi", ne.Hpp_inv, g)
    u_t = _w_apply_T(ne.W_t, dc.index_select(0, prob.obs_cam).T)
    g = ne.bp - _point_reduce(u_t, inv)
    return torch.einsum("pij,pj->pi", ne.Hpp_inv, g)


def frozen_columns(cfg: BAConfig, width: int) -> dict:
    """LMStep's column flags for camera blocks of `width`: with 8-wide
    blocks, the intrinsic columns cfg does not refine."""
    wide = width >= 8
    return dict(freeze_focal=wide and not cfg.refine_focal,
                freeze_distortion=wide and not cfg.refine_distortion)


def lm_candidate(ne: NormalEq, prob: BAProblem, dc: torch.Tensor, cam_params, points,
                 cfg: BAConfig, inv: SolveInvariants, group=None):
    """The LM candidate of the camera step dc: (cam_params + dc, points + dp)
    with dp = Hpp^-1 (bp - W^T dc), the steps of frozen cameras and points
    zero, and its robust mean cost (0-d). With 8-wide cameras the columns
    the config does not refine (6: focal unless cfg.refine_focal, 7: k1
    unless cfg.refine_distortion) are zeroed in the camera update only,
    after dp has read the whole dc, as sfm_tpu's bundle_adjust_impl does
    (their W rows are not zero). Up to MAX_CAMS cameras on one device: one
    K5 launch. Past MAX_CAMS, and with a group (the camera-sharded LM) at
    every camera count, sfm_tpu's order in torch ops: dp from the whole dc
    (with a group through the all-reduced point half), then the fixed
    cameras' and points' steps and the frozen columns zeroed, then the cost
    (K6, or with a group K5 in its cost mode, summed over the group)."""
    if group is not None or uses_big_kernels(prob):
        dp = _back_substitute(ne, prob, dc, inv, group)
        zero = torch.zeros((), dtype=dc.dtype, device=dc.device)
        dc = torch.where(prob.cam_fixed[:, None], zero, dc)
        dp = torch.where(prob.point_fixed[:, None], zero, dp)
        frozen = frozen_columns(cfg, cam_params.shape[-1])
        if frozen["freeze_focal"] or frozen["freeze_distortion"]:
            dc = dc.clone()
            if frozen["freeze_focal"]:
                dc[:, 6] = 0.0
            if frozen["freeze_distortion"]:
                dc[:, 7] = 0.0
        new_cams, new_points = cam_params + dc, points + dp
        return new_cams, new_points, compute_cost(prob, new_cams, new_points, cfg, inv, group)
    new_cams, new_points, sums = fused_cost_sums(
        prob.obs_cam, prob.obs_point, points.contiguous(), inv.static_t, cam_params.contiguous(),
        prob.intrinsics, inv.point_bounds, inv.z_floor, cfg.robust_loss, cfg.robust_scale_px,
        step=LMStep(dc.contiguous(), ne.W_t, ne.Hpp_inv, ne.bp, prob.cam_fixed, prob.point_fixed,
                    **frozen_columns(cfg, cam_params.shape[-1])),
        plan=inv.pcg_plan)
    return new_cams, new_points, sums[2]


def uses_dense_solver(prob: BAProblem, cfg: BAConfig) -> bool:
    """The JAX package's reduced-solver gate, unchanged: dense Cholesky for
    at most cfg.dense_schur_max_cameras (padded) cameras and C * O (padded
    capacities) within the volume gate, PCG otherwise."""
    C, O = prob.num_cameras, prob.obs_w.shape[0]
    return C <= cfg.dense_schur_max_cameras and C * O <= _DENSE_MAX_VOLUME


def near_plane_floor(prob: BAProblem, group=None) -> torch.Tensor:
    """The near-plane/cheirality gate's depth floor (0-d): 1e-3 of the
    weighted RMS depth at prob's parameters (with a group, both sums over
    its processes). Points at or behind a camera plane would inflate the
    normal equations by decades; every NE build and cost of a solve drops
    the observations at or below it."""
    z0 = projection(prob.cam_params[prob.obs_cam.long()], prob.intrinsics[prob.obs_cam.long()],
                    prob.points[prob.obs_point.long()], prob.obs_uv)["xc2"]
    if group is not None:
        sums = _psum(torch.stack([(prob.obs_w * z0 * z0).sum(), prob.obs_w.sum()]), group)
        return 1e-3 * torch.sqrt(sums[0] / sums[1].clamp_min(1.0)).clamp_min(1e-9)
    z_rms = torch.sqrt((prob.obs_w * z0 * z0).sum() / prob.obs_w.sum().clamp_min(1.0))
    return 1e-3 * z_rms.clamp_min(1e-9)


class BAStats(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    lam: torch.Tensor


def bundle_adjust(prob: BAProblem, cfg: BAConfig, group=None) -> tuple[BAProblem, BAStats]:
    """LM to convergence (or cfg.max_iterations), with 6-wide or 8-wide
    camera blocks (intrinsics refinement: build_problem's
    refine_intrinsics, cfg.refine_focal / cfg.refine_distortion). group
    None: one device. With a process group (dist/sharded_ba.py) prob holds
    this process's observations, sorted by point, and every sum over them is
    completed by an all_reduce; the exit test reads the all-reduced cost, so
    every process leaves on the same iteration."""
    use_dense = group is None and uses_dense_solver(prob, cfg)
    inv = solve_invariants(prob, near_plane_floor(prob, group))

    cam_params, points = prob.cam_params, prob.points
    cost = cost0 = compute_cost(prob, cam_params, points, cfg, inv, group)
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=cam_params.device)
    it = 0
    while it < cfg.max_iterations:
        ne = build_normal_equations(prob, cam_params, points, lam, cfg, inv,
                                    schur_jacobi=not use_dense, group=group)
        rhs = _schur_rhs(ne, prob, inv, group)
        if use_dense:
            dc = _dense_schur_solve(ne, prob, rhs, inv)
        else:
            dc = _pcg(ne, prob, rhs, cfg, inv, group)
        new_cams, new_points, new_cost = lm_candidate(ne, prob, dc, cam_params, points, cfg, inv,
                                                      group)

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
