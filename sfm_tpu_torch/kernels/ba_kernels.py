"""K3 fused_ne_payloads, K4 fused_ne_payloads_big, K5 fused_cost_sums, K6
fused_cost_sums_big and K9 cam_segment_sum (csrc/ba_kernels.cu,
csrc/ba_project.cuh), K7 whw_cam_reduce, K8 whw_payloads_big, K10
schur_coupling_payloads_big, K11 schur_coupling_matvec and pcg_solve, the
whole PCG solve over K10's and K11's device code in one launch
(csrc/schur_kernels.cu, csrc/schur_jacobi.cuh).

Replace the functions of the same names in sfm_tpu/kernels/schur_spmv.py;
pcg_solve replaces sfm_tpu/ba/core.py _pcg (a fori_loop over K11, or over
K10 past its two-level kernel's reach) at every camera count. The
camera-sharded LM (dist/sharded_ba.py) runs K3 in its sharded mode
(fused_ne_sums: the undamped sums, all-reduced before the damping and
inversion) and K11 cut at h (coupling_point_half, coupling_camera_half:
an all-reduce between them), with its CG steps in pcg_loop. K3 also
takes in the reductions, damping and inversions of sfm_tpu's
build_normal_equations (the damped normal equations in two launches, for a
PCG solve with the Schur-Jacobi blocks of K7), and K5 the LM candidate of
its bundle_adjust_impl (back-substitution, freeze masks, candidate
parameters and their cost in one launch); both walk the point segments on
pcg_solve's plan.
The `_big` set serves problems of more than MAX_CAMS cameras, as in the JAX
package: camera, intrinsic and v rows arrive gathered per observation
([D, O] or [6, O], plain indexing by the caller) and every result stays per
observation for the caller's K9 reduction. Layouts are
feature-major ([rows, O]) wherever a kernel reads or writes per-observation
rows, so a warp touches contiguous memory.

Inputs shared by K3 and K5:
  obs_cam  [O] int32      camera of each observation (sorted by point)
  points   [P, 3] f32     the points (refreshed every LM iteration)
  static_t [5, O] f32     u, v, weight, camera-free, point-free (per solve)
  cams     [C, D] f32     rvec, tvec, with D = 8 (intrinsics refinement)
                          then the log focal scale and dk1: fx, fy scaled
                          by exp(c6), c7 added to k1 (sfm_tpu/ba/problem.py)
  intr     [C, 6] f32     fx fy cx cy k1 k2
  point_bounds [P+1] int32  point segments covering the observations [0, N)
  z_floor  0-d f32 tensor or None: near-plane gate at the current parameters
Every kernel takes the camera width D from its inputs' shapes (cams,
cams_t [D, O], W_t [3D, O], v, v_obs_t [D, O], rhs), 6 or 8, and launches
the kernel built for it (kernels/__init__.py: the `_w8` entries); sfm_tpu
runs an 8-wide BA as plain XLA. K4 and K6 take pts_t [3, O] (each
observation's point), cams_t [D, O] and intr_t [6, O] (those rows gathered
per observation) in place of obs_cam, points, cams and intr.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from sfm_tpu_torch.geometry.losses import robust_cost, robust_weight
from sfm_tpu_torch.kernels import check, count_launch, launch, library, on_cuda, ptr

MAX_CAMS = 4096    # above this the BA core takes K4/K6/K8/K10 (sfm_tpu's _MAX_CAMS)
LOSS_CODES = {"none": 0, "huber": 1, "cauchy": 2}
CAM_DIMS = (6, 8)  # camera widths the kernels are built for: pose, pose + intrinsics


def ne_cam_rows(D: int) -> int:
    """Floats of K3's camera row: vec(Jc^T Jc) (D^2) then -Jc^T r (D)."""
    return D * D + D


def whw_entries(D: int) -> int:
    """Distinct entries of a symmetric D x D Schur-Jacobi block."""
    return D * (D + 1) // 2


def ne_pcg_rows(D: int) -> int:
    """Floats of K3's packed row with the Schur-Jacobi blocks: the camera
    row and the upper triangle of W Hpp^-1 W^T, padded to a multiple of 16
    floats (64-byte rows): 64, or 112 at D = 8."""
    return -(-(ne_cam_rows(D) + whw_entries(D)) // 16) * 16


def upper(D: int) -> list[int]:
    """The upper triangle of a D x D block, row by row, as flat indices
    (csrc/schur_jacobi.cuh's order)."""
    return [i * D + j for i in range(D) for j in range(i, D)]


NE_CAM_ROWS = ne_cam_rows(6)   # 42 at D = 6: the wrappers read D from their inputs
NE_PT_ROWS = 9     # sym(Jp^T Jp) (00, 01, 02, 11, 12, 22) then -Jp^T r
NE_PCG_ROWS = ne_pcg_rows(6)   # 64: the camera row, 21 entries of W Hpp^-1 W^T, one unused (112 at D = 8)
_STATIC_ROWS = 5
_SYM3 = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])
_UPPER6 = upper(6)


def _width(D: int) -> int:
    if D not in CAM_DIMS:
        raise ValueError(f"camera blocks are {CAM_DIMS[0]} or {CAM_DIMS[1]} wide, got {D}")
    return D


def _wide(name: str, D: int) -> str:
    """The C entry or launch-count name of the kernel built for width D."""
    return name if _width(D) == 6 else f"{name}_w8"


def rot_entries(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """I + a [w]x + b [w]x^2 for w [..., 3] -> [..., 3, 3]."""
    wx, wy, wz = w.unbind(-1)
    t2 = wx * wx + wy * wy + wz * wz
    rows = [
        1.0 + b * (wx * wx - t2), -a * wz + b * wx * wy, a * wy + b * wx * wz,
        a * wz + b * wx * wy, 1.0 + b * (wy * wy - t2), -a * wx + b * wy * wz,
        -a * wy + b * wx * wz, a * wx + b * wy * wz, 1.0 + b * (wz * wz - t2),
    ]
    return torch.stack(rows, -1).reshape(*w.shape[:-1], 3, 3)


def refined_intrinsics(cams_o, intr_o):
    """The intrinsics an observation's residual uses: intr_o itself for
    6-wide cameras; for 8-wide ones fx and fy scaled by exp(c6) and c7
    added to k1 (sfm_tpu/ba/core.py _residuals_flat)."""
    if cams_o.shape[-1] < 8:
        return intr_o
    sf = torch.exp(cams_o[:, 6])
    return torch.stack([intr_o[:, 0] * sf, intr_o[:, 1] * sf, intr_o[:, 2], intr_o[:, 3],
                        intr_o[:, 4] + cams_o[:, 7], intr_o[:, 5]], -1)


def projection(cams_o, intr_o, pts_o, uv):
    """Shared per-observation projection (mirror of schur_spmv._project_rows
    and of csrc/ba_project.cuh): cams_o [O, D], intr_o [O, 6], pts_o [O, 3],
    uv [O, 2]. Returns a dict of the intermediates the NE Jacobians need,
    "intr" the intrinsics the residual used (refined_intrinsics)."""
    intr_o = refined_intrinsics(cams_o, intr_o)
    w = cams_o[:, :3]
    t2 = (w * w).sum(-1)
    th = torch.sqrt(t2.clamp_min(1e-24))
    small = t2 < 1e-8
    sin_t, cos_t = torch.sin(th), torch.cos(th)
    A = torch.where(small, 1.0 - t2 / 6.0, sin_t / th)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - cos_t) / t2)
    R = rot_entries(w, A, B)
    xc = (R * pts_o[:, None, :]).sum(-1) + cams_o[:, 3:6]
    xc2 = xc[:, 2]
    z = torch.where(xc2.abs() < 1e-8,
                    torch.where(xc2 < 0, torch.full_like(xc2, -1e-8), torch.full_like(xc2, 1e-8)),
                    xc2)
    inv_z = 1.0 / z
    x = xc[:, 0] * inv_z
    y = xc[:, 1] * inv_z
    r2 = x * x + y * y
    k1, k2 = intr_o[:, 4], intr_o[:, 5]
    s = 1.0 + r2 * (k1 + r2 * k2)
    ru = intr_o[:, 0] * (x * s) + intr_o[:, 2] - uv[:, 0]
    rv = intr_o[:, 1] * (y * s) + intr_o[:, 3] - uv[:, 1]
    return dict(r=torch.stack([ru, rv], -1), xc2=xc2, x=x, y=y, r2=r2, s=s, inv_z=inv_z, R=R,
                intr=intr_o)


def _gate(w: torch.Tensor, depth: torch.Tensor, z_floor) -> torch.Tensor:
    if z_floor is None:
        return w
    return torch.where(depth > z_floor, w, torch.zeros((), device=w.device))


def _ne_payloads_obs_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """Per-observation normal-equation payloads, feature-major: (W = Jc^T Jp
    [3D, O], sym(Jp^T Jp), -Jp^T r [9, O], vec(Jc^T Jc), -Jc^T r [D^2 + D, O])
    for cams [C, D], IRLS-weighted, near-plane gated, freeze masks applied;
    pts_t [3, O] is each observation's point."""
    from sfm_tpu_torch.ba.core import residual_jac_analytic

    oc = obs_cam.long()
    O, D = oc.shape[0], cams.shape[-1]
    r, Jc, Jp, depth = residual_jac_analytic(cams[oc], pts_t.T, intr[oc], static_t[:2].T)
    w = _gate(static_t[2], depth, z_floor)
    s = (r * r).sum(-1)
    sw = torch.sqrt((robust_weight(s, loss, scale) * w).clamp_min(0.0))
    rw = r * sw[:, None]
    Jc = Jc * (sw * static_t[3])[:, None, None]
    Jp = Jp * (sw * static_t[4])[:, None, None]
    cam_t = torch.cat([torch.einsum("oai,oaj->oij", Jc, Jc).reshape(O, D * D),
                       -torch.einsum("oai,oa->oi", Jc, rw)], 1).T.contiguous()
    w_t = torch.einsum("oai,oaj->oij", Jc, Jp).reshape(O, 3 * D).T.contiguous()
    hpp = torch.einsum("oai,oaj->oij", Jp, Jp)[:, _SYM3[0], _SYM3[1]]
    yp_t = torch.cat([hpp, -torch.einsum("oai,oa->oi", Jp, rw)], 1).T.contiguous()
    return w_t, yp_t, cam_t


def _cost_sums_obs_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """(sum robust_cost(|r|^2) * w, sum w) over observations, each with its
    point pts_t [3, O] -> tensor [2]."""
    oc = obs_cam.long()
    pr = projection(cams[oc], intr[oc], pts_t.T, static_t[:2].T)
    w = _gate(static_t[2], pr["xc2"], z_floor)
    c = robust_cost((pr["r"] ** 2).sum(-1), loss, scale) * w
    return torch.stack([c.sum(), w.sum()])


def sym3(red6: torch.Tensor) -> torch.Tensor:
    """(00, 01, 02, 11, 12, 22) -> symmetric [..., 3, 3]."""
    s = red6.unbind(-1)
    return torch.stack([torch.stack([s[0], s[1], s[2]], -1),
                        torch.stack([s[1], s[3], s[4]], -1),
                        torch.stack([s[2], s[4], s[5]], -1)], -2)


def damp(H: torch.Tensor, lam) -> torch.Tensor:
    """Multiplicative LM damping of diagonal blocks H [..., n, n], with an
    absolute floor so padded or unconstrained blocks stay invertible:
    H + (lam diag(H) + 1e-6) I."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + (lam * H.diagonal(dim1=-2, dim2=-1)[..., :, None] + 1e-6) * eye


def sym_solve3(A: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
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


def _check_tables(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor):
    O, P, C = obs_cam.shape[0], points.shape[0], cams.shape[0]
    dev = obs_cam.device
    check(obs_cam, "obs_cam", torch.int32, (O,), dev)
    check(obs_point, "obs_point", torch.int32, (O,), dev)
    check(points, "points", torch.float32, (P, 3), dev)
    check(static_t, "static_t", torch.float32, (_STATIC_ROWS, O), dev)
    check(cams, "cams", torch.float32, (C, _width(cams.shape[-1])), dev)
    check(intr, "intr", torch.float32, (C, 6), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    if z_floor is not None:
        check(z_floor, "z_floor", torch.float32, (), dev)


def fused_ne_payloads_plain(obs_cam, obs_point, points, static_t, cams, intr, point_bounds,
                            cam_perm, cam_bounds, cam_inv_perm, lam, z_floor, loss: str,
                            scale: float, schur_jacobi: bool = False):
    """Plain K3, in the inputs' dtype: the per-observation payloads, the
    camera rows in camera order (packed[i] is the row of observation
    cam_perm[i]), their sums per camera and per point (in index order), the
    damping and the 3x3 inversion -> (Hcc [C, D, D], Hpp_inv [P, 3, 3],
    W_t [3D, O], bc [C, D], bp [P, 3], packed [M, D^2 + D]) for cams [C, D].
    W_t is zero past the point segments. With schur_jacobi the packed rows
    are [M, ne_pcg_rows(D)] (the camera row, the D (D + 1) / 2 upper entries
    of W Hpp^-1 W^T, zeros) and a seventh output holds the Schur-Jacobi
    blocks [C, D^2] (whw_cam_reduce_plain's)."""
    O, C, N, D = obs_cam.shape[0], cams.shape[0], int(point_bounds[-1]), cams.shape[-1]
    w_t, yp_t, cam_t = _ne_payloads_obs_plain(
        obs_cam[:N], points[obs_point[:N].long()].T, static_t[:, :N], cams, intr, z_floor, loss,
        scale)
    w_t = torch.cat([w_t, w_t.new_zeros((3 * D, O - N))], 1)
    cam_t = torch.cat([cam_t, cam_t.new_zeros((ne_cam_rows(D), O - N))], 1)
    packed = cam_t[:, cam_perm.long()].T.contiguous()
    camred = cam_segment_sum_plain(packed.T, None, cam_bounds)                   # [C, D^2 + D]
    red = cam_segment_sum_plain(yp_t, None, point_bounds)                        # [P, 9]
    Hcc = damp(camred[:, :D * D].reshape(C, D, D), lam)
    Hpp_inv = sym_solve3(damp(sym3(red[:, :6]), lam))
    out = (Hcc, Hpp_inv, w_t, camred[:, D * D:], red[:, 6:9], packed)
    if not schur_jacobi:
        return out
    whw_t = _whw_rows_t(w_t, Hpp_inv[obs_point.long()])[upper(D)][:, cam_perm.long()]
    pad = ne_pcg_rows(D) - ne_cam_rows(D) - whw_entries(D)
    packed = torch.cat([packed, whw_t.T, packed.new_zeros((packed.shape[0], pad))], 1)
    return (*out[:5], packed, whw_cam_reduce_plain(w_t, Hpp_inv, obs_point, cam_perm, cam_bounds))


def fused_ne_payloads(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, cam_perm,
                      cam_bounds, cam_inv_perm, lam, z_floor, loss: str, scale: float, plan=None,
                      schur_jacobi: bool = False):
    """The damped normal equations at (cams [C, D], points [P, 3]) in two
    launches: one pass over the point segments (observations sorted by
    point, obs_point [O]; point_bounds [P+1] covers [0, N)) forms each observation's
    W = Jc^T Jp and its camera row vec(Jc^T Jc), -Jc^T r, stored at its
    place cam_inv_perm[o] among the M weighted observations in camera order
    (cam_perm and cam_bounds [C+1], SolveInvariants' tables), and each
    point's damped, inverted block and -Jp^T r; then the camera rows are
    summed per camera and Hcc's diagonal damped. IRLS-weighted, near-plane
    gated (z_floor 0-d or None), the freeze masks of static_t applied; lam is
    a 0-d tensor. Returns (Hcc [C, D, D], Hpp_inv [P, 3, 3], W_t [3D, O]
    (zero past N), bc [C, D], bp [P, 3], packed [M, D^2 + D]). With
    schur_jacobi (a PCG solve's build) the same two launches also form the
    Schur-Jacobi blocks sum_c W Hpp^-1 W^T (whw_cam_reduce's device code:
    that count goes up too), returned seventh as [C, D^2], and packed is
    [M, ne_pcg_rows(D)] (64 or 112). D = 6 launches the 6-wide build, D = 8
    the 8-wide one (counted as fused_ne_payloads_w8, whw_cam_reduce_w8).
    plan (pcg_launch_plan: the blocks' point slices) is made here when
    missing. Deterministic."""
    if not on_cuda(obs_cam):
        return fused_ne_payloads_plain(obs_cam, obs_point, points, static_t, cams, intr,
                                       point_bounds, cam_perm, cam_bounds, cam_inv_perm, lam,
                                       z_floor, loss, scale, schur_jacobi)
    O, P, C, D = obs_cam.shape[0], points.shape[0], cams.shape[0], cams.shape[-1]
    M, N = cam_perm.shape[0], cam_inv_perm.shape[0]
    dev = obs_cam.device
    _check_tables(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor)
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    check(lam, "lam", torch.float32, (), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, obs_cam holds {O}")
    if plan is None:
        plan = pcg_launch_plan(point_bounds)
    check(plan.block_points, "plan.block_points", torch.int32, (plan.grid + 1,), dev)
    w_t = torch.empty((3 * D, O), dtype=torch.float32, device=dev)
    packed = torch.empty((M, ne_pcg_rows(D) if schur_jacobi else ne_cam_rows(D)), dtype=torch.float32,
                         device=dev)
    hinv = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    bp = torch.empty((P, 3), dtype=torch.float32, device=dev)
    hcc = torch.empty((C, D, D), dtype=torch.float32, device=dev)
    bc = torch.empty((C, D), dtype=torch.float32, device=dev)
    whw = torch.empty((C, D * D), dtype=torch.float32, device=dev) if schur_jacobi else None
    launch(_wide("sfm_fused_ne_payloads", D), _wide("fused_ne_payloads", D),
           ptr(obs_cam), ptr(obs_point), ptr(points), ptr(static_t), ptr(cams), ptr(intr),
           ptr(z_floor), ptr(lam), ptr(point_bounds), ptr(cam_inv_perm), ptr(cam_bounds),
           ptr(plan.block_points), O, P, C, LOSS_CODES[loss], float(scale), plan.grid,
           segment_warps(M, C),
           ptr(w_t), ptr(packed), ptr(hinv), ptr(bp), ptr(hcc), ptr(bc), ptr(whw))
    if not schur_jacobi:
        return hcc, hinv, w_t, bc, bp, packed
    count_launch(_wide("whw_cam_reduce", D))     # the launch ran K7's device code
    return hcc, hinv, w_t, bc, bp, packed, whw


def fused_ne_sums_plain(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, cam_perm,
                        cam_bounds, z_floor, loss: str, scale: float):
    """Plain K3 in its sharded mode, in the inputs' dtype: the payloads of
    fused_ne_payloads_plain summed per camera and per point, undamped ->
    (Hcc [C, D, D], W_t [3D, O], bc [C, D], psums [P, 9]: sym(Jp^T Jp)
    (00, 01, 02, 11, 12, 22) then -Jp^T r)."""
    O, C, N, D = obs_cam.shape[0], cams.shape[0], int(point_bounds[-1]), cams.shape[-1]
    w_t, yp_t, cam_t = _ne_payloads_obs_plain(
        obs_cam[:N], points[obs_point[:N].long()].T, static_t[:, :N], cams, intr, z_floor, loss,
        scale)
    w_t = torch.cat([w_t, w_t.new_zeros((3 * D, O - N))], 1)
    camred = cam_segment_sum_plain(cam_t[:, cam_perm.long()], None, cam_bounds)   # [C, D^2 + D]
    psums = cam_segment_sum_plain(yp_t, None, point_bounds)                      # [P, 9]
    return camred[:, :D * D].reshape(C, D, D), w_t, camred[:, D * D:], psums


def fused_ne_sums(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, cam_perm,
                  cam_bounds, cam_inv_perm, z_floor, loss: str, scale: float, plan=None):
    """K3's sharded mode: fused_ne_payloads' two launches over the same
    tables, writing the undamped sums of this device's observations ->
    (Hcc [C, D, D], W_t [3D, O] (zero past N), bc [C, D], psums [P, 9]:
    sym(Jp^T Jp) (00, 01, 02, 11, 12, 22) then -Jp^T r per point, zero for
    a point without observations here). No damping, no inversion, no
    Schur-Jacobi blocks: with the observations sharded by camera a point's
    rows span devices, so its block is damped and inverted after the
    all-reduce (a zero block damped on each device would add D floors).
    D = 8 launches the 8-wide build (fused_ne_sums_w8). Deterministic."""
    if not on_cuda(obs_cam):
        return fused_ne_sums_plain(obs_cam, obs_point, points, static_t, cams, intr, point_bounds,
                                   cam_perm, cam_bounds, z_floor, loss, scale)
    O, P, C, D = obs_cam.shape[0], points.shape[0], cams.shape[0], cams.shape[-1]
    M, N = cam_perm.shape[0], cam_inv_perm.shape[0]
    dev = obs_cam.device
    _check_tables(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor)
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, obs_cam holds {O}")
    if plan is None:
        plan = pcg_launch_plan(point_bounds)
    check(plan.block_points, "plan.block_points", torch.int32, (plan.grid + 1,), dev)
    w_t = torch.empty((3 * D, O), dtype=torch.float32, device=dev)
    packed = torch.empty((M, ne_cam_rows(D)), dtype=torch.float32, device=dev)
    psums = torch.empty((P, NE_PT_ROWS), dtype=torch.float32, device=dev)
    hcc = torch.empty((C, D, D), dtype=torch.float32, device=dev)
    bc = torch.empty((C, D), dtype=torch.float32, device=dev)
    launch(_wide("sfm_fused_ne_sums", D), _wide("fused_ne_sums", D),
           ptr(obs_cam), ptr(obs_point), ptr(points), ptr(static_t), ptr(cams), ptr(intr),
           ptr(z_floor), ptr(point_bounds), ptr(cam_inv_perm), ptr(cam_bounds),
           ptr(plan.block_points), O, P, C, LOSS_CODES[loss], float(scale), plan.grid,
           segment_warps(M, C), ptr(w_t), ptr(packed), ptr(psums), ptr(hcc), ptr(bc))
    return hcc, w_t, bc, psums


class LMStep(NamedTuple):
    """An LM step for fused_cost_sums: the camera step and the normal
    equations that give the point step dp = Hpp^-1 (bp - W^T dc). With
    8-wide cameras freeze_focal / freeze_distortion zero the candidate
    cameras' column 6 / 7 (the config refines neither), after dp has read
    the whole step, as sfm_tpu's bundle_adjust_impl does: those columns' W
    rows are not zero, so zeroing them first would move the points."""

    dc: torch.Tensor            # [C, D]
    W_t: torch.Tensor           # [3D, O]
    Hpp_inv: torch.Tensor       # [P, 3, 3]
    bp: torch.Tensor            # [P, 3]
    cam_fixed: torch.Tensor     # [C] bool
    point_fixed: torch.Tensor   # [P] bool
    freeze_focal: bool = False
    freeze_distortion: bool = False

    @property
    def frozen(self) -> int:
        """The column mask K5 takes: bit 0 column 6, bit 1 column 7."""
        return int(self.freeze_focal) | int(self.freeze_distortion) << 1


def fused_cost_sums_plain(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor,
                          loss: str, scale: float, step: LMStep | None = None):
    """Plain K5, in the inputs' dtype: dc masked by cam_fixed, the
    back-substitution, dp masked by point_fixed, the candidate parameters
    (the step's frozen intrinsic columns zeroed in the camera update only),
    then the robust cost sums over the point segments -> (new_cams,
    new_points, tensor [3]: sum robust_cost(|r|^2) * w, sum w, their mean)."""
    N, D = int(point_bounds[-1]), cams.shape[-1]
    obs_point = obs_point[:N].long()
    if step is not None:
        zero = torch.zeros((), dtype=cams.dtype, device=cams.device)
        dc = torch.where(step.cam_fixed[:, None], zero, step.dc)
        u_t = torch.einsum("iko,io->ko", step.W_t[:, :N].reshape(D, 3, N), dc[obs_cam[:N].long()].T)
        g = step.bp - cam_segment_sum_plain(u_t, None, point_bounds)
        dp = torch.where(step.point_fixed[:, None], zero,
                         torch.einsum("pij,pj->pi", step.Hpp_inv, g))
        if step.frozen:
            dc = dc.clone()
            if step.freeze_focal:
                dc[:, 6] = 0.0
            if step.freeze_distortion:
                dc[:, 7] = 0.0
        cams, points = cams + dc, points + dp
    sums = _cost_sums_obs_plain(obs_cam[:N], points[obs_point].T, static_t[:, :N], cams, intr,
                                z_floor, loss, scale)
    return cams, points, torch.cat([sums, (sums[0] / sums[1].clamp_min(1.0))[None]])


# K5's last-block counter, one per card: zero between launches (the last
# block resets it), so it is made once instead of filled before every launch.
_TICKETS: dict[torch.device, torch.Tensor] = {}


def fused_cost_sums(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor,
                    loss: str, scale: float, step: LMStep | None = None, plan=None):
    """The robust cost at (cams [C, D], points [P, 3]) or, given an LM
    `step`, at its candidate (cams + dc, points + dp) with dp = Hpp^-1
    (bp - W^T dc), the steps of frozen cameras and points zero and the
    step's frozen intrinsic columns zeroed in the camera update, in one
    launch over the point segments (observations sorted by point, obs_point
    [O]; point_bounds [P+1] covers [0, N)). Returns (new_cams [C, D], new_points
    [P, 3], sums [3]: sum robust_cost(|r|^2) * w, sum w, their mean); without
    a step new_cams and new_points are cams and points. The last block to
    finish adds the blocks' sums in block order: deterministic. plan as for
    fused_ne_payloads. D = 8 launches the 8-wide build (fused_cost_sums_w8)."""
    if not on_cuda(obs_cam):
        return fused_cost_sums_plain(obs_cam, obs_point, points, static_t, cams, intr,
                                     point_bounds, z_floor, loss, scale, step)
    O, P, C, D = obs_cam.shape[0], points.shape[0], cams.shape[0], cams.shape[-1]
    dev = obs_cam.device
    _check_tables(obs_cam, obs_point, points, static_t, cams, intr, point_bounds, z_floor)
    new_cams, new_points = cams, points
    if step is not None:
        if step.frozen and D < 8:
            raise ValueError("fused_cost_sums: a 6-wide camera has no intrinsic columns to freeze")
        check(step.dc, "dc", torch.float32, (C, D), dev)
        check(step.W_t, "W_t", torch.float32, (3 * D, O), dev)
        check(step.Hpp_inv, "Hpp_inv", torch.float32, (P, 3, 3), dev)
        check(step.bp, "bp", torch.float32, (P, 3), dev)
        check(step.cam_fixed, "cam_fixed", torch.bool, (C,), dev)
        check(step.point_fixed, "point_fixed", torch.bool, (P,), dev)
        new_cams = torch.empty((C, D), dtype=torch.float32, device=dev)
        new_points = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if plan is None:
        plan = pcg_launch_plan(point_bounds)
    check(plan.block_points, "plan.block_points", torch.int32, (plan.grid + 1,), dev)
    partials = torch.empty((2, plan.grid), dtype=torch.float32, device=dev)
    out = torch.empty((3,), dtype=torch.float32, device=dev)
    if dev not in _TICKETS:
        _TICKETS[dev] = torch.zeros((1,), dtype=torch.int32, device=dev)
    s = step if step is not None else LMStep(None, None, None, None, None, None)
    launch(_wide("sfm_fused_cost_sums", D), _wide("fused_cost_sums", D),
           ptr(obs_cam), ptr(obs_point), ptr(points), ptr(static_t), ptr(cams), ptr(intr),
           ptr(z_floor), ptr(point_bounds), ptr(plan.block_points), ptr(s.dc), ptr(s.cam_fixed),
           ptr(s.point_fixed), ptr(s.W_t), ptr(s.Hpp_inv), ptr(s.bp),
           O, P, C, LOSS_CODES[loss], float(scale), plan.grid, s.frozen,
           ptr(new_points) if step is not None else None,
           ptr(new_cams) if step is not None else None,
           ptr(partials), ptr(_TICKETS[dev]), ptr(out))
    return new_cams, new_points, out


def _check_big_inputs(pts_t, static_t, cams_t, intr_t, z_floor) -> tuple[int, int]:
    """K4's and K6's inputs checked -> (O, the camera width D of cams_t)."""
    O, D = pts_t.shape[1], _width(cams_t.shape[0])
    dev = pts_t.device
    check(pts_t, "pts_t", torch.float32, (3, O), dev)
    check(static_t, "static_t", torch.float32, (_STATIC_ROWS, O), dev)
    check(cams_t, "cams_t", torch.float32, (D, O), dev)
    check(intr_t, "intr_t", torch.float32, (6, O), dev)
    if z_floor is not None:
        check(z_floor, "z_floor", torch.float32, (), dev)
    return O, D


def _as_table(cams_t, intr_t):
    """Pre-gathered rows as per-camera tables: every observation its own camera."""
    O = cams_t.shape[1]
    obs_cam = torch.arange(O, dtype=torch.int32, device=cams_t.device)
    return obs_cam, cams_t.T.contiguous(), intr_t.T.contiguous()


def fused_ne_payloads_big_plain(pts_t, static_t, cams_t, intr_t, z_floor, loss: str, scale: float):
    """Plain K4 for cams_t [D, O]: (w_t [3D, O], yp_t [9, O], cam_t [D^2 + D, O])."""
    obs_cam, cams, intr = _as_table(cams_t, intr_t)
    return _ne_payloads_obs_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss, scale)


def fused_ne_payloads_big(pts_t, static_t, cams_t, intr_t, z_floor, loss: str, scale: float):
    """Per-observation normal-equation payloads (each observation's point
    pts_t [3, O], camera rows cams_t [D, O] and intrinsic rows intr_t
    [6, O] gathered per observation), feature-major: W = Jc^T Jp [3D, O],
    point payload sym(Jp^T Jp), -Jp^T r [9, O], camera payload
    vec(Jc^T Jc), -Jc^T r [D^2 + D, O] (IRLS-weighted, near-plane gated,
    freeze masks applied), for the caller's K9 reductions. D = 8 launches
    the 8-wide build (fused_ne_payloads_big_w8)."""
    if not on_cuda(pts_t):
        return fused_ne_payloads_big_plain(pts_t, static_t, cams_t, intr_t, z_floor, loss, scale)
    O, D = _check_big_inputs(pts_t, static_t, cams_t, intr_t, z_floor)
    dev = pts_t.device
    w_t = torch.empty((3 * D, O), dtype=torch.float32, device=dev)
    yp_t = torch.empty((NE_PT_ROWS, O), dtype=torch.float32, device=dev)
    cam_t = torch.empty((ne_cam_rows(D), O), dtype=torch.float32, device=dev)
    launch(_wide("sfm_fused_ne_payloads_big", D), _wide("fused_ne_payloads_big", D),
           ptr(pts_t), ptr(static_t), ptr(cams_t), ptr(intr_t), ptr(z_floor),
           O, LOSS_CODES[loss], float(scale), ptr(w_t), ptr(yp_t), ptr(cam_t))
    return w_t, yp_t, cam_t


def fused_cost_sums_big_plain(pts_t, static_t, cams_t, intr_t, z_floor, loss: str, scale: float):
    """Plain K6: tensor [2] = (sum robust_cost(|r|^2) * w, sum w)."""
    obs_cam, cams, intr = _as_table(cams_t, intr_t)
    return _cost_sums_obs_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss, scale)


_COST_THREADS = 256


def fused_cost_sums_big(pts_t, static_t, cams_t, intr_t, z_floor, loss: str, scale: float):
    """Robustified cost and weight sums over observations on rows gathered
    per observation (as for fused_ne_payloads_big) -> tensor [2]. D = 8
    launches the 8-wide build (fused_cost_sums_big_w8)."""
    if not on_cuda(pts_t):
        return fused_cost_sums_big_plain(pts_t, static_t, cams_t, intr_t, z_floor, loss, scale)
    O, D = _check_big_inputs(pts_t, static_t, cams_t, intr_t, z_floor)
    dev = pts_t.device
    nblocks = max(1, -(-O // _COST_THREADS))
    partials = torch.empty((nblocks, 2), dtype=torch.float32, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    launch(_wide("sfm_fused_cost_sums_big", D), _wide("fused_cost_sums_big", D),
           ptr(pts_t), ptr(static_t), ptr(cams_t), ptr(intr_t), ptr(z_floor),
           O, LOSS_CODES[loss], float(scale), ptr(partials), nblocks, ptr(out))
    return out


def segment_bounds(sorted_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """[S+1] int32 offsets of segments 0..S-1 in a sorted id array."""
    s = torch.arange(num_segments + 1, dtype=sorted_ids.dtype, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids.contiguous(), s).to(torch.int32)


def cam_segment_sum_plain(values_t, perm, bounds):
    """Plain K9: out[s, k] = sum of values_t[k, perm[i]] over i in
    [bounds[s], bounds[s+1]) (perm None = identity), in values_t's dtype. On
    the CPU the rows are added in that order; on a GPU index_add_ adds them
    with atomics, in an order that changes from run to run."""
    S = bounds.shape[0] - 1
    lengths = (bounds[1:] - bounds[:-1]).long()
    ids = torch.repeat_interleave(torch.arange(S, device=values_t.device), lengths)
    lo, hi = int(bounds[0]), int(bounds[-1])
    cols = perm[lo:hi].long() if perm is not None else torch.arange(lo, hi, device=values_t.device)
    out = torch.zeros((S, values_t.shape[0]), dtype=values_t.dtype, device=values_t.device)
    return out.index_add_(0, ids, values_t[:, cols].T)


def invert_permutation(perm: torch.Tensor, size: int) -> torch.Tensor:
    """inv [size] int32 with inv[perm[i]] = i and -1 where perm names no
    entry, for perm [M] distinct indices into [0, size)."""
    inv = torch.full((size,), -1, dtype=torch.int32, device=perm.device)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=torch.int32, device=perm.device)
    return inv


def segment_lanes(num_obs: int, num_segments: int) -> int:
    """Lanes of the sub-warp group that owns one sorted segment: the least
    power of two that holds the mean segment length, within 1..32."""
    mean = -(-num_obs // max(num_segments, 1))
    lanes = 1
    while lanes < 32 and lanes < mean:
        lanes *= 2
    return lanes


_MAX_SEGMENT_WARPS = 32     # csrc/segment_sum.cuh kMaxSegmentWarps
_TARGET_SEGMENT_WARPS = 4096  # warps that keep the card's 132 SMs busy


def segment_warps(num_obs: int, num_segments: int) -> int:
    """Warps of the block that owns one segment of the packed (second) pass
    of a permuted reduction: one where the segments alone fill the card, up
    to 32 where they are few, each warp keeping at least 32 observations of
    a mean segment."""
    mean = num_obs // max(num_segments, 1)
    warps = 1
    while (warps < _MAX_SEGMENT_WARPS and num_segments * warps < _TARGET_SEGMENT_WARPS
           and mean >= 64 * warps):
        warps *= 2
    return warps


def cam_segment_sum(values_t, perm, bounds, inv_perm=None):
    """Deterministic sorted-segment reduction: values_t [K, O] f32, perm [M]
    int32 (distinct observation indices sorted by segment; None when the
    observations already are), bounds [S+1] int32 offsets into perm (or
    into [0, O)) -> [S, K]. inv_perm [N] int32 (N <= O) is the place in perm
    of each observation of [0, N), -1 for one that perm leaves out
    (invert_permutation; a solve builds it once), made here when missing."""
    if not on_cuda(values_t):
        return cam_segment_sum_plain(values_t, perm, bounds)
    K, O = values_t.shape
    S = bounds.shape[0] - 1
    dev = values_t.device
    check(values_t, "values_t", torch.float32, (K, O), dev)
    check(bounds, "bounds", torch.int32, (S + 1,), dev)
    out = torch.empty((S, K), dtype=torch.float32, device=dev)
    if S == 0 or K == 0:
        return out
    if perm is None:
        launch("sfm_segment_sum", "cam_segment_sum",
               ptr(values_t), None, ptr(bounds), O, K, S, O, segment_lanes(O, S), None, ptr(out))
        return out
    M = perm.shape[0]
    check(perm, "perm", torch.int32, (M,), dev)
    if inv_perm is None:
        inv_perm = invert_permutation(perm, O)
    N = inv_perm.shape[0]
    check(inv_perm, "inv_perm", torch.int32, (N,), dev)
    if not M <= N <= O:
        raise ValueError(f"perm lists {M} of {N} observations, values_t holds {O}")
    packed = torch.empty((M, K), dtype=torch.float32, device=dev)
    launch("sfm_segment_sum", "cam_segment_sum",
           ptr(values_t), ptr(inv_perm), ptr(bounds), O, K, S, N, segment_warps(M, S),
           ptr(packed), ptr(out))
    return out


def _whw_rows_t(W_t: torch.Tensor, hinv_o: torch.Tensor) -> torch.Tensor:
    """vec(W_o Hinv_o W_o^T) per observation: W_t [3D, O], hinv_o [O, 3, 3]
    -> [D^2, O] (the plain versions' intermediate)."""
    D = W_t.shape[0] // 3
    Wm = W_t.reshape(D, 3, -1)
    u = torch.einsum("iko,okl->ilo", Wm, hinv_o)
    return torch.einsum("ilo,jlo->ijo", u, Wm).reshape(D * D, -1)


def whw_cam_reduce_plain(W_t, Hpp_inv, obs_point, cam_perm, cam_bounds):
    """Plain K7: out[c] = sum over observations o of camera c of
    vec(W_o Hpp_inv[p(o)] W_o^T) -> [C, D^2], in W_t's dtype."""
    return cam_segment_sum_plain(_whw_rows_t(W_t, Hpp_inv[obs_point.long()]), cam_perm, cam_bounds)


def whw_row(D: int) -> int:
    """csrc/schur_kernels.cu kWhwRow: floats per packed row of the standalone
    K7, the D (D + 1) / 2 entries in 16-byte rows (24, or 36 at D = 8)."""
    return -(-whw_entries(D) // 4) * 4


def whw_cam_reduce(W_t, Hpp_inv, obs_point, cam_perm, cam_bounds, cam_inv_perm):
    """Schur-Jacobi blocks sum_{o in c} W_o Hpp^-1_{p(o)} W_o^T: W_t [3D, O]
    (row i*3+k = W[i, k]), Hpp_inv [P, 3, 3], obs_point [O] int32,
    cam_perm [M] int32 and cam_bounds [C+1] int32 (a stable camera sort of
    the weighted observations) -> [C, D^2]. cam_inv_perm [N] is each
    observation's place in cam_perm (-1 outside it, invert_permutation).
    The device code of fused_ne_payloads' blocks, in two launches of its
    own (a PCG solve takes the blocks from K3). Deterministic."""
    if not on_cuda(W_t):
        return whw_cam_reduce_plain(W_t, Hpp_inv, obs_point, cam_perm, cam_bounds)
    O, D = W_t.shape[1], _width(W_t.shape[0] // 3)
    P = Hpp_inv.shape[0]
    C = cam_bounds.shape[0] - 1
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(Hpp_inv, "Hpp_inv", torch.float32, (P, 3, 3), dev)
    check(obs_point, "obs_point", torch.int32, (O,), dev)
    M = cam_perm.shape[0]
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    out = torch.empty((C, D * D), dtype=torch.float32, device=dev)
    if C == 0:
        return out
    N = cam_inv_perm.shape[0]
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, W_t holds {O}")
    packed = torch.empty((M, whw_row(D)), dtype=torch.float32, device=dev)
    launch(_wide("sfm_whw_cam_reduce", D), _wide("whw_cam_reduce", D),
           ptr(W_t), ptr(Hpp_inv), ptr(obs_point), ptr(cam_inv_perm), ptr(cam_bounds), O, N, C,
           segment_warps(M, C), ptr(packed), ptr(out))
    return out


def whw_payloads_big_plain(W_t, Hpp_inv, obs_point):
    """Plain K8: vec(W_o Hpp_inv[p(o)] W_o^T) per observation -> [D^2, O]."""
    return _whw_rows_t(W_t, Hpp_inv[obs_point.long()])


def whw_payloads_big(W_t, Hpp_inv, obs_point):
    """Per-observation Schur-Jacobi payloads vec(W_o Hpp^-1_{p(o)} W_o^T):
    W_t [3D, O], Hpp_inv [P, 3, 3], obs_point [O] int32 -> [D^2, O], for the
    caller's camera reduction (cam_segment_sum). D = 8 launches the 8-wide
    build (whw_payloads_big_w8)."""
    if not on_cuda(W_t):
        return whw_payloads_big_plain(W_t, Hpp_inv, obs_point)
    O, D = W_t.shape[1], _width(W_t.shape[0] // 3)
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(Hpp_inv, "Hpp_inv", torch.float32, (None, 3, 3), dev)
    check(obs_point, "obs_point", torch.int32, (O,), dev)
    out_t = torch.empty((D * D, O), dtype=torch.float32, device=dev)
    if O == 0:
        return out_t
    launch(_wide("sfm_whw_payloads_big", D), _wide("whw_payloads_big", D),
           ptr(W_t), ptr(Hpp_inv), ptr(obs_point), O, ptr(out_t))
    return out_t


def schur_coupling_matvec_plain(W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm,
                                cam_bounds, v):
    """Plain K11: (W Hpp^-1 W^T) v -> [C, D], in W_t's dtype, by the
    feature-major einsums and the plain sorted-segment sums."""
    Wm = W_t.reshape(W_t.shape[0] // 3, 3, -1)
    u_t = torch.einsum("iko,io->ko", Wm, v[obs_cam.long()].T)                  # [3, O]
    g = cam_segment_sum_plain(u_t, None, point_bounds)                         # [P, 3]
    h = torch.einsum("pij,pj->pi", Hpp_inv, g)
    y_t = torch.einsum("iko,ko->io", Wm, h[obs_point.long()].T)                # [D, O]
    return cam_segment_sum_plain(y_t, cam_perm, cam_bounds)


def schur_coupling_matvec(W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm, cam_bounds, v,
                          cam_inv_perm=None):
    """The Schur coupling term (W Hpp^-1 W^T) v for v [C, D] -> [C, D]:
    per observation u_o = W_o^T v[cam_o], per point g_p = sum u_o and
    h_p = Hpp^-1_p g_p, per observation y_o = W_o h_p, per camera the sum of
    y_o. Observations must be sorted by point; point_bounds [P+1] covers
    [0, N) and cam_perm/cam_bounds (as for whw_cam_reduce) the weighted ones
    among them (SolveInvariants' contract); cam_inv_perm [N] is each
    observation's place in cam_perm (-1 outside it), made here when missing.
    Deterministic."""
    if not on_cuda(W_t):
        return schur_coupling_matvec_plain(W_t, Hpp_inv, obs_cam, obs_point, point_bounds,
                                           cam_perm, cam_bounds, v)
    O, D = W_t.shape[1], _width(v.shape[-1])
    P = Hpp_inv.shape[0]
    C = v.shape[0]
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(Hpp_inv, "Hpp_inv", torch.float32, (P, 3, 3), dev)
    check(obs_cam, "obs_cam", torch.int32, (O,), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    M = cam_perm.shape[0]
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    check(v, "v", torch.float32, (C, D), dev)
    out = torch.empty((C, D), dtype=torch.float32, device=dev)
    if C == 0 or M == 0 or P == 0:
        return out.zero_()
    if cam_inv_perm is None:
        cam_inv_perm = invert_permutation(cam_perm, O)
    N = cam_inv_perm.shape[0]
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, W_t holds {O}")
    y_packed = torch.empty((M, D), dtype=torch.float32, device=dev)
    launch(_wide("sfm_schur_coupling_matvec", D), _wide("schur_coupling_matvec", D),
           ptr(W_t), ptr(Hpp_inv), ptr(obs_cam), ptr(point_bounds), ptr(_aligned_rows(v)),
           ptr(cam_inv_perm),
           ptr(cam_bounds), O, P, C, segment_warps(M, C), ptr(y_packed), ptr(out))
    return out


def _aligned_rows(v: torch.Tensor) -> torch.Tensor:
    """v itself when its rows can be read as 8-byte pairs (D = 6) or 16-byte
    quads (D = 8), else an aligned copy."""
    return v.clone() if v.data_ptr() % (8 if v.shape[-1] == 6 else 16) else v


def coupling_point_half_plain(W_t, obs_cam, point_bounds, v):
    """Plain K11 point half: g [P, 3], in W_t's dtype."""
    N = int(point_bounds[-1])
    Wm = W_t[:, :N].reshape(W_t.shape[0] // 3, 3, N)
    u_t = torch.einsum("iko,io->ko", Wm, v[obs_cam[:N].long()].T)               # [3, N]
    return cam_segment_sum_plain(u_t, None, point_bounds)


def coupling_point_half(W_t, obs_cam, point_bounds, v):
    """K11's point half, for the camera-sharded LM: g_p = sum over point
    p's observations here of W_o^T v[cam_o] -> g [P, 3], for v [C, D].
    Observations sorted by point, point_bounds [P+1] covering [0, N).
    One launch of K11's point code (a warp per point); deterministic. The
    caller all-reduces g, then h = Hpp^-1 g goes to coupling_camera_half."""
    if not on_cuda(W_t):
        return coupling_point_half_plain(W_t, obs_cam, point_bounds, v)
    O, D = W_t.shape[1], _width(v.shape[-1])
    P, C = point_bounds.shape[0] - 1, v.shape[0]
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(obs_cam, "obs_cam", torch.int32, (O,), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    check(v, "v", torch.float32, (C, D), dev)
    g = torch.empty((P, 3), dtype=torch.float32, device=dev)
    if P == 0:
        return g
    launch(_wide("sfm_coupling_point_half", D), _wide("coupling_point_half", D),
           ptr(W_t), ptr(obs_cam), ptr(point_bounds), ptr(_aligned_rows(v)), O, P, ptr(g))
    return g


def coupling_camera_half_plain(W_t, obs_point, cam_perm, cam_bounds, h):
    """Plain K11 camera half: [C, D], in W_t's dtype."""
    Wm = W_t.reshape(W_t.shape[0] // 3, 3, -1)
    y_t = torch.einsum("iko,ko->io", Wm, h[obs_point.long()].T)                  # [D, O]
    return cam_segment_sum_plain(y_t, cam_perm, cam_bounds)


def coupling_camera_half(W_t, obs_point, point_bounds, cam_perm, cam_bounds, cam_inv_perm, h):
    """K11's camera half, for the camera-sharded LM: per camera the sum of
    W_o h[p(o)] over its weighted observations here -> [C, D], for h
    [P, 3]: y_o at the observation's camera-sorted place (a warp per point
    over point_bounds, K11's code), then the packed pass of the
    sorted-segment reduction (cam_perm, cam_bounds and cam_inv_perm as for
    schur_coupling_matvec). Two launches; deterministic."""
    if not on_cuda(W_t):
        return coupling_camera_half_plain(W_t, obs_point, cam_perm, cam_bounds, h)
    O, D = W_t.shape[1], _width(W_t.shape[0] // 3)
    P, C = point_bounds.shape[0] - 1, cam_bounds.shape[0] - 1
    M, N = cam_perm.shape[0], cam_inv_perm.shape[0]
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    check(h, "h", torch.float32, (P, 3), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, W_t holds {O}")
    out = torch.empty((C, D), dtype=torch.float32, device=dev)
    if C == 0 or M == 0:
        return out.zero_()
    y_packed = torch.empty((M, D), dtype=torch.float32, device=dev)
    launch(_wide("sfm_coupling_camera_half", D), _wide("coupling_camera_half", D),
           ptr(W_t), ptr(point_bounds), ptr(h), ptr(cam_inv_perm), ptr(cam_bounds), O, P, C,
           segment_warps(M, C), ptr(y_packed), ptr(out))
    return out


def pcg_loop(matvec, M_inv, d, rhs, iterations: int, tolerance: float):
    """Preconditioned CG on S x = rhs (matvec(v) = S v for v [C, K], K the
    camera width) in the Jacobi-equilibrated space: solve
    (D^-1 S D^-1) y = D^-1 rhs with D = d [C, K] (sqrt|diag M| of the
    Schur-Jacobi preconditioner M, whose inverse blocks are M_inv
    [C, K, K]), return x = D^-1 y (every iterate O(1)-scaled,
    so fp32 CG cannot overflow in p.(S p) when diag S spans many decades).

    `iterations` steps, always: a converged or dead solve freezes its updates
    through torch.where instead of leaving the loop, so the loop never reads
    a value back to the host. A non-finite or non-positive curvature p.(S p)
    freezes the solve for good (CG keeps its best x)."""
    dinv = 1.0 / d

    def precond(r):
        return d * torch.einsum("cij,cj->ci", M_inv, d * r)

    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    one = torch.ones((), dtype=rhs.dtype, device=rhs.device)
    b = dinv * rhs
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = (r * z).sum()
    rhs_norm = torch.sqrt((b * b).sum()) + 1e-20
    dead = torch.zeros((), dtype=torch.bool, device=rhs.device)
    for _ in range(iterations):
        Ap = dinv * matvec(dinv * p)
        pAp = (p * Ap).sum()
        dead = dead | ~torch.isfinite(pAp) | (pAp <= 0.0)
        done = dead | (torch.sqrt((r * r).sum()) / rhs_norm < tolerance)
        alpha = torch.where(done, zero, rz / torch.where(done, one, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.where(done, rz, (r * z).sum())
        beta = rz_new / rz.clamp_min(1e-20)
        p = torch.where(done, p, z + beta * p)
        rz = rz_new
    return dinv * x


def pcg_solve_plain(W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm, cam_bounds,
                    Hcc, M_inv, d, rhs, iterations: int, tolerance: float):
    """Plain pcg_solve: pcg_loop over S v = Hcc v - schur_coupling_matvec_plain(v),
    in W_t's dtype."""
    def matvec(v):
        return torch.einsum("cij,cj->ci", Hcc, v) - schur_coupling_matvec_plain(
            W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm, cam_bounds, v)

    return pcg_loop(matvec, M_inv, d, rhs, iterations, tolerance)


PCG_SMEM_BUDGET = 200 * 1024   # dynamic shared memory a block of pcg_solve may stage


def pcg_staged_rows(cam_dim: int = 6) -> int:
    """Rows of a resident pcg_solve slice: W's 3D, the camera and the
    camera-sorted place (20, or 26 at D = 8)."""
    return 3 * cam_dim + 2


PCG_STAGED_ROWS = pcg_staged_rows(6)


class PcgPlan(NamedTuple):
    """How pcg_solve cuts its work (K3 and K5 take its block slices too, up
    to MAX_CAMS cameras): block b owns the points [block_points[b],
    block_points[b+1]) and their observations, a group of `lanes` lanes
    walks one point's observations in pcg_solve; resident mode stages each
    block's slice in smem_bytes of shared memory (pcg_staged_rows(cam_dim)
    rows of `stride` 4-byte words), streaming mode reads W from device
    memory every step (stride = smem_bytes = 0). cam_dim: the camera width
    the plan was made for (the kernel's occupancy and staged rows)."""

    streaming: bool
    grid: int
    block_points: torch.Tensor   # [grid+1] int32
    lanes: int                   # segment_lanes of the points that have observations
    max_slice: int               # observations of the largest slice
    stride: int
    smem_bytes: int
    cam_dim: int = 6


def pcg_plan(point_bounds: torch.Tensor, num_sms: int, blocks_per_sm: int = 1,
             streaming: bool | None = None, cam_dim: int = 6) -> PcgPlan:
    """The plan of pcg_solve on a grid of num_sms * blocks_per_sm blocks:
    slices of about N / grid observations (N = point_bounds[-1]) cut at point
    boundaries (a block starts at the first point that starts at or after
    its share), so a slice is off its share by less than one point's
    segment. Resident mode when the largest slice's staged rows
    (pcg_staged_rows(cam_dim): 20, or 26 for 8-wide cameras) fit
    PCG_SMEM_BUDGET bytes (the engines' solves), streaming when they do not
    (the merged polish: ~11,500 observations a block), unless `streaming`
    says otherwise. The kernel skips the
    empty points at the end of a block's range (the capacity padding's
    slots, all after the last observation), so they cost no block time."""
    pb = point_bounds.detach().to("cpu", torch.int64)
    P, N = pb.numel() - 1, int(pb[-1])
    lanes = segment_lanes(N, int((pb[1:] > pb[:-1]).sum()))
    grid = num_sms * blocks_per_sm
    targets = torch.arange(grid + 1, dtype=torch.int64) * N // grid
    block_points = torch.searchsorted(pb, targets)
    block_points[0], block_points[-1] = 0, P
    max_slice = int((pb[block_points[1:]] - pb[block_points[:-1]]).max())
    stride = -(-(max_slice + 3) // 4) * 4     # + up to 3 words of alignment shift
    smem = pcg_staged_rows(_width(cam_dim)) * 4 * stride
    if streaming is None:
        streaming = smem > PCG_SMEM_BUDGET
    return PcgPlan(streaming=streaming, grid=grid, block_points=block_points.to(torch.int32),
                   lanes=lanes, max_slice=max_slice, stride=0 if streaming else stride,
                   smem_bytes=0 if streaming else smem, cam_dim=cam_dim)


def pcg_launch_plan(point_bounds: torch.Tensor, streaming: bool | None = None,
                    cam_dim: int = 6) -> PcgPlan:
    """pcg_plan for the card point_bounds lies on and the kernel built for
    cam_dim: first one block per SM; where the kernel's occupancy at that
    plan's shared memory allows more co-resident blocks, the plan is cut
    again for that many in the same mode (smaller slices need no more
    shared memory). block_points goes to the card."""
    dev = point_bounds.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = pcg_plan(point_bounds, sms, 1, streaming, cam_dim)
    per_sm = ctypes.c_int(0)
    entry = _wide("sfm_pcg_blocks_per_sm", cam_dim)
    err = getattr(library(), entry)(int(plan.streaming), plan.smem_bytes, ctypes.byref(per_sm))
    if err != 0 or per_sm.value < 1:
        raise RuntimeError(f"{entry}: CUDA error {err}, {per_sm.value} blocks per SM "
                           f"with {plan.smem_bytes} bytes of shared memory")
    if per_sm.value > 1:
        plan = pcg_plan(point_bounds, sms, per_sm.value, plan.streaming, cam_dim)
    return plan._replace(block_points=plan.block_points.to(dev))


def pcg_solve(W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm, cam_bounds, cam_inv_perm,
              Hcc, M_inv, d, rhs, iterations: int, tolerance: float, plan: PcgPlan | None = None):
    """The reduced camera system's PCG solve, all `iterations` steps in one
    launch: pcg_loop's algorithm over S v = Hcc v - (W Hpp^-1 W^T) v (the
    coupling as schur_coupling_matvec computes it; the same inputs and
    contract). Hcc, M_inv [C, D, D], d, rhs [C, D] -> x [C, D]. The dot
    products are summed in a fixed per-block order: deterministic. plan
    (pcg_launch_plan, at the width D) is made here when missing. Any camera
    count: past MAX_CAMS (the merged polish) the launch counts as
    pcg_solve_big, and the plan's streaming mode reads W from device memory
    every step; D = 8 launches the 8-wide build (pcg_solve_w8, past
    MAX_CAMS pcg_solve_big_w8). The kernel
    applies the preconditioner in float64 (the plain version in the inputs'
    dtype): fp32 loses ~4 digits there on the merged polish's blocks."""
    if not on_cuda(W_t):
        return pcg_solve_plain(W_t, Hpp_inv, obs_cam, obs_point, point_bounds, cam_perm,
                               cam_bounds, Hcc, M_inv, d, rhs, iterations, tolerance)
    O, D = W_t.shape[1], _width(rhs.shape[-1])
    P = Hpp_inv.shape[0]
    C = rhs.shape[0]
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(Hpp_inv, "Hpp_inv", torch.float32, (P, 3, 3), dev)
    check(obs_cam, "obs_cam", torch.int32, (O,), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    M = cam_perm.shape[0]
    check(cam_perm, "cam_perm", torch.int32, (M,), dev)
    check(cam_bounds, "cam_bounds", torch.int32, (C + 1,), dev)
    N = cam_inv_perm.shape[0]
    check(cam_inv_perm, "cam_inv_perm", torch.int32, (N,), dev)
    if not M <= N <= O:
        raise ValueError(f"cam_perm lists {M} of {N} observations, W_t holds {O}")
    for t, name in ((Hcc, "Hcc"), (M_inv, "M_inv")):
        check(t, name, torch.float32, (C, D, D), dev)
    for t, name in ((d, "d"), (rhs, "rhs")):
        check(t, name, torch.float32, (C, D), dev)
    if iterations < 0:
        raise ValueError(f"iterations: expected >= 0, got {iterations}")
    out = torch.empty((C, D), dtype=torch.float32, device=dev)
    if C == 0:
        return out
    if plan is None:
        plan = pcg_launch_plan(point_bounds, cam_dim=D)
    check(plan.block_points, "plan.block_points", torch.int32, (plan.grid + 1,), dev)
    if plan.cam_dim != D:
        raise ValueError(f"plan: made for {plan.cam_dim}-wide cameras, the solve is {D}-wide")
    y_packed = torch.empty((M, D), dtype=torch.float32, device=dev)
    work = torch.empty((6 * D * C + 3 * plan.grid,), dtype=torch.float32, device=dev)
    launch(_wide("sfm_pcg_solve", D), _wide("pcg_solve_big" if C > MAX_CAMS else "pcg_solve", D),
           ptr(W_t), ptr(Hpp_inv), ptr(obs_cam), ptr(point_bounds), ptr(cam_inv_perm),
           ptr(cam_bounds), ptr(Hcc), ptr(M_inv), ptr(d), ptr(rhs), ptr(plan.block_points),
           O, C, int(iterations), float(tolerance), int(plan.streaming), plan.grid, plan.lanes,
           plan.stride,
           plan.smem_bytes, ptr(y_packed), ptr(work), ptr(out))
    return out


def schur_coupling_payloads_big_plain(W_t, Hpp_inv, obs_point, point_bounds, num_obs, v_obs_t):
    """Plain K10: y_o = W_o Hpp^-1_{p(o)} sum_{o' in p(o)} W_o'^T v_o' ->
    [D, O], in W_t's dtype (zero past num_obs)."""
    Wm = W_t.reshape(v_obs_t.shape[0], 3, -1)
    u_t = torch.einsum("iko,io->ko", Wm, v_obs_t)                              # [3, O]
    g = cam_segment_sum_plain(u_t, None, point_bounds)                         # [P, 3]
    h = torch.einsum("pij,pj->pi", Hpp_inv, g)
    y_t = torch.einsum("iko,ko->io", Wm, h[obs_point.long()].T)                # [D, O]
    y_t[:, num_obs:] = 0.0
    return y_t


def schur_coupling_payloads_big(W_t, Hpp_inv, obs_point, point_bounds, num_obs: int, v_obs_t):
    """Per-observation rows of the Schur coupling term: v_obs_t [D, O] is v
    gathered per observation (v.T[:, obs_cam]); u_o = W_o^T v_o, g_p the sum
    of u over point p's segment, y_o = W_o Hpp^-1_p g_p -> y_t [D, O], for
    the caller's camera reduction. Observations are sorted by point and
    point_bounds [P+1] covers [0, num_obs); rows past num_obs are zero. One
    launch of the coupling code that pcg_solve runs past MAX_CAMS cameras
    (the solver's path takes that solve). D = 8 launches the 8-wide build
    (schur_coupling_payloads_big_w8). Deterministic."""
    if not on_cuda(W_t):
        return schur_coupling_payloads_big_plain(W_t, Hpp_inv, obs_point, point_bounds,
                                                 num_obs, v_obs_t)
    O, D = W_t.shape[1], _width(v_obs_t.shape[0])
    P = Hpp_inv.shape[0]
    dev = W_t.device
    check(W_t, "W_t", torch.float32, (3 * D, O), dev)
    check(Hpp_inv, "Hpp_inv", torch.float32, (P, 3, 3), dev)
    check(obs_point, "obs_point", torch.int32, (O,), dev)
    check(point_bounds, "point_bounds", torch.int32, (P + 1,), dev)
    check(v_obs_t, "v_obs_t", torch.float32, (D, O), dev)
    if not 0 <= num_obs <= O:
        raise ValueError(f"num_obs: expected 0..{O}, got {num_obs}")
    y_t = torch.empty((D, O), dtype=torch.float32, device=dev)
    if O == 0 or P == 0:
        return y_t.zero_()
    launch(_wide("sfm_schur_coupling_payloads_big", D), _wide("schur_coupling_payloads_big", D),
           ptr(W_t), ptr(Hpp_inv), ptr(point_bounds), ptr(v_obs_t),
           O, P, int(num_obs), segment_lanes(O, P), ptr(y_t))
    return y_t
