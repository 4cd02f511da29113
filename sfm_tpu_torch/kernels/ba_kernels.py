"""K3 fused_ne_payloads, K5 fused_cost_sums and K9 cam_segment_sum
(csrc/ba_kernels.cu, csrc/ba_project.cuh).

Replace sfm_tpu/kernels/schur_spmv.py fused_ne_payloads, fused_cost_sums and
cam_segment_sum. Layouts are feature-major ([rows, O]) wherever a kernel
reads or writes per-observation rows, so a warp touches contiguous memory.

Per-observation inputs shared by K3 and K5:
  obs_cam  [O] int32      camera of each observation
  pts_t    [3, O] f32     its point, gathered (refreshed every LM iteration)
  static_t [5, O] f32     u, v, weight, camera-free, point-free (per solve)
  cams     [C, 6] f32     rvec, tvec;  intr [C, 6] f32: fx fy cx cy k1 k2
  z_floor  0-d f32 tensor or None: near-plane gate at the current parameters
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.losses import robust_cost, robust_weight
from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr

LOSS_CODES = {"none": 0, "huber": 1, "cauchy": 2}
NE_CAM_ROWS = 42   # vec(Jc^T Jc) (36) then -Jc^T r (6)
NE_W_ROWS = 18     # vec(W = Jc^T Jp), row-major 6x3
NE_PT_ROWS = 9     # sym(Jp^T Jp) (00, 01, 02, 11, 12, 22) then -Jp^T r
_STATIC_ROWS = 5
_SYM3 = ([0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2])


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


def projection(cams_o, intr_o, pts_o, uv):
    """Shared per-observation projection (mirror of schur_spmv._project_rows
    and of csrc/ba_project.cuh): cams_o/intr_o [O, 6], pts_o [O, 3],
    uv [O, 2]. Returns a dict of the intermediates the NE Jacobians need."""
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
    return dict(r=torch.stack([ru, rv], -1), xc2=xc2, x=x, y=y, r2=r2, s=s, inv_z=inv_z, R=R)


def _gate(w: torch.Tensor, depth: torch.Tensor, z_floor) -> torch.Tensor:
    if z_floor is None:
        return w
    return torch.where(depth > z_floor, w, torch.zeros((), device=w.device))


def _check_obs_inputs(obs_cam, pts_t, static_t, cams, intr, z_floor):
    O = obs_cam.shape[0]
    C = cams.shape[0]
    dev = obs_cam.device
    check(obs_cam, "obs_cam", torch.int32, (O,), dev)
    check(pts_t, "pts_t", torch.float32, (3, O), dev)
    check(static_t, "static_t", torch.float32, (_STATIC_ROWS, O), dev)
    check(cams, "cams", torch.float32, (C, 6), dev)
    check(intr, "intr", torch.float32, (C, 6), dev)
    if z_floor is not None:
        check(z_floor, "z_floor", torch.float32, (), dev)
    return O


def fused_ne_payloads_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """Plain K3: (w_t [18, O], yp_t [9, O], cam_t [42, O])."""
    from sfm_tpu_torch.ba.core import residual_jac_analytic

    oc = obs_cam.long()
    O = oc.shape[0]
    r, Jc, Jp, depth = residual_jac_analytic(cams[oc], pts_t.T, intr[oc], static_t[:2].T)
    w = _gate(static_t[2], depth, z_floor)
    s = (r * r).sum(-1)
    sw = torch.sqrt((robust_weight(s, loss, scale) * w).clamp_min(0.0))
    rw = r * sw[:, None]
    Jc = Jc * (sw * static_t[3])[:, None, None]
    Jp = Jp * (sw * static_t[4])[:, None, None]
    cam_t = torch.cat([torch.einsum("oai,oaj->oij", Jc, Jc).reshape(O, 36),
                       -torch.einsum("oai,oa->oi", Jc, rw)], 1).T.contiguous()
    w_t = torch.einsum("oai,oaj->oij", Jc, Jp).reshape(O, 18).T.contiguous()
    hpp = torch.einsum("oai,oaj->oij", Jp, Jp)[:, _SYM3[0], _SYM3[1]]
    yp_t = torch.cat([hpp, -torch.einsum("oai,oa->oi", Jp, rw)], 1).T.contiguous()
    return w_t, yp_t, cam_t


def fused_ne_payloads(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """Per-observation normal-equation payloads, feature-major:
    W = Jc^T Jp [18, O], point payload [9, O], camera payload [42, O]
    (IRLS-weighted, near-plane gated, freeze masks applied)."""
    if not on_cuda(obs_cam):
        return fused_ne_payloads_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss, scale)
    O = _check_obs_inputs(obs_cam, pts_t, static_t, cams, intr, z_floor)
    dev = obs_cam.device
    w_t = torch.empty((NE_W_ROWS, O), dtype=torch.float32, device=dev)
    yp_t = torch.empty((NE_PT_ROWS, O), dtype=torch.float32, device=dev)
    cam_t = torch.empty((NE_CAM_ROWS, O), dtype=torch.float32, device=dev)
    launch("sfm_fused_ne_payloads", "fused_ne_payloads",
           ptr(obs_cam), ptr(pts_t), ptr(static_t), ptr(cams), ptr(intr), ptr(z_floor),
           O, LOSS_CODES[loss], float(scale), ptr(w_t), ptr(yp_t), ptr(cam_t))
    return w_t, yp_t, cam_t


def fused_cost_sums_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """Plain K5: tensor [2] = (sum robust_cost(|r|^2) * w, sum w)."""
    oc = obs_cam.long()
    pr = projection(cams[oc], intr[oc], pts_t.T, static_t[:2].T)
    w = _gate(static_t[2], pr["xc2"], z_floor)
    c = robust_cost((pr["r"] ** 2).sum(-1), loss, scale) * w
    return torch.stack([c.sum(), w.sum()])


_COST_THREADS = 256


def fused_cost_sums(obs_cam, pts_t, static_t, cams, intr, z_floor, loss: str, scale: float):
    """Robustified cost and weight sums over observations -> tensor [2]."""
    if not on_cuda(obs_cam):
        return fused_cost_sums_plain(obs_cam, pts_t, static_t, cams, intr, z_floor, loss, scale)
    O = _check_obs_inputs(obs_cam, pts_t, static_t, cams, intr, z_floor)
    dev = obs_cam.device
    nblocks = max(1, -(-O // _COST_THREADS))
    partials = torch.empty((nblocks, 2), dtype=torch.float32, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    launch("sfm_fused_cost_sums", "fused_cost_sums",
           ptr(obs_cam), ptr(pts_t), ptr(static_t), ptr(cams), ptr(intr), ptr(z_floor),
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


def _block_threads(O: int, S: int) -> int:
    t = 32
    while t < 256 and t < O // max(S, 1):
        t *= 2
    return t


def cam_segment_sum(values_t, perm, bounds):
    """Deterministic sorted-segment reduction: values_t [K, O] f32, perm [O]
    int32 (a permutation sorting observations by segment; None when they
    already are), bounds [S+1] int32 -> [S, K]."""
    if not on_cuda(values_t):
        return cam_segment_sum_plain(values_t, perm, bounds)
    K, O = values_t.shape
    S = bounds.shape[0] - 1
    dev = values_t.device
    check(values_t, "values_t", torch.float32, (K, O), dev)
    check(bounds, "bounds", torch.int32, (S + 1,), dev)
    if perm is not None:
        check(perm, "perm", torch.int32, (O,), dev)
    out = torch.empty((S, K), dtype=torch.float32, device=dev)
    if S == 0 or K == 0:
        return out
    launch("sfm_segment_sum", "cam_segment_sum",
           ptr(values_t), ptr(perm), ptr(bounds), O, K, S, _block_threads(O, S), ptr(out))
    return out
