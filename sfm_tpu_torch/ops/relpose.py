"""Batched two-view relative-pose refinement by reprojection (port of
sfm_tpu/ops/relpose.py; SURVEY.md §2.4).

RANSAC hands every verified edge an (R, t) from the essential/homography
solve whose inner objective is epipolar (algebraic) error. On short-baseline
edges the epipolar surface is shallow along the rotation/translation trade
direction, and its minimizer is offset from the reprojection optimum.
Rotation averaging integrates per-edge error around the whole graph, so
halving edge noise halves the pose-graph drift floor: this op is the
pre-averaging pass of the global engine.

Method: per-edge joint two-view bundle adjustment, batched over edges. Each
iteration linearizes the symmetric reprojection cost over (omega, dt, {X_k})
with closed-form Jacobians, Schur-eliminates the per-point 3x3 blocks (the
same elimination the full BA uses, shrunk to one edge), solves the damped
6x6 pose system, back-substitutes the point updates, and restores the
||t|| = 1 gauge by scaling t AND the points together (projective scale
invariance keeps the residuals unchanged under that joint rescale).

Everything is [E, K, ...] einsum batches on the inputs' device; K is a fixed
inlier capacity with a mask, filled by strided subsampling on the host. fp32
throughout: normalized camera coords keep conditioning mild.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfm_tpu_torch.geometry.rotations import so3_exp, so3_hat


def _proj_jac(P: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Perspective projection p = P[:2]/P[2] and its Jacobian [..., 2, 3]."""
    pz = P[..., 2]
    z = torch.where(pz.abs() < 1e-6,
                    torch.where(pz < 0, torch.full_like(pz, -1e-6), torch.full_like(pz, 1e-6)), pz)
    p = P[..., :2] / z[..., None]
    zero = torch.zeros_like(z)
    inv = 1.0 / z
    J = torch.stack([
        torch.stack([inv, zero, -P[..., 0] * inv * inv], -1),
        torch.stack([zero, inv, -P[..., 1] * inv * inv], -1),
    ], -2)
    return p, J


def _huber_weight(r: torch.Tensor, huber: float) -> torch.Tensor:
    n = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(n <= huber, torch.ones_like(n), huber / n.clamp_min(1e-12))


def refine_relative_poses(
    x1: torch.Tensor,      # [E, K, 2] normalized camera coords, image i
    x2: torch.Tensor,      # [E, K, 2] normalized camera coords, image j
    mask: torch.Tensor,    # [E, K] bool — live correspondence slots
    rvec0: torch.Tensor,   # [E, 3] initial relative rotation (R_ij = R_j R_i^T)
    tvec0: torch.Tensor,   # [E, 3] initial relative translation (any scale)
    huber: float = 0.008,  # Huber scale on image-2 residuals, normalized units
    iters: int = 10,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (rvec [E, 3], unit tvec [E, 3], rms [E] in normalized units).

    rms is the masked image-2 reprojection RMS at the refined pose —
    callers use it to weight or reject edges. Edges whose mask has < 5 live
    slots are returned unchanged (their 6x6 systems would be rank-starved).
    """
    E, K = mask.shape
    f32 = torch.float32
    dev = x1.device
    x1 = x1.to(f32)
    x2 = x2.to(f32)
    m = mask.to(f32)
    ones = torch.ones((E, K, 1), dtype=f32, device=dev)
    h1 = torch.cat([x1, ones], -1)
    v1 = h1 / torch.linalg.vector_norm(h1, dim=-1, keepdim=True)
    h2 = torch.cat([x2, ones], -1)

    R0 = so3_exp(rvec0.to(f32))
    t0 = tvec0.to(f32)
    t0 = t0 / torch.linalg.vector_norm(t0, dim=-1, keepdim=True).clamp_min(1e-12)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    eye6 = torch.eye(6, dtype=f32, device=dev)

    def triangulate(R, t):
        """Midpoint of ray1 (origin, v1) and ray2 (c2, v2) in camera-1 frame."""
        c2 = -torch.einsum("eji,ej->ei", R, t)
        v2 = torch.einsum("eji,ekj->eki", R, h2)
        v2 = v2 / torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
        a = (v1 * v1).sum(-1)
        b = (v1 * v2).sum(-1)
        c = (v2 * v2).sum(-1)
        e1 = torch.einsum("eki,ei->ek", v1, c2)
        e2 = torch.einsum("eki,ei->ek", v2, c2)
        den = a * c - b * b
        den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
        d1 = (e1 * c - b * e2) / den
        d2 = (b * e1 - a * e2) / den
        return 0.5 * (v1 * d1[..., None] + c2[:, None, :] + v2 * d2[..., None])

    def step(R, t, X):
        """One joint GN step with Schur elimination of the points."""
        p1, J1n = _proj_jac(X)
        r1 = x1 - p1
        Y = torch.einsum("eij,ekj->eki", R, X) + t[:, None, :]
        p2, J2n = _proj_jac(Y)
        r2 = x2 - p2
        # Huber IRLS weight per residual pair + cheirality/mask gates.
        gate = m * (X[..., 2] > 1e-4) * (Y[..., 2] > 1e-4)
        w1 = _huber_weight(r1, huber) * gate
        w2 = _huber_weight(r2, huber) * gate

        # Jacobians of the PREDICTIONS (r_new = r - J d).
        A1 = J1n                                         # dproj1/dX   [E,K,2,3]
        A2 = torch.einsum("ekab,ebc->ekac", J2n, R)      # dproj2/dX
        # Left-perturbation R <- exp(omega) R: dY = [omega]x (Y - t).
        Bw = -torch.einsum("ekab,ekbc->ekac", J2n, so3_hat(Y - t[:, None, :]))
        B = torch.cat([Bw, J2n], -1)                     # dproj2/d(w,t) [E,K,2,6]

        Hpp = (w1[..., None, None] * torch.einsum("ekai,ekaj->ekij", A1, A1)
               + w2[..., None, None] * torch.einsum("ekai,ekaj->ekij", A2, A2))
        Hpc = w2[..., None, None] * torch.einsum("ekai,ekaj->ekij", A2, B)
        Hcc = torch.einsum("ek,ekai,ekaj->eij", w2, B, B)
        gp = (w1[..., None] * torch.einsum("ekai,eka->eki", A1, r1)
              + w2[..., None] * torch.einsum("ekai,eka->eki", A2, r2))
        gc = torch.einsum("ek,ekai,eka->ei", w2, B, r2)

        trp = Hpp.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
        Hpp = Hpp + (1e-4 * trp + 1e-10) * eye3
        Hpp = torch.where(gate[..., None, None] > 0, Hpp, eye3)
        gp = torch.where(gate[..., None] > 0, gp, torch.zeros_like(gp))
        Hpp_inv = torch.linalg.inv(Hpp)

        HpcT_Hinv = torch.einsum("ekji,ekjl->ekil", Hpc, Hpp_inv)        # [E,K,6,3]
        S = Hcc - torch.einsum("ekil,ekln->ein", HpcT_Hinv, Hpc)
        rhs = gc - torch.einsum("ekil,ekl->ei", HpcT_Hinv, gp)
        trc = S.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
        S = S + (1e-6 * trc + 1e-12) * eye6
        d = torch.linalg.solve(S, rhs[..., None])[..., 0]
        dw, dt = d[:, :3], d[:, 3:]
        nw = torch.linalg.vector_norm(dw, dim=-1, keepdim=True)
        clip = (math.radians(10.0) / nw.clamp_min(1e-12)).clamp_max(1.0)
        dw = dw * clip
        dt = dt * clip
        dX = torch.einsum("ekij,ekj->eki", Hpp_inv, gp - torch.einsum("ekij,ej->eki", Hpc, d))
        R_new = so3_exp(dw) @ R
        t_new = t + dt
        X_new = X + dX
        # Gauge: scaling t and X together leaves every residual unchanged.
        s = torch.linalg.vector_norm(t_new, dim=-1, keepdim=True).clamp_min(1e-9)
        return R_new, t_new / s, X_new / s[:, None, :]

    R, t, X = R0, t0, triangulate(R0, t0)
    for _ in range(iters):
        R, t, X = step(R, t, X)

    # Rank guard: < 5 live correspondences cannot support a 6-dof step.
    enough = mask.sum(-1) >= 5
    R = torch.where(enough[:, None, None], R, R0)
    t = torch.where(enough[:, None], t, t0)

    X = triangulate(R, t)
    Y = torch.einsum("eij,ekj->eki", R, X) + t[:, None, :]
    p2, _ = _proj_jac(Y)
    r2 = ((x2 - p2) ** 2).sum(-1) * m
    rms = torch.sqrt(r2.sum(-1) / m.sum(-1).clamp_min(1.0))

    # Rotation matrix -> angle-axis without leaving the device.
    tr_R = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    ang = torch.arccos(tr_R)
    ax = torch.stack([R[:, 2, 1] - R[:, 1, 2],
                      R[:, 0, 2] - R[:, 2, 0],
                      R[:, 1, 0] - R[:, 0, 1]], -1)
    sin_a = torch.linalg.vector_norm(ax, dim=-1) / 2.0
    scale = torch.where(sin_a < 1e-7, torch.full_like(ang, 0.5), ang / (2.0 * sin_a).clamp_min(1e-12))
    rvec = ax * scale[:, None]
    return rvec, t, rms


def gather_edge_correspondences(
    graph, feats_xy: np.ndarray, intrinsics: np.ndarray,
    edge_ids: np.ndarray, capacity: int = 128,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side packing: per-edge inlier keypoints -> fixed-capacity
    normalized-coordinate batches (strided subsample past `capacity`).

    Returns (x1 [E, K, 2], x2 [E, K, 2], mask [E, K]) as float32/bool.
    Applies the iterative 2-term undistortion when k1/k2 are present so the
    device op works in ideal normalized coordinates.
    """
    E = len(edge_ids)
    K = capacity
    x1 = np.zeros((E, K, 2), np.float32)
    x2 = np.zeros((E, K, 2), np.float32)
    mask = np.zeros((E, K), bool)

    def _norm(img: int, kp: np.ndarray) -> np.ndarray:
        intr = intrinsics[img]
        xy = (feats_xy[img, kp] - intr[2:4]) / intr[0:2]
        k1, k2 = float(intr[4]), float(intr[5])
        if k1 or k2:
            x = xy.copy()
            for _ in range(4):
                r2 = np.sum(x * x, axis=-1)
                x = xy / (1.0 + k1 * r2 + k2 * r2 * r2)[..., None]
            xy = x
        return xy

    for row, e in enumerate(np.asarray(edge_ids)):
        inl = np.where(graph.inlier[e])[0]
        if len(inl) > K:
            inl = inl[np.linspace(0, len(inl) - 1, K).astype(np.int64)]
        i, j = graph.pairs[e]
        x1[row, :len(inl)] = _norm(int(i), graph.idx_i[e, inl])
        x2[row, :len(inl)] = _norm(int(j), graph.idx_j[e, inl])
        mask[row, :len(inl)] = True
    return x1, x2, mask
