"""Two-view minimal solvers (port of sfm_tpu/ops/solvers.py).

Every solver is batched over arbitrary leading dimensions (the JAX package
vmapped them): RANSAC scores ~1k hypotheses per pair at once. The small
linear algebra is the JAX package's closed-form / fixed-iteration versions
(inverse-iteration null vectors, Cardano eigenvalues, the analytic rank-2
3x3 SVD), not LAPACK SVDs. Where the JAX code differentiated with jacfwd
(the Gauss-Newton step of essential_minimal), the Jacobian is closed-form:
PyTorch's forward-mode AD would compute the same, but its first use in a
process loads and scripts the jvp decompositions (seconds).
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.rotations import matrix_to_aa, so3_exp, so3_hat, so3_right_jacobian


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _trace(A: torch.Tensor) -> torch.Tensor:
    return A.diagonal(dim1=-2, dim2=-1).sum(-1)


def _nan_where_failed(L: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """Cholesky of a non-PD matrix is NaN in the JAX package; keep that."""
    return torch.where((info == 0)[..., None, None], L, torch.full((), float("nan"), device=L.device))


def _nullvec9(A: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Approximate smallest eigenvector of A^T A for A [..., N, 9] by inverse
    iteration (one Cholesky of A^T A + eps I, three solve sweeps)."""
    if w is not None:
        A = A * w[..., :, None]
    AtA = A.transpose(-1, -2) @ A
    eps = 1e-7 * (_trace(AtA) + 1e-12)
    L, info = torch.linalg.cholesky_ex(AtA + eps[..., None, None] * _eye(9, A))
    L = _nan_where_failed(L, info)
    x = torch.full((*A.shape[:-2], 9, 1), 1.0 / 3.0, dtype=A.dtype, device=A.device)
    for _ in range(3):
        y = torch.linalg.solve_triangular(L, x, upper=False)
        x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
        x = x / torch.linalg.vector_norm(x, dim=-2, keepdim=True).clamp_min(1e-20)
    return x[..., 0]


def _eigvals3_sym(A: torch.Tensor):
    """Eigenvalues of symmetric 3x3 A, descending (trigonometric Cardano)."""
    q = _trace(A) / 3.0
    B = A - q[..., None, None] * _eye(3, A)
    p2 = (B * B).sum((-1, -2)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    r = (detB / (2.0 * p * p * p)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    return lam_hi, lam_mid, lam_lo


def _largest_column(P: torch.Tensor) -> torch.Tensor:
    """Unit vector along the column of P [..., 3, 3] with the largest norm."""
    pick = torch.argmax((P * P).sum(-2), dim=-1)
    v = torch.gather(P, -1, pick[..., None, None].expand(*P.shape[:-1], 1))[..., 0]
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-20)


def _smallest_eigvec3(A: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric 3x3 A:
    (A - l0 I)(A - l1 I) annihilates the two larger eigenspaces."""
    l0, l1, _ = _eigvals3_sym(A)
    eye = _eye(3, A)
    return _largest_column((A - l0[..., None, None] * eye) @ (A - l1[..., None, None] * eye))


def _orthobasis_from_null(v2: torch.Tensor):
    """Two unit vectors completing v2 to a right-handed orthonormal basis."""
    a = torch.nn.functional.one_hot(torch.argmin(v2.abs(), dim=-1), 3).to(v2.dtype)
    v0 = torch.linalg.cross(v2, a)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True).clamp_min(1e-20)
    return v0, torch.linalg.cross(v2, v0)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def _outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., :, None] * b[..., None, :]


def svd3_twoview(M: torch.Tensor):
    """SVD M = U diag(s) V^T of an (approximately) rank-2 3x3 matrix from its
    analytic null directions; U and V are proper rotations."""
    v2 = _smallest_eigvec3(M.transpose(-1, -2) @ M)
    v0, v1 = _orthobasis_from_null(v2)
    m0 = _mv(M, v0)
    m1 = _mv(M, v1)
    s0 = torch.linalg.vector_norm(m0, dim=-1)
    u0 = m0 / s0.clamp_min(1e-20)[..., None]
    m1p = m1 - _dot(m1, u0)[..., None] * u0
    s1 = torch.linalg.vector_norm(m1p, dim=-1)
    u1 = m1p / s1.clamp_min(1e-20)[..., None]
    u2 = torch.linalg.cross(u0, u1)
    s2 = _dot(u2, _mv(M, v2)).abs()
    U = torch.stack([u0, u1, u2], dim=-1)
    V = torch.stack([v0, v1, v2], dim=-1)
    return U, torch.stack([s0, s1, s2], dim=-1), V


def project_essential(E: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix: singular values -> (s, s, 0), s = mean."""
    U, s, V = svd3_twoview(E)
    sm = (s[..., 0] + s[..., 1]) * 0.5
    return sm[..., None, None] * (_outer(U[..., 0], V[..., 0]) + _outer(U[..., 1], V[..., 1]))


def refine_essential_gn(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor,
                        iters: int = 5) -> torch.Tensor:
    """Gauss-Newton polish of one E [3, 3] on weighted correspondences x1, x2
    [N, 2] (normalized camera coordinates), w [N], minimizing the weighted
    Sampson error: the full 9-vector, projected back to the essential
    manifold each step, the best iterate kept (sfm_tpu's refine_essential_gn,
    the Jacobian by forward-mode autodiff as there)."""
    ones = torch.ones_like(x1[:, :1])
    x1h, x2h = torch.cat([x1, ones], -1), torch.cat([x2, ones], -1)

    def sampson_res(evec):
        Em = evec.reshape(3, 3)
        Fx1 = x1h @ Em.T
        Ftx2 = x2h @ Em
        num = (x2h * Fx1).sum(-1)
        den = torch.sqrt(Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2 + 1e-12)
        return w * num / den

    def project_manifold(evec):
        U, _, V = svd3_twoview(evec.reshape(3, 3))
        return (_outer(U[:, 0], V[:, 0]) + _outer(U[:, 1], V[:, 1])).reshape(9)

    def cost(evec):
        r = sampson_res(evec)
        return (r * r).sum()

    evec = project_manifold(E.reshape(9))
    best, best_cost = evec, cost(evec)
    eye = torch.eye(9, dtype=E.dtype, device=E.device)
    for _ in range(iters):
        J = torch.func.jacfwd(sampson_res)(evec)    # [N, 9]
        r = sampson_res(evec)
        step = torch.linalg.solve(J.T @ J + 1e-8 * eye, J.T @ r)
        evec = project_manifold(evec - step)
        c = cost(evec)
        take = c < best_cost
        best = torch.where(take, evec, best)
        best_cost = torch.where(take, c, best_cost)
    return best.reshape(3, 3)


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form 3x3 inverse (adjugate / det)."""
    m = [[M[..., i, j] for j in range(3)] for i in range(3)]
    c00 = m[1][1] * m[2][2] - m[1][2] * m[2][1]
    c01 = m[0][2] * m[2][1] - m[0][1] * m[2][2]
    c02 = m[0][1] * m[1][2] - m[0][2] * m[1][1]
    c10 = m[1][2] * m[2][0] - m[1][0] * m[2][2]
    c11 = m[0][0] * m[2][2] - m[0][2] * m[2][0]
    c12 = m[0][2] * m[1][0] - m[0][0] * m[1][2]
    c20 = m[1][0] * m[2][1] - m[1][1] * m[2][0]
    c21 = m[0][1] * m[2][0] - m[0][0] * m[2][1]
    c22 = m[0][0] * m[1][1] - m[0][1] * m[1][0]
    det = m[0][0] * c00 + m[0][1] * c10 + m[0][2] * c20
    det = torch.where(det.abs() < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c10, c11, c12], -1),
                       torch.stack([c20, c21, c22], -1)], -2)
    return adj / det[..., None, None]


def hartley_normalize(x: torch.Tensor, w: torch.Tensor | None = None):
    """Translate to the centroid, scale to mean distance sqrt(2).
    x [..., N, 2], w [..., N] -> (x_norm, T [..., 3, 3]) with x_norm_h = T x_h."""
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wsum = w.sum(-1).clamp_min(1e-8)
    mean = (x * w[..., None]).sum(-2) / wsum[..., None]
    d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1) + 1e-12)
    scale = 2.0 ** 0.5 / ((d * w).sum(-1) / wsum).clamp_min(1e-8)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[..., 0]], -1),
        torch.stack([zero, scale, -scale * mean[..., 1]], -1),
        torch.stack([zero, zero, one], -1),
    ], -2)
    return (x - mean[..., None, :]) * scale[..., None, None], T


def _epipolar_rows(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Rows of the 8-point constraint x2^T F x1 = 0: [..., N, 9]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)


def fundamental_8pt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """Hartley-normalized 8-point fundamental matrix from [..., N>=8, 2]
    pixel pairs, rank 2 by removing the component along the analytic left
    and right null directions, scaled to |F[2, 2]| = 1 with its sign."""
    x1n, T1 = hartley_normalize(x1, w)
    x2n, T2 = hartley_normalize(x2, w)
    F = _nullvec9(_epipolar_rows(x1n, x2n), w).reshape(*x1.shape[:-2], 3, 3)
    u2 = _smallest_eigvec3(F @ F.transpose(-1, -2))
    v2 = _smallest_eigvec3(F.transpose(-1, -2) @ F)
    F = F - _outer(u2, v2) * _dot(u2, _mv(F, v2))[..., None, None]
    F = T2.transpose(-1, -2) @ F @ T1
    f22 = F[..., 2, 2]
    return F / f22.abs().clamp_min(1e-12)[..., None, None] * torch.sign(f22 + 1e-30)[..., None, None]


def essential_8pt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """8-point essential matrix from [..., N>=8, 2] normalized coords,
    projected to singular values (1, 1, 0)."""
    E = _nullvec9(_epipolar_rows(x1, x2), w).reshape(*x1.shape[:-2], 3, 3)
    U, _, V = svd3_twoview(E)
    return _outer(U[..., 0], V[..., 0]) + _outer(U[..., 1], V[..., 1])


def essential_from_rt(params: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R from [..., 6] = [rvec, t] (t normalized to the sphere)."""
    rv, t = params[..., :3], params[..., 3:]
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-9)
    return so3_hat(t) @ so3_exp(rv)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _sampson_signed_grad(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Signed Sampson residual [..., N] and its gradient d s / d E [..., N, 3, 3]."""
    x1h, x2h = _homog(x1), _homog(x2)
    a = x1h @ E.transpose(-1, -2)                                     # E x1
    b = x2h @ E                                                       # E^T x2
    num = (x2h * a).sum(-1)
    den = torch.sqrt(a[..., 0] ** 2 + a[..., 1] ** 2 + b[..., 0] ** 2 + b[..., 1] ** 2 + 1e-12)
    keep2 = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    k = (num / den**3)[..., None, None]
    G = (_outer(x2h, x1h) / den[..., None, None]
         - k * (_outer(a * keep2, x1h) + _outer(x2h, b * keep2)))
    return num / den, G


def _essential_param_grad(p: torch.Tensor) -> torch.Tensor:
    """d essential_from_rt(p) / d p_k for p [..., 6] -> [..., 6, 3, 3]."""
    rv, t = p[..., :3], p[..., 3:]
    tn = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    active = tn > 1e-9
    u = t / tn.clamp_min(1e-9)
    R = so3_exp(rv)
    T = so3_hat(u)
    dR = R[..., None, :, :] @ so3_hat(so3_right_jacobian(rv).transpose(-1, -2))     # [..., 3, 3, 3]
    eye = _eye(3, p)
    P = torch.where(active[..., None], (eye - _outer(u, u)) / tn.clamp_min(1e-9)[..., None], eye / 1e-9)
    dE_t = so3_hat(P.transpose(-1, -2)) @ R[..., None, :, :]                     # du/dt_k = P[:, k]
    return torch.cat([T[..., None, :, :] @ dR, dE_t], dim=-3)


def essential_minimal(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None,
                      gn_iters: int = 6) -> torch.Tensor:
    """8-pt E, decomposed to (R, t), then Gauss-Newton on the Sampson
    residuals in the (rvec, t) parametrization — exactly on the E manifold.
    x1/x2 [..., N, 2], w [..., N] -> E [..., 3, 3]."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    E0 = essential_8pt(x1, x2, w)
    R, t, _ = decompose_essential(E0, x1, x2, w > 0)
    p = torch.cat([matrix_to_aa(R), t], dim=-1)
    for _ in range(gn_iters):
        s, G = _sampson_signed_grad(essential_from_rt(p), x1, x2)
        r = w * s
        J = w[..., None] * torch.einsum("...nij,...kij->...nk", G, _essential_param_grad(p))
        A = J.transpose(-1, -2) @ J + 1e-8 * _eye(6, p)
        step = torch.linalg.solve_ex(A, J.transpose(-1, -2) @ r[..., None])[0][..., 0]
        p = p - step
    return essential_from_rt(p)


def homography_4pt(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None) -> torch.Tensor:
    """DLT homography from [..., N>=4, 2] pixel pairs, Hartley-normalized."""
    x1n, T1 = hartley_normalize(x1, w)
    x2n, T2 = hartley_normalize(x2, w)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u1)
    o = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([z, z, z, u1, v1, o, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    ww = None if w is None else torch.cat([w, w], dim=-1)
    H = _nullvec9(A, ww).reshape(*x1.shape[:-2], 3, 3)
    H = _inv3(T2) @ H @ T1
    h22 = H[..., 2, 2]
    return H / torch.where(h22.abs() > 1e-12, h22, torch.full_like(h22, 1e-12))[..., None, None]


def sampson_error(F: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared first-order Sampson error of x2^T F x1 = 0: [..., N]."""
    x1h, x2h = _homog(x1), _homog(x2)
    Fx1 = x1h @ F.transpose(-1, -2)
    Ftx2 = x2h @ F
    num = (x2h * Fx1).sum(-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / den.clamp_min(1e-12)


def homography_error(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error |H x1 - x2|^2: [..., N]."""
    p = _homog(x1) @ H.transpose(-1, -2)
    z = p[..., 2:3]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return ((p[..., :2] / z - x2) ** 2).sum(-1)


def triangulate_linear(R1, t1, R2, t2, x1, x2) -> torch.Tensor:
    """Two-view DLT triangulation in normalized coords: smallest eigenvector
    of the 4x4 A^T A per correspondence. x1/x2 [N, 2] -> [N, 3]."""
    P1 = torch.cat([R1, t1[:, None]], dim=1)
    P2 = torch.cat([R2, t2[:, None]], dim=1)

    def rows(P, x):
        return torch.stack([x[:, 0:1] * P[2][None, :] - P[0][None, :],
                            x[:, 1:2] * P[2][None, :] - P[1][None, :]], dim=1)

    A = torch.cat([rows(P1, x1), rows(P2, x2)], dim=1)
    AtA = A.transpose(1, 2) @ A
    _, V = torch.linalg.eigh(AtA)
    Xh = V[..., 0]
    w = Xh[:, 3:4]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[:, :3] / w


def two_view_depths(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor):
    """Closed-form ray depths (z1, z2) [..., N] under pose (R, t): the 2x2
    normal equations of [R f1, -f2][z1; z2] = -t."""
    f1, f2 = _homog(x1), _homog(x2)
    a = f1 @ R.transpose(-1, -2)
    aa = (a * a).sum(-1)
    af = (a * f2).sum(-1)
    ff = (f2 * f2).sum(-1)
    at = (a * t[..., None, :]).sum(-1)
    ft = (f2 * t[..., None, :]).sum(-1)
    det = aa * ff - af * af
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    z1 = (-at * ff + af * ft) / det
    z2 = (-af * at + aa * ft) / det
    return z1, z2


_W90 = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def decompose_essential(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor):
    """E -> (R, t, positive-depth count) by the cheirality vote over the four
    (R, +-t) candidates; camera 1 at identity, x1/x2 normalized coords."""
    U, _, V = svd3_twoview(E)
    Vt = V.transpose(-1, -2)
    W = torch.tensor(_W90, dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., 2]
    cands_R = torch.stack([Ra, Ra, Rb, Rb], dim=-3)                 # [..., 4, 3, 3]
    cands_t = torch.stack([t, -t, t, -t], dim=-2)                   # [..., 4, 3]
    z1, z2 = two_view_depths(cands_R, cands_t, x1[..., None, :, :], x2[..., None, :, :])
    n = ((z1 > 0) & (z2 > 0) & mask[..., None, :]).sum(-1)          # [..., 4]
    best = torch.argmax(n, dim=-1)
    R = torch.gather(cands_R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    tt = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return R, tt, torch.gather(n, -1, best[..., None])[..., 0]


def decompose_essential_all(E: torch.Tensor):
    """All four (R, t) interpretations of E, unvoted: ([..., 4, 3, 3],
    [..., 4, 3]), in decompose_essential's candidate order. The bootstrap
    pose search scores each by what it triangulates."""
    U, _, V = svd3_twoview(E)
    Vt = V.transpose(-1, -2)
    W = torch.tensor(_W90, dtype=E.dtype, device=E.device)
    Ra = U @ W @ Vt
    Rb = U @ W.T @ Vt
    t = U[..., 2]
    return torch.stack([Ra, Ra, Rb, Rb], dim=-3), torch.stack([t, -t, t, -t], dim=-2)


def decompose_homography_all(Hn: torch.Tensor):
    """All four (R, t) interpretations of a calibrated homography, unvoted:
    ([..., 4, 3, 3], [..., 4, 3]), in decompose_homography's candidate
    order; the physical-solution choice is left to the caller."""
    U, V, s, d1, d2, d3, xa, xc, sin_t, cos_t = _homography_frame(Hn)
    cands = [_homography_candidate(U, V, s, d1, d3, xa, xc, sin_t, cos_t, e1, e3)
             for e1 in (1.0, -1.0) for e3 in (1.0, -1.0)]
    return torch.stack([c[0] for c in cands], -3), torch.stack([c[1] for c in cands], -2)


def _homography_frame(Hn: torch.Tensor):
    """Shared Faugeras/Zhang quantities of a calibrated homography."""
    A = Hn.transpose(-1, -2) @ Hn
    l0, l1, l2 = _eigvals3_sym(A)
    l0 = l0.clamp_min(1e-20)
    l1 = torch.minimum(l1.clamp_min(1e-20), l0)
    l2 = torch.minimum(l2.clamp_min(1e-20), l1)
    eye = _eye(3, A)

    def eigvec(la, lb):
        return _largest_column((A - la[..., None, None] * eye) @ (A - lb[..., None, None] * eye))

    v0 = eigvec(l1, l2)
    v2 = eigvec(l0, l1)
    v1 = torch.linalg.cross(v2, v0)
    V = torch.stack([v0, v1, v2], dim=-1)
    d1, d2, d3 = torch.sqrt(l0), torch.sqrt(l1), torch.sqrt(l2)
    U = torch.stack([_mv(Hn, v0) / d1[..., None], _mv(Hn, v1) / d2[..., None],
                     _mv(Hn, v2) / d3[..., None]], dim=-1)
    s = torch.sign(_dot(U[..., 0], torch.linalg.cross(U[..., 1], U[..., 2])))
    denom = (d1 * d1 - d3 * d3).clamp_min(1e-20)
    xa = torch.sqrt((d1 * d1 - d2 * d2).clamp_min(0.0) / denom)
    xc = torch.sqrt((d2 * d2 - d3 * d3).clamp_min(0.0) / denom)
    sin_t = (d1 - d3) * xa * xc / d2
    cos_t = (d1 * xc * xc + d3 * xa * xa) / d2
    return U, V, s, d1, d2, d3, xa, xc, sin_t, cos_t


def _homography_candidate(U, V, s, d1, d3, xa, xc, sin_t, cos_t, e1: float, e3: float):
    st = e1 * e3 * sin_t
    zero, one = torch.zeros_like(cos_t), torch.ones_like(cos_t)
    Rp = torch.stack([torch.stack([cos_t, zero, -st], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([st, zero, cos_t], -1)], -2)
    R = s[..., None, None] * (U @ Rp @ V.transpose(-1, -2))
    k = d1 - d3
    tp = torch.stack([k * e1 * xa, zero, -k * e3 * xc], -1)
    t = _mv(U, tp)
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-20)
    n = V[..., 0] * (e1 * xa)[..., None] + V[..., 2] * (e3 * xc)[..., None]
    return R, t, n


def decompose_homography(Hn: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor):
    """Calibrated homography -> relative pose (Faugeras/Zhang), the physical
    one of four solutions picked by the positive-depth + plane-visibility
    vote. Returns (R, unit t, plane normal n, votes, valid); valid is False
    for (near-)pure rotations."""
    U, V, s, d1, d2, d3, xa, xc, sin_t, cos_t = _homography_frame(Hn)
    valid = (d1 - d3) / d2.clamp_min(1e-20) > 5e-3
    x1h = _homog(x1)
    out = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            R, t, n = _homography_candidate(U, V, s, d1, d3, xa, xc, sin_t, cos_t, e1, e3)
            side = _mv(x1h, n)                                       # [..., N]
            flip = torch.sign(torch.where(mask, side, torch.zeros_like(side)).sum(-1))
            flip = torch.where(flip == 0, torch.ones_like(flip), flip)
            n = n * flip[..., None]
            side = side * flip[..., None]
            z1, z2 = two_view_depths(R, t, x1, x2)
            votes = ((z1 > 0) & (z2 > 0) & mask & (side > 0)).sum(-1)
            out.append((R, t, n, votes))
    Rs = torch.stack([o[0] for o in out], -3)
    ts = torch.stack([o[1] for o in out], -2)
    ns = torch.stack([o[2] for o in out], -2)
    vs = torch.stack([o[3] for o in out], -1)
    best = torch.argmax(vs, dim=-1)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    n = torch.gather(ns, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return R, t, n, torch.gather(vs, -1, best[..., None])[..., 0], valid
