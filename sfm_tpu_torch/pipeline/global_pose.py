"""Global pose-graph optimization: rotation + translation averaging (port of
sfm_tpu/pipeline/global_pose.py; the numpy solvers are carried over line for
line, the two device calls, two-view refinement and re-triangulation, run in
torch on the `device` their callers name, on the exact arrays: the JAX
package's bucket padding there only fixed jit shapes).

Reference-class realization: the IIT-Delhi large-scale-SfM lineage registers
partial reconstructions and initializes cameras globally via robust rotation
averaging (Chatterjee/Govindu-style iterative chordal averaging) followed by
translation averaging over pairwise direction constraints (1DSfM-class — the
config ladder's #4 scene family, BASELINE.md, is named after that paper).
The reference mount is empty (SURVEY.md §0), so no file:line citations are
possible; the capability is grounded in SURVEY §0.1/[K] and serves BASELINE
.json:11 (globally consistent 10k+ models).

This is host-side numpy/scipy by design: pose graphs are small (N cameras,
E verified edges — ~10^4/~10^5 at Rome16K scale), irregular, and
latency-bound, which is exactly the work the framework keeps on host
(SURVEY.md §7 "host does bookkeeping, device does math"). The heavy geometry
(triangulation, bundle adjustment) stays on device.

Uses:
- global initialization of camera poses from two-view geometry alone,
- straightening low-frequency drift out of chained incremental/merged models
  (`straighten_reconstruction`): at Rome16K scale the reprojection cost is
  locally FLAT along slow bends of the camera chain, so bundle adjustment
  cannot remove them — but the pose graph's long-range relative-rotation
  constraints are exactly the missing stiffness.

Conventions (match ops/verify.py:35 and scene/state.py): camera poses are
world->camera (x_cam = R x_world + t); edge (i, j) stores the pose of camera
j in camera-i coordinates (x_j = R_ij x_i + t_ij, |t_ij| = 1), so
R_ij = R_j R_i^T and the world-frame unit direction from center i to center
j is d_ij = -R_i^T R_ij^T t_ij.
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Small batched SO(3) helpers (host numpy; torch versions exist in
# geometry/rotations.py but pose-graph iterations are eager host loops where
# per-call dispatch would dominate).
# ---------------------------------------------------------------------------


def _so3_exp_np(rvecs: np.ndarray) -> np.ndarray:
    """Batched angle-axis -> rotation matrices. [E, 3] -> [E, 3, 3]."""
    rvecs = np.asarray(rvecs, np.float64)
    th = np.linalg.norm(rvecs, axis=-1, keepdims=True)
    k = rvecs / np.maximum(th, 1e-12)
    K = np.zeros(rvecs.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    th = th[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def _so3_log_np(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrices -> angle-axis. [E, 3, 3] -> [E, 3].

    Via quaternion extraction with Shepperd branch selection (pick the
    largest of w/x/y/z as pivot) — the antisymmetric-part formula loses the
    axis catastrophically when the angle nears pi (sin(theta) cancellation),
    which real orbit pose sets hit routinely.
    """
    R = np.asarray(R, np.float64)
    batch = R.shape[:-2]
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate pivots: 4w^2-1, 4x^2-1, 4y^2-1, 4z^2-1 (up to +1 shift).
    cand = np.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11],
                    axis=-1)
    pivot = np.argmax(cand, axis=-1)
    q = np.zeros(batch + (4,))
    s = np.sqrt(np.maximum(1.0 + np.take_along_axis(
        cand, pivot[..., None], axis=-1)[..., 0], 1e-300)) * 0.5
    inv4s = 0.25 / s
    qw = [s, (m21 - m12) * inv4s, (m02 - m20) * inv4s, (m10 - m01) * inv4s]
    qx = [(m21 - m12) * inv4s, s, (m01 + m10) * inv4s, (m02 + m20) * inv4s]
    qy = [(m02 - m20) * inv4s, (m01 + m10) * inv4s, s, (m12 + m21) * inv4s]
    qz = [(m10 - m01) * inv4s, (m02 + m20) * inv4s, (m12 + m21) * inv4s, s]
    for k, comps in enumerate((qw, qx, qy, qz)):
        sel = pivot == k
        for c in range(4):
            q[..., c] = np.where(sel, comps[c], q[..., c])
    # Canonical sign (w >= 0) -> angle in [0, pi].
    q = q * np.where(q[..., :1] < 0, -1.0, 1.0)
    vn = np.linalg.norm(q[..., 1:], axis=-1)
    th = 2.0 * np.arctan2(vn, q[..., 0])
    scale = np.where(vn > 1e-12, th / np.maximum(vn, 1e-300), 2.0)
    return q[..., 1:] * scale[..., None]


def _project_so3_np(M: np.ndarray) -> np.ndarray:
    """Batched nearest-rotation projection (polar/SVD). [*, 3, 3]."""
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    det = np.linalg.det(R)
    U = U.copy()
    U[..., :, 2] *= np.sign(det)[..., None]
    return U @ Vt


# ---------------------------------------------------------------------------
# Connectivity
# ---------------------------------------------------------------------------


def _largest_component(pairs: np.ndarray, n: int) -> np.ndarray:
    """Bool mask of the largest connected component (union-find)."""
    parent = np.arange(n)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[rj] = ri
    roots = np.fromiter((find(i) for i in range(n)), dtype=np.int64, count=n)
    touched = np.zeros(n, bool)
    touched[pairs[:, 0]] = True
    touched[pairs[:, 1]] = True
    if not touched.any():
        return touched
    vals, counts = np.unique(roots[touched], return_counts=True)
    return (roots == vals[np.argmax(counts)]) & touched


def _spanning_tree_order(pairs: np.ndarray, weights: np.ndarray, n: int,
                         comp: np.ndarray) -> list[tuple[int, int, int]]:
    """BFS spanning tree over the component, preferring heavy edges.

    Returns [(child, parent, edge_idx)] in visit order, rooted at the
    max-weighted-degree node. Greedy heavy-edge preference keeps the initial
    chain built from the most reliable relative poses.
    """
    adj: dict[int, list[tuple[float, int, int]]] = {}
    for e, (i, j) in enumerate(pairs):
        i, j = int(i), int(j)
        adj.setdefault(i, []).append((float(weights[e]), j, e))
        adj.setdefault(j, []).append((float(weights[e]), i, e))
    deg = np.zeros(n)
    for e, (i, j) in enumerate(pairs):
        deg[int(i)] += weights[e]
        deg[int(j)] += weights[e]
    root = int(np.argmax(np.where(comp, deg, -1.0)))
    visited = np.zeros(n, bool)
    visited[root] = True
    order: list[tuple[int, int, int]] = []
    import heapq

    heap: list[tuple[float, int, int, int]] = []
    for w, nb, e in adj.get(root, []):
        heapq.heappush(heap, (-w, nb, root, e))
    while heap:
        negw, node, par, e = heapq.heappop(heap)
        if visited[node]:
            continue
        visited[node] = True
        order.append((node, par, e))
        for w, nb, e2 in adj.get(node, []):
            if not visited[nb]:
                heapq.heappush(heap, (-w, nb, node, e2))
    return order


# ---------------------------------------------------------------------------
# Rotation averaging
# ---------------------------------------------------------------------------


def rotation_averaging(
    pairs: np.ndarray,
    rel_rvecs: np.ndarray,
    num_images: int,
    weights: np.ndarray | None = None,
    num_iters: int = 50,
    huber_deg: float = 10.0,
    tol_deg: float = 1e-3,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Robust iterative chordal rotation averaging.

    pairs [E, 2] (i, j), rel_rvecs [E, 3] with R_ij = R_j R_i^T (the
    MatchGraph edge convention). Returns (R [N, 3, 3] world->cam, valid [N],
    residual_rad [E]) where valid marks the largest connected component
    (other cameras get identity) and residual_rad is each edge's final
    relative-rotation residual angle — downstream consumers (translation
    averaging) use it to drop edges whose measured pose is gross. The gauge
    is arbitrary (solution defined up to one global rotation).

    Method: spanning-tree initialization, then Lie-algebra Gauss-Newton
    (Govindu-style): each iteration linearizes every edge residual
    r_e = log(R_ij R_i R_j^T) under left-perturbations R_k <- exp(w_k) R_k,
    giving r_e(w) ~ r_e0 + R_ij w_i - w_j (first-order BCH with the adjoint
    Ad(R_ij) = R_ij), and solves the robust-weighted normal equations — one
    sparse 3Nx3N graph-Laplacian solve (scipy splu, same machinery as
    translation_averaging) — then retracts. Unlike local fixed-point
    diffusion sweeps (the previous implementation), one global solve
    propagates long-range constraints across the whole graph, so convergence
    is iteration-count-independent of the graph diameter — on a 10k-camera
    ring with mostly short edges the diffusion version was still 16 degrees
    bent after 300 sweeps while GN lands at fractions of a degree in ~6.
    Huber IRLS weights on the residual angle make it robust; a second pass
    re-solves with gross-residual edges (> max(3x median, huber_deg)) cut
    outright: Huber leaves ~0.1 weight on 90-degree outliers, enough to bias
    the mean by several degrees at 10% contamination.
    """
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    E = len(pairs)
    R = np.tile(np.eye(3), (num_images, 1, 1))
    if E == 0:
        return R, np.zeros(num_images, bool), np.zeros(0)
    w0 = np.ones(E) if weights is None else np.asarray(weights, np.float64)
    w0 = np.maximum(w0, 1e-6)
    w0 = w0 / w0.mean()
    comp = _largest_component(pairs, num_images)
    in_comp = comp[pairs[:, 0]] & comp[pairs[:, 1]]
    Rrel = _so3_exp_np(rel_rvecs)                         # [E, 3, 3]

    # Spanning-tree init: R_child = R_rel R_parent (or transpose for
    # reversed tree edges).
    for child, par, e in _spanning_tree_order(pairs[in_comp], w0[in_comp],
                                              num_images, comp):
        ei = np.where(in_comp)[0][e]
        i, j = pairs[ei]
        if child == j:
            R[child] = Rrel[ei] @ R[par]
        else:
            R[child] = Rrel[ei].T @ R[par]

    huber = np.radians(huber_deg)
    idx_i, idx_j = pairs[:, 0], pairs[:, 1]

    from scipy.sparse import coo_matrix, identity
    from scipy.sparse.linalg import splu

    ids = np.where(comp)[0]
    remap = -np.ones(num_images, np.int64)
    remap[ids] = np.arange(len(ids))
    n = len(ids)
    # Local ids; out-of-component edges (weight forced to 0) park at row 0 —
    # a -1 would wrap np.add.at and break the COO assembly.
    li, lj = np.maximum(remap[idx_i], 0), np.maximum(remap[idx_j], 0)
    kk, ll = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")

    def _sweeps(w_base):
        nonlocal R
        ang = np.zeros(E)
        for it in range(num_iters):
            # Residual per edge in the Lie algebra: r = log(R_ij R_i R_j^T).
            pred_j = Rrel @ R[idx_i]                      # [E, 3, 3]
            res = _so3_log_np(pred_j @ np.swapaxes(R[idx_j], -1, -2))
            ang = np.linalg.norm(res, axis=-1)
            w = w_base * np.where(ang <= huber, 1.0,
                                  huber / np.maximum(ang, 1e-12))
            w = np.where(in_comp, w, 0.0)

            # Normal equations of sum_e w_e ||r_e + Q_e w_i - w_j||^2 with
            # Q_e = Ad(R_ij) = R_ij: 3x3 blocks (i,i)+=wI, (j,j)+=wI,
            # (i,j)-=wQ^T, (j,i)-=wQ. Gauge fixed by a diagonal anchor on
            # the first camera (the global-rotation nullspace).
            wQ = w[:, None, None] * Rrel                  # [E, 3, 3]
            wI = w[:, None, None] * np.broadcast_to(np.eye(3), Rrel.shape)
            bi, bj = 3 * li, 3 * lj
            rows = [(bi[:, None, None] + kk[None]).ravel(),
                    (bj[:, None, None] + kk[None]).ravel(),
                    (bi[:, None, None] + kk[None]).ravel(),
                    (bj[:, None, None] + kk[None]).ravel()]
            cols = [(bi[:, None, None] + ll[None]).ravel(),
                    (bj[:, None, None] + ll[None]).ravel(),
                    (bj[:, None, None] + ll[None]).ravel(),
                    (bi[:, None, None] + ll[None]).ravel()]
            vals = [wI.ravel(), wI.ravel(),
                    (-np.swapaxes(wQ, -1, -2)).ravel(), (-wQ).ravel()]
            H = coo_matrix((np.concatenate(vals),
                            (np.concatenate(rows), np.concatenate(cols))),
                           shape=(3 * n, 3 * n)).tocsc()
            b = np.zeros((n, 3))
            np.add.at(b, li, -np.einsum("ekj,ek->ej", Rrel, w[:, None] * res))
            np.add.at(b, lj, w[:, None] * res)
            anchor = w_base[in_comp].sum() if in_comp.any() else 1.0
            diag = np.zeros(3 * n)
            diag[:3] = anchor                              # gauge anchor
            H = H + coo_matrix((diag, (np.arange(3 * n), np.arange(3 * n))),
                               shape=(3 * n, 3 * n)).tocsc()
            eps = 1e-9 * (H.diagonal().sum() / (3 * n) + 1e-12)
            lu = splu(H + eps * identity(3 * n, format="csc"))
            omega = lu.solve(b.ravel()).reshape(n, 3)
            # Safeguarded retraction: cap the per-camera step at 60 degrees
            # (spanning-tree init can put long-edge residuals near pi, where
            # the first-order BCH model is junk; capping keeps GN monotone).
            nrm = np.linalg.norm(omega, axis=1, keepdims=True)
            cap = np.radians(60.0)
            omega = omega * np.minimum(1.0, cap / np.maximum(nrm, 1e-12))
            R[ids] = _so3_exp_np(omega) @ R[ids]
            if np.degrees(nrm.max() if len(nrm) else 0.0) < tol_deg:
                break
        return ang

    ang = _sweeps(w0)
    # Trim pass: cut gross outlier edges entirely, keeping connectivity —
    # only edges whose removal leaves both endpoints covered are cut.
    live = in_comp & (w0 > 0)
    med = np.median(ang[live]) if live.any() else 0.0
    cut = ang > max(3.0 * med, huber)
    deg_cnt = np.zeros(num_images)
    np.add.at(deg_cnt, idx_i[live & ~cut], 1.0)
    np.add.at(deg_cnt, idx_j[live & ~cut], 1.0)
    safe = cut & (deg_cnt[idx_i] > 0) & (deg_cnt[idx_j] > 0)
    w_cur = np.where(safe, 0.0, w0)
    if safe.any():
        ang = _sweeps(w_cur)
    # Annealing passes: the initial huber scale must be wide (spanning-tree
    # init leaves large residuals everywhere), but real graphs have
    # sub-degree median edge noise with a heavy 1-10 degree tail that a
    # 10-degree Huber leaves at FULL weight — measured on the 512-orbit
    # vocab graph this tail dragged the averaged rotations to 2.9 degrees
    # median vs 0.36 median edge error (benchmarks/pg_diag.py). Re-solve
    # with the scale annealed to the solution's own residual level, cutting
    # newly-gross edges each round (connectivity-guarded as above).
    for _ in range(2):
        live = in_comp & (w_cur > 0)
        if not live.any():
            break
        med = np.median(ang[live])
        huber = max(2.0 * med, np.radians(0.25))
        cut = ang > max(4.0 * med, huber)
        deg_cnt = np.zeros(num_images)
        np.add.at(deg_cnt, idx_i[live & ~cut], 1.0)
        np.add.at(deg_cnt, idx_j[live & ~cut], 1.0)
        drop = cut & (deg_cnt[idx_i] > 0) & (deg_cnt[idx_j] > 0)
        w_cur = np.where(drop, 0.0, w_cur)
        ang = _sweeps(w_cur)
    ang = np.where(w_cur <= 0, np.inf, ang)   # cut edges stay flagged gross
    return R.astype(np.float64), comp, ang


# ---------------------------------------------------------------------------
# Translation averaging
# ---------------------------------------------------------------------------


def translation_averaging(
    pairs: np.ndarray,
    directions: np.ndarray,
    num_images: int,
    valid: np.ndarray,
    weights: np.ndarray | None = None,
    num_rounds: int = 4,
    centers0: np.ndarray | None = None,
    huber: float = 0.1,
) -> tuple[np.ndarray, np.ndarray]:
    """Camera centers from pairwise world-frame direction constraints.

    pairs [E, 2], directions [E, 3] unit vectors d_ij (center i -> center j
    in world frame), valid [N] (cameras to solve; from rotation averaging's
    component mask). Minimizes the scale-free direction objective

        sum_e w_e || P_e (c_j - c_i) ||^2,   P_e = I - d_e d_e^T

    (the component of each baseline PERPENDICULAR to its measured direction
    — the per-edge baseline length is eliminated analytically, which is what
    makes the problem linear; 1DSfM-class objective with Huber IRLS instead
    of L1). The minimizer over unit-norm centered c is the smallest
    eigenvector of the projected graph Laplacian H = sum_e w_e A_e^T P_e A_e:
    for consistent directions the true shape is EXACTLY in its nullspace
    (after deflating the 3 global-translation null vectors), so the solve is
    inverse iteration with translation deflation, seeded from a spanning-tree
    walk (or centers0), with IRLS reweighting rounds around it. [Naive
    alternation on sum ||c_j - c_i - s_e d_e||^2 either collapses (the
    objective is jointly scale-shrinkable) or crawls under an s-floor — the
    eigen formulation has no scale mode to fight.]

    Gauge: output is centered with median projected baseline = 1 and
    majority-positive direction signs; callers align to their frame with a
    sim3 (umeyama_np). Returns (centers [N, 3], solved [N]): `solved` marks
    the largest connected component of the SURVIVING edge graph (weight > 0,
    finite directions, both endpoints `valid`); all other cameras return
    center 0 — dropping gross edges may disconnect cameras that rotation
    averaging could still reach.
    """
    from scipy.sparse import coo_matrix, identity
    from scipy.sparse.linalg import splu

    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    d = np.asarray(directions, np.float64)
    keep = valid[pairs[:, 0]] & valid[pairs[:, 1]]
    keep &= np.isfinite(d).all(axis=1)
    if weights is not None:
        keep &= np.asarray(weights, np.float64) > 0
    pairs, d = pairs[keep], d[keep]
    centers = np.zeros((num_images, 3))
    if len(pairs) == 0:
        return centers, np.zeros(num_images, bool)
    w0 = np.ones(len(pairs)) if weights is None \
        else np.asarray(weights, np.float64)[keep]
    solved = _largest_component(pairs, num_images) & valid
    ecomp = solved[pairs[:, 0]] & solved[pairs[:, 1]]
    pairs, d, w0 = pairs[ecomp], d[ecomp], w0[ecomp]
    E = len(pairs)
    w0 = np.maximum(w0 / max(w0.mean(), 1e-12), 1e-6)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)

    ids = np.where(solved)[0]
    remap = -np.ones(num_images, np.int64)
    remap[ids] = np.arange(len(ids))
    pi, pj = remap[pairs[:, 0]], remap[pairs[:, 1]]
    n = len(ids)

    if centers0 is not None:
        c = np.asarray(centers0, np.float64)[ids].copy()
    else:
        c = np.zeros((n, 3))
        order = _spanning_tree_order(np.stack([pi, pj], 1), w0, n,
                                     np.ones(n, bool))
        dmap = {}
        for e in range(E):
            dmap[(int(pi[e]), int(pj[e]))] = d[e]
        for child, par, e in order:
            i0, j0 = int(pi[e]), int(pj[e])
            step = dmap[(i0, j0)]
            c[child] = c[par] + (step if child == j0 else -step)

    P = np.eye(3)[None] - d[:, :, None] * d[:, None, :]      # [E, 3, 3]
    kk, ll = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")

    def _deflate(x):
        x = x - x.mean(axis=0)                               # kill translations
        return x / max(np.linalg.norm(x), 1e-12)

    for _ in range(num_rounds):
        delta = c[pj] - c[pi]
        base = np.linalg.norm(delta, axis=1)
        res = np.linalg.norm(np.einsum("eij,ej->ei", P, delta), axis=1)
        scale = huber * max(np.median(base), 1e-9)
        w = w0 * np.where(res <= scale, 1.0, scale / np.maximum(res, 1e-12))

        # H = sum_e w_e A_e^T P_e A_e as 3x3 blocks: +wP at (i,i), (j,j);
        # -wP at (i,j), (j,i). Flat index 3*cam + coord.
        wP = w[:, None, None] * P                            # [E, 3, 3]
        bi, bj = 3 * pi, 3 * pj
        rows, cols, vals = [], [], []
        for br, bc, sgn in ((bi, bi, 1.0), (bj, bj, 1.0),
                            (bi, bj, -1.0), (bj, bi, -1.0)):
            rows.append((br[:, None, None] + kk[None]).ravel())
            cols.append((bc[:, None, None] + ll[None]).ravel())
            vals.append((sgn * wP).ravel())
        H = coo_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(3 * n, 3 * n)).tocsc()
        eps = 1e-10 * (H.diagonal().sum() / (3 * n) + 1e-12)
        lu = splu(H + eps * identity(3 * n, format="csc"))
        x = _deflate(c)
        for _ in range(3):                                   # inverse iteration
            x = _deflate(lu.solve(x.ravel()).reshape(n, 3))
        c = x

        # Fix sign + scale gauge: majority of projected baselines positive,
        # median projected baseline = 1.
        s = np.einsum("ei,ei->e", c[pj] - c[pi], d)
        med = np.median(s)
        if med < 0:
            c, med = -c, -med
        c = c / max(abs(med), 1e-12)

    centers[ids] = c
    return centers, solved


def _two_view_depths(rel_r: np.ndarray, rel_t: np.ndarray,
                     xn_i: np.ndarray, xn_j: np.ndarray,
                     mask: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Batched two-view depths at unit baseline.

    rel_r/rel_t [E, 3] (cam_i -> cam_j, |t| = 1 from essential decomposition),
    xn_* [E, M, 2] normalized camera coords of the edge's correspondences,
    mask [E, M]. For each correspondence solve the 2x2 least squares
    min || d_i (R x_i) - d_j x_j + t ||^2 over ray depths (d_i, d_j).
    Returns (d_i, d_j, ok [E, M]); ok requires cheirality (both depths
    positive) and non-degenerate parallax (the 2x2 determinant, which IS
    sin^2 of the ray angle for unit rays).
    """
    Rr = _so3_exp_np(rel_r.astype(np.float64))
    xi = np.concatenate([xn_i, np.ones_like(xn_i[..., :1])], -1)
    xi = xi / np.maximum(np.linalg.norm(xi, axis=-1, keepdims=True), 1e-12)
    xj = np.concatenate([xn_j, np.ones_like(xn_j[..., :1])], -1)
    xj = xj / np.maximum(np.linalg.norm(xj, axis=-1, keepdims=True), 1e-12)
    a = np.einsum("eij,emj->emi", Rr, xi)               # rays of i in j's frame
    t = rel_t[:, None, :].astype(np.float64)
    ab = np.einsum("emi,emi->em", a, xj)
    at = np.einsum("emi,ei->em", a, rel_t.astype(np.float64))
    bt = np.einsum("emi,ei->em", xj, rel_t.astype(np.float64))
    det = 1.0 - ab * ab                                 # = sin^2(ray angle)
    safe = np.maximum(det, 1e-12)
    d_i = (ab * bt - at) / safe
    d_j = (bt - ab * at) / safe
    ok = mask & (det > 3e-6) & (d_i > 1e-6) & (d_j > 1e-6)
    return d_i, d_j, ok


def edge_scale_centers(
    pairs: np.ndarray,
    directions: np.ndarray,
    rel_r: np.ndarray,
    rel_t: np.ndarray,
    idx_i: np.ndarray,
    idx_j: np.ndarray,
    inlier: np.ndarray,
    xn: np.ndarray,
    num_images: int,
    valid: np.ndarray,
    weights: np.ndarray | None = None,
    sync_iters: int = 200,
    irls_rounds: int = 3,
    cg_iters: int = 200,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Camera centers from SCALED pairwise displacements.

    The direction-only objective (translation_averaging) is degenerate for
    collinear camera motion — all pairwise directions coincide, so spacing
    along the line is free. That is exactly the per-cluster regime of the
    divide-and-conquer pipeline (a 48-image ladder arc measured 21% center
    RMSE from the direction solve alone, benchmarks/cluster diag). The
    missing constraint is per-edge BASELINE SCALE, and the data for it is
    already in the match graph: each edge's two-view depths are expressed
    at unit baseline, so two edges observing the same (image, keypoint)
    satisfy  s_e1 * d_e1 = s_e2 * d_e2  — a linear system in log-scale.

    Three stages, all host numpy (SURVEY.md §7: pose-graph solves are host
    bookkeeping):
      1. batched two-view depths per edge inlier (_two_view_depths);
      2. log-scale sync: minimize sum over (image, kp) groups of
         (ls_e + log d - mu_g)^2 by exact alternation (block coordinate
         descent between edge scales ls and group log-depths mu), Huber
         IRLS on the record residuals;
      3. center solve: min sum_e w_e || (c_j - c_i) - s_e d_e ||^2 — an
         ordinary (scalar-weighted) graph Laplacian with a well-defined
         right-hand side; Jacobi-PCG + Huber IRLS on residual norms.

    xn [N, K, 2]: normalized camera coords per image keypoint. Returns
    (centers [N, 3], solved [N]) in the same contract as
    translation_averaging (gauge: centered, median baseline ~ median s).
    """
    pairs = np.asarray(pairs, np.int64).reshape(-1, 2)
    d_world = np.asarray(directions, np.float64)
    keep = valid[pairs[:, 0]] & valid[pairs[:, 1]]
    keep &= np.isfinite(d_world).all(axis=1)
    if weights is not None:
        keep &= np.asarray(weights, np.float64) > 0
    eids = np.where(keep)[0]
    centers = np.zeros((num_images, 3))
    if len(eids) == 0:
        return centers, np.zeros(num_images, bool)

    E = len(eids)
    pe = pairs[eids]
    de = d_world[eids]
    de = de / np.maximum(np.linalg.norm(de, axis=1, keepdims=True), 1e-12)

    # --- stage 1: unit-baseline depths for every edge correspondence -----
    ii = np.asarray(idx_i)[eids]
    jj = np.asarray(idx_j)[eids]
    ml = np.asarray(inlier)[eids]
    xn_i = xn[pe[:, 0][:, None], ii]
    xn_j = xn[pe[:, 1][:, None], jj]
    d_i, d_j, ok = _two_view_depths(np.asarray(rel_r)[eids],
                                    np.asarray(rel_t)[eids], xn_i, xn_j, ml)

    # --- stage 2: log-scale sync over shared (image, keypoint) tracks ----
    K = xn.shape[1]
    e_rec, img_rec, kp_rec, logd = [], [], [], []
    for side, (img_col, kp_arr, dd) in enumerate(
            ((pe[:, 0], ii, d_i), (pe[:, 1], jj, d_j))):
        em, mm = np.nonzero(ok)
        e_rec.append(em)
        img_rec.append(img_col[em])
        kp_rec.append(kp_arr[em, mm])
        logd.append(np.log(dd[em, mm]))
    e_rec = np.concatenate(e_rec)
    gkey = np.concatenate(img_rec).astype(np.int64) * K + np.concatenate(kp_rec)
    logd = np.concatenate(logd)
    fin = np.isfinite(logd)
    e_rec, gkey, logd = e_rec[fin], gkey[fin], logd[fin]
    # Keep only groups covering >= 2 DISTINCT edges (they carry constraints).
    pairkey = gkey * np.int64(E + 1) + e_rec  # dedup same-(group, edge) repeats
    order = np.argsort(pairkey, kind="stable")
    e_rec, gkey, logd = e_rec[order], gkey[order], logd[order]
    ug, gid = np.unique(gkey, return_inverse=True)
    G = len(ug)
    # distinct edges per group
    first_of_pair = np.ones(len(e_rec), bool)
    first_of_pair[1:] = pairkey[order][1:] != pairkey[order][:-1]
    edges_per_group = np.bincount(gid[first_of_pair], minlength=G)
    userec = edges_per_group[gid] >= 2
    e_rec, gid_raw, logd = e_rec[userec], gkey[userec], logd[userec]
    solved = _largest_component(pe, num_images) & valid
    if len(e_rec) == 0:
        if verbose:
            print("[sfm_tpu_torch]   edge-scale sync: no shared-track records, "
                  "falling back to direction-only centers")
        return translation_averaging(pe, de, num_images, valid,
                                     weights=None if weights is None
                                     else np.asarray(weights)[eids])
    _, gid = np.unique(gid_raw, return_inverse=True)
    G = int(gid.max()) + 1

    ls = np.zeros(E)
    w_rec = np.ones(len(e_rec))
    nrec_g = np.bincount(gid, weights=None, minlength=G).astype(np.float64)
    for it in range(sync_iters):
        wg = np.bincount(gid, weights=w_rec, minlength=G)
        mu = np.bincount(gid, weights=w_rec * (ls[e_rec] + logd),
                         minlength=G) / np.maximum(wg, 1e-12)
        target = mu[gid] - logd
        we = np.bincount(e_rec, weights=w_rec, minlength=E)
        ls_new = np.bincount(e_rec, weights=w_rec * target,
                             minlength=E) / np.maximum(we, 1e-12)
        moved = np.abs(ls_new - ls).max() if len(ls) else 0.0
        ls = ls_new - np.median(ls_new[np.isfinite(ls_new)])  # gauge
        if it % 10 == 9:
            r = np.abs(ls[e_rec] + logd - mu[gid])
            sc = max(1.4826 * np.median(r), 1e-3)
            w_rec = np.where(r <= sc, 1.0, sc / np.maximum(r, 1e-12))
        if moved < 1e-6 and it > 20:
            break
    s_e = np.exp(np.clip(ls, -20.0, 20.0))
    # Edge confidence for the center solve: total record weight (edges with
    # no shared-track coverage get a floor weight — their scale is the
    # median guess and the IRLS below will trim them if inconsistent).
    w_edge = np.bincount(e_rec, weights=w_rec, minlength=E)
    w_edge = np.sqrt(w_edge) + 1e-2
    if verbose:
        cov = float((np.bincount(e_rec, minlength=E) > 0).mean())
        print(f"[sfm_tpu_torch]   edge-scale sync: {len(e_rec)} records, "
              f"{G} shared tracks, edge coverage {cov:.2f}, "
              f"scale spread {np.exp(np.percentile(ls, [5, 95]))}")

    # --- stage 3: centers from scaled displacements -----------------------
    ecomp = solved[pe[:, 0]] & solved[pe[:, 1]]
    pe_c, de_c, s_c, w_c = pe[ecomp], de[ecomp], s_e[ecomp], w_edge[ecomp]
    ids = np.where(solved)[0]
    remap = -np.ones(num_images, np.int64)
    remap[ids] = np.arange(len(ids))
    pi, pj = remap[pe_c[:, 0]], remap[pe_c[:, 1]]
    n = len(ids)
    disp = s_c[:, None] * de_c                          # target c_j - c_i
    c = np.zeros((n, 3))
    w = w_c.copy()
    for rnd in range(irls_rounds):
        deg = np.bincount(pi, weights=w, minlength=n) \
            + np.bincount(pj, weights=w, minlength=n)
        shift = 1e-9 * max(w.sum() / max(n, 1), 1e-300)
        inv_d = 1.0 / np.maximum(deg + shift, 1e-300)
        b = np.zeros((n, 3))
        wd = w[:, None] * disp
        np.subtract.at(b, pi, wd)
        np.add.at(b, pj, wd)

        def Hx(x):
            out = (deg + shift)[:, None] * x
            xw_i = w[:, None] * x[pj]
            xw_j = w[:, None] * x[pi]
            np.subtract.at(out, pi, xw_i)
            np.subtract.at(out, pj, xw_j)
            return out

        r = b - Hx(c)
        z = inv_d[:, None] * r
        p = z.copy()
        rz = (r * z).sum()
        b2 = (b * b).sum()
        for _ in range(cg_iters):
            q = Hx(p)
            den = (p * q).sum()
            if den <= 0:
                break
            a_ = rz / den
            c += a_ * p
            r -= a_ * q
            if (r * r).sum() <= 1e-14 * max(b2, 1e-300):
                break
            z = inv_d[:, None] * r
            rz_new = (r * z).sum()
            p = z + (rz_new / max(rz, 1e-300)) * p
            rz = rz_new
        resid = np.linalg.norm((c[pj] - c[pi]) - disp, axis=1)
        sc = max(1.4826 * np.median(resid), 1e-6)
        w = w_c * np.where(resid <= sc, 1.0, sc / np.maximum(resid, 1e-12))
        if verbose:
            print(f"[sfm_tpu_torch]   edge-scale centers round {rnd}: "
                  f"median |resid| {np.median(resid):.4f} "
                  f"(median baseline {np.median(s_c):.4f})")
    c -= c.mean(axis=0)
    centers[ids] = c
    return centers, solved


def global_positioning(
    obs_cam: np.ndarray,
    obs_point: np.ndarray,
    rays: np.ndarray,
    num_images: int,
    num_points: int,
    valid_cam: np.ndarray,
    centers0: np.ndarray | None = None,
    points0: np.ndarray | None = None,
    rounds: int = 4,
    inv_iters: int = 3,
    cg_iters: int = 120,
    theta_huber_start_deg: float = 8.0,
    theta_huber_floor_deg: float = 1.5,
    verbose: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Joint camera-center + point positioning from observation rays.

    The GLOMAP-class replacement for PAIRWISE translation averaging: with
    camera rotations fixed (rotation averaging), solve every camera center
    c_i AND every track point X_p at once from the world-frame observation
    rays v_ip = R_i^T K^{-1} u_ip, minimizing the robustly-weighted
    perpendicular deviation

        sum_obs  w_ip || [v_ip]_x (X_p - c_i) ||^2 / depth_ip^2

    (the cross product kills the component ALONG the ray — per-observation
    depth is eliminated analytically, keeping the problem linear; the
    1/depth^2 IRLS normalization converts the raw perpendicular distance to
    an ANGULAR residual so far structure doesn't dominate, and a Huber
    weight on that angle plus a cheirality gate handles gross matches).

    Why this replaces translation_averaging as the production path: pairwise
    direction averaging uses E edge directions (~5 per camera on band
    graphs) and measured a 42% center RMSE on the 512-orbit vocab graph,
    while the observation-ray objective uses every track observation (~365x
    more constraints there) and couples all cameras seeing a track through
    one shared 3D point — benchmarks/global_diag.py measures the delta.
    Pairwise averaging remains as the SEED for this solve.

    Solver: seed-anchored alternating least squares (the BATA/LUD family,
    GLOMAP's global-positioning shape) rather than a deflated eigen-solve.
    Each IRLS round freezes per-observation depth targets
    d_ip = max(v_ip . (X_p - c_i), floor) and solves the LINEAR problem

        min_{c, X}  sum_obs  alpha_ip || (X_p - c_i) - d_ip v_ip ||^2

    (alpha = w / d^2) — a scalar-weighted bipartite graph Laplacian, three
    independent coordinates, Jacobi-preconditioned CG whose RHS is exactly
    orthogonal to the translation nullspace. An earlier inverse-iteration
    eigen formulation found the smallest eigenvector REGARDLESS of the
    seed; with contaminated tracks (a few percent of glued fragments) that
    vector is a collapse mode, measured at full-radius RMSE on the match-densified
    512-orbit graph, while the anchored solve stays on the seed's branch
    and the annealed Huber-on-angle IRLS strips the glue.

    Host numpy by design (SURVEY.md §7: pose-graph solves are host
    bookkeeping); ~200k observations solve in seconds, and the matvec is
    O(obs) so Rome16K-scale (~5M obs) stays in minutes.

    Returns (centers [N, 3], points [P, 3], solved_cam [N], solved_pt [P]).
    Gauge: majority-positive depth sign, median depth = 1, centers+points
    centered at 0 — arbitrary, callers sim3-align downstream.
    """
    oc = np.asarray(obs_cam, np.int64)
    op = np.asarray(obs_point, np.int64)
    v = np.asarray(rays, np.float64)
    v = v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)

    keep = np.asarray(valid_cam, bool)[oc] & np.isfinite(v).all(axis=1)
    # A point needs >= 2 observations to be positioned (1 ray constrains
    # only its perpendicular plane); drop rather than damp.
    cnt = np.bincount(op[keep], minlength=num_points)
    keep &= cnt[op] >= 2
    oc, op, v = oc[keep], op[keep], v[keep]
    if len(oc) == 0:
        return (np.zeros((num_images, 3)), np.zeros((num_points, 3)),
                np.zeros(num_images, bool), np.zeros(num_points, bool))

    cams = np.unique(oc)
    pts = np.unique(op)
    cmap = -np.ones(num_images, np.int64)
    cmap[cams] = np.arange(len(cams))
    pmap = -np.ones(num_points, np.int64)
    pmap[pts] = np.arange(len(pts))
    oc_l, op_l = cmap[oc], pmap[op]
    nc, npt = len(cams), len(pts)

    # Init: seed centers (translation averaging / spanning tree) + points
    # (DLT triangulation when available; unit-depth along the first ray
    # otherwise).
    c = (np.asarray(centers0, np.float64)[cams].copy()
         if centers0 is not None else np.zeros((nc, 3)))
    if points0 is not None:
        X = np.asarray(points0, np.float64)[pts].copy()
        bad = ~np.isfinite(X).all(axis=1)
    else:
        X = np.zeros((npt, 3))
        bad = np.ones(npt, bool)
    if bad.any():
        # Midpoint triangulation from the seed centers: per point solve
        # (sum_e I - v v^T) X = sum_e (I - v v^T) c_e — batched 3x3,
        # damped for near-parallel ray bundles. Keeps the round-0 seed
        # gate meaningful (a unit-depth init would grade every true ray
        # of a far point as gross).
        Mo = np.eye(3)[None] - v[:, :, None] * v[:, None, :]
        A = np.zeros((npt, 3, 3))
        b = np.zeros((npt, 3))
        np.add.at(A, op_l, Mo)
        np.add.at(b, op_l, np.einsum("eij,ej->ei", Mo, c[oc_l]))
        tr = np.trace(A, axis1=1, axis2=2)[:, None, None] / 3.0
        Xmid = np.linalg.solve(
            A + 1e-4 * np.maximum(tr, 1e-12) * np.eye(3)[None],
            b[:, :, None])[:, :, 0]
        X[bad] = Xmid[bad]

    def _bincount3(idx, vals, n):
        return np.stack([np.bincount(idx, weights=vals[:, k], minlength=n)
                         for k in range(3)], axis=1)

    def _theta_depth(cc, xx):
        u = xx[op_l] - cc[oc_l]
        dist = np.maximum(np.linalg.norm(u, axis=1), 1e-12)
        depth = np.einsum("ei,ei->e", u, v)
        theta = np.arccos(np.clip(depth / dist, -1.0, 1.0))
        return theta, depth

    def _anchored_solve(w_r, depth, med_d):
        """Seed-anchored linear solve: freeze per-observation depth targets
        d = max(depth, floor) and solve min sum alpha ||(X-c) - d v||^2
        (alpha = w/d^2) — a scalar-weighted bipartite Laplacian, Jacobi-PCG,
        warm-started from the current iterate so the solution stays on the
        seed's branch."""
        d_t = np.maximum(depth, 0.05 * max(med_d, 1e-12))
        alpha = w_r / (d_t * d_t)
        deg_c = np.bincount(oc_l, weights=alpha, minlength=nc)
        deg_p = np.bincount(op_l, weights=alpha, minlength=npt)
        shift = 1e-9 * max(float(alpha.sum()) / (nc + npt), 1e-300)
        inv_dc = 1.0 / np.maximum(deg_c + shift, 1e-300)
        inv_dp = 1.0 / np.maximum(deg_p + shift, 1e-300)

        target = alpha[:, None] * d_t[:, None] * v      # [O, 3]
        b_c = -_bincount3(oc_l, target, nc)
        b_x = _bincount3(op_l, target, npt)

        def Hx(cc, xx):
            out_c = (deg_c[:, None] * cc
                     - _bincount3(oc_l, xx[op_l] * alpha[:, None], nc)
                     + shift * cc)
            out_x = (deg_p[:, None] * xx
                     - _bincount3(op_l, cc[oc_l] * alpha[:, None], npt)
                     + shift * xx)
            return out_c, out_x

        yc, yx = c.copy(), X.copy()
        rc_, rx_ = Hx(yc, yx)
        rc_, rx_ = b_c - rc_, b_x - rx_
        zc, zx = inv_dc[:, None] * rc_, inv_dp[:, None] * rx_
        pc_, px_ = zc.copy(), zx.copy()
        rz = (rc_ * zc).sum() + (rx_ * zx).sum()
        b2 = (b_c * b_c).sum() + (b_x * b_x).sum()
        for _ in range(cg_iters):
            qc, qx = Hx(pc_, px_)
            denom = (pc_ * qc).sum() + (px_ * qx).sum()
            if denom <= 0:
                break
            a_ = rz / denom
            yc += a_ * pc_
            yx += a_ * px_
            rc_ -= a_ * qc
            rx_ -= a_ * qx
            r2 = (rc_ * rc_).sum() + (rx_ * rx_).sum()
            if r2 <= 1e-14 * max(b2, 1e-300):
                break
            zc = inv_dc[:, None] * rc_
            zx = inv_dp[:, None] * rx_
            rz_new = (rc_ * zc).sum() + (rx_ * zx).sum()
            beta = rz_new / max(rz, 1e-300)
            pc_ = zc + beta * pc_
            px_ = zx + beta * px_
            rz = rz_new
        return yc, yx

    def _eigen_solve(w, med_d):
        """Deflated inverse iteration on the projector quadratic form
        sum w ||(I - vv^T)(X - c)||^2: the near-null mode IS the global
        shape when the tracks are clean — it can unbend an arbitrarily bad
        seed, which the anchored solve cannot. Gauge-fixed to majority-
        positive depth at the current iterate's depth scale."""
        Mdiag_c = np.zeros((nc, 3, 3))
        Mdiag_p = np.zeros((npt, 3, 3))
        Mfull = w[:, None, None] * (np.eye(3)[None]
                                    - v[:, :, None] * v[:, None, :])
        np.add.at(Mdiag_c, oc_l, Mfull)
        np.add.at(Mdiag_p, op_l, Mfull)
        tr = (np.trace(Mdiag_c, axis1=1, axis2=2).sum()
              + np.trace(Mdiag_p, axis1=1, axis2=2).sum()) / (3 * (nc + npt))
        sigma = 1e-6 * max(tr, 1e-300)
        eye = sigma * np.eye(3)
        Pc = np.linalg.inv(Mdiag_c + eye[None])
        Pp = np.linalg.inv(Mdiag_p + eye[None])

        def _deflate(cc, xx):
            m = (cc.sum(0) + xx.sum(0)) / (nc + npt)
            cc, xx = cc - m, xx - m
            nrm = np.sqrt((cc * cc).sum() + (xx * xx).sum())
            return cc / max(nrm, 1e-300), xx / max(nrm, 1e-300)

        def Hx(cc, xx):
            uu = cc[oc_l] - xx[op_l]
            t = w[:, None] * (uu - v * np.einsum("ei,ei->e", v, uu)[:, None])
            out_c = sigma * cc
            out_x = sigma * xx
            np.add.at(out_c, oc_l, t)
            np.subtract.at(out_x, op_l, t)
            return out_c, out_x

        def pcg(bc, bx):
            yc = np.zeros_like(bc)
            yx = np.zeros_like(bx)
            rc, rx = bc.copy(), bx.copy()
            zc = np.einsum("nij,nj->ni", Pc, rc)
            zx = np.einsum("nij,nj->ni", Pp, rx)
            pc_, px_ = zc.copy(), zx.copy()
            rz = (rc * zc).sum() + (rx * zx).sum()
            b2 = (bc * bc).sum() + (bx * bx).sum()
            for _ in range(cg_iters):
                qc, qx = Hx(pc_, px_)
                a_ = rz / max((pc_ * qc).sum() + (px_ * qx).sum(), 1e-300)
                yc += a_ * pc_
                yx += a_ * px_
                rc -= a_ * qc
                rx -= a_ * qx
                r2 = (rc * rc).sum() + (rx * rx).sum()
                if r2 <= 1e-10 * b2:
                    break
                zc = np.einsum("nij,nj->ni", Pc, rc)
                zx = np.einsum("nij,nj->ni", Pp, rx)
                rz_new = (rc * zc).sum() + (rx * zx).sum()
                pc_ = zc + (rz_new / max(rz, 1e-300)) * pc_
                px_ = zx + (rz_new / max(rz, 1e-300)) * px_
                rz = rz_new
            return yc, yx

        cc, xx = _deflate(c, X)
        for _ in range(inv_iters):
            cc, xx = _deflate(*pcg(cc, xx))
        depth = np.einsum("ei,ei->e", xx[op_l] - cc[oc_l], v)
        if np.median(depth) < 0:
            cc, xx, depth = -cc, -xx, -depth
        s = np.median(depth[depth > 0]) if (depth > 0).any() else 1.0
        s = max(med_d, 1e-12) / max(s, 1e-300)
        return cc * s, xx * s

    # Hybrid IRLS: each round solves BOTH candidates and keeps whichever
    # has the lower median angular residual. The eigen mode wins on clean
    # graphs with a bent seed (it finds the shape regardless of the seed);
    # the anchored mode wins under track contamination, where the eigen
    # near-null vector is a collapse mode (measured at full-radius RMSE on
    # the match-densified 512-orbit graph). Median theta separates the two cleanly:
    # a collapse cannot explain the clean majority of rays.
    th_scale = np.radians(theta_huber_start_deg)
    th_floor = np.radians(theta_huber_floor_deg)
    best = None
    best_med = np.inf
    for rnd in range(rounds):
        theta, depth = _theta_depth(c, X)
        med_all = float(np.median(theta))
        if med_all < best_med:
            best_med = med_all
            best = (c.copy(), X.copy())
        if rnd == 0:
            # Round 0: wide gate only. Even a badly bent seed puts true
            # rays within a few tens of degrees, while gross rays (wrong
            # matches / glued fragments) are near-uniform — the 60-degree
            # gate halves contamination without touching inliers. Fine
            # IRLS weights from seed geometry would grade TRUE constraints
            # as outliers at a 40%-bent seed.
            w_r = (theta <= np.radians(60.0)).astype(np.float64)
        else:
            med_th = np.median(theta[theta < np.radians(60.0)]) if (
                theta < np.radians(60.0)).any() else th_scale
            scale = max(th_scale, 1.2 * med_th)
            w_r = np.where(theta <= scale, 1.0,
                           scale / np.maximum(theta, 1e-12))
            # Trim threshold tracks the solution's own residual level so
            # each round kills the tail the previous round could still
            # explain away; behind-camera rays are gross, not noise.
            w_r = np.where(theta > max(4.0 * med_th, scale), 0.0, w_r)
            w_r = np.where(depth <= 0, 0.0, w_r)
        pos = depth > 0
        med_d = np.median(depth[pos]) if pos.any() else 1.0

        cA, XA = _anchored_solve(w_r, depth, med_d)
        # Angular normalization for the projector form, clamped so
        # near-camera observations don't dominate the quadratic.
        dn = np.maximum(np.abs(depth), 0.3 * max(med_d, 1e-12))
        cB, XB = _eigen_solve(w_r / (dn * dn), med_d)
        thA, _ = _theta_depth(cA, XA)
        thB, _ = _theta_depth(cB, XB)
        mA, mB = float(np.median(thA)), float(np.median(thB))
        if mB < mA:
            c, X = cB, XB
        else:
            c, X = cA, XA
        if verbose:
            print(f"[sfm_tpu_torch]   positioning round {rnd}: "
                  f"theta med={np.degrees(med_all):.2f}deg "
                  f"anchored={np.degrees(mA):.2f}deg "
                  f"eigen={np.degrees(mB):.2f}deg "
                  f"-> {'eigen' if mB < mA else 'anchored'} "
                  f"cut={int((w_r == 0).sum())} behind={int((depth <= 0).sum())}")
        th_scale = max(th_scale * 0.5, th_floor)

    # Keep the best iterate by median angular residual (the final round
    # has no post-check inside the loop).
    u = X[op_l] - c[oc_l]
    dist = np.maximum(np.linalg.norm(u, axis=1), 1e-12)
    theta = np.arccos(np.clip(np.einsum("ei,ei->e", u, v) / dist, -1.0, 1.0))
    if best is not None and float(np.median(theta)) > best_med:
        c, X = best

    centers = np.zeros((num_images, 3))
    points = np.zeros((num_points, 3))
    centers[cams] = c
    points[pts] = X
    solved_cam = np.zeros(num_images, bool)
    solved_cam[cams] = True
    solved_pt = np.zeros(num_points, bool)
    solved_pt[pts] = True
    return centers, points, solved_cam, solved_pt


def observation_rays(rec) -> np.ndarray:
    """World-frame unit rays for every observation of `rec` at its CURRENT
    rotations: v = R_i^T undistort(K^{-1} u). [O, 3] float64."""
    intr = rec.intrinsics[rec.obs_image]
    xy = (rec.obs_uv - intr[:, 2:4]) / intr[:, 0:2]
    k1, k2 = intr[:, 4], intr[:, 5]
    if np.any(k1) or np.any(k2):
        x = xy.copy()
        for _ in range(4):
            r2 = np.sum(x * x, axis=-1)
            x = xy / (1.0 + k1 * r2 + k2 * r2 * r2)[..., None]
        xy = x
    rays_cam = np.concatenate(
        [xy.astype(np.float64), np.ones((len(xy), 1))], axis=1)
    R = _so3_exp_np(rec.rvecs[rec.obs_image].astype(np.float64))
    v = np.einsum("eji,ej->ei", R, rays_cam)
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)


def reposition_reconstruction(rec, rounds: int = 4,
                              verbose: bool = False) -> bool:
    """Re-solve all camera centers + points of `rec` in place by global
    positioning (rotations kept), seeded from the current centers. The
    gauge is re-anchored to the current model with a sim3 so downstream
    consumers (filters with absolute thresholds, checkpoints) see the same
    scale. Returns False (untouched) if too few cameras were solvable."""
    from sfm_tpu_torch.geometry.similarity import umeyama_np

    if rec.obs_point is None or not len(rec.obs_point):
        return False
    rays = observation_rays(rec)
    R_all = _so3_exp_np(rec.rvecs.astype(np.float64))
    cen0 = -np.einsum("nji,nj->ni", R_all, rec.tvecs.astype(np.float64))
    live = rec.point_valid[rec.obs_point]
    oc, op, rays = rec.obs_image[live], rec.obs_point[live], rays[live]
    med_before = float(np.median(rec.reprojection_errors()))
    tvecs0, points0 = rec.tvecs.copy(), rec.points.copy()
    c, X, sc, sp = global_positioning(
        oc, op, rays, len(rec.registered), len(rec.points),
        rec.registered, centers0=cen0, rounds=rounds, verbose=verbose)
    both = sc & rec.registered
    if both.sum() < max(3, 0.5 * rec.registered.sum()):
        return False
    s, Rw, t = umeyama_np(c[both], cen0[both])
    Rw = np.asarray(Rw)
    c_new = s * c[both] @ Rw.T + np.asarray(t)
    ids = np.where(both)[0]
    rec.tvecs[ids] = (-np.einsum("nij,nj->ni", R_all[ids],
                                 c_new)).astype(np.float32)
    fuse_pt = sp & rec.point_valid
    rec.points[fuse_pt] = (s * X[fuse_pt] @ Rw.T
                           + np.asarray(t)).astype(np.float32)
    # Revert-on-worse: on fragmented track graphs the ray objective is
    # nearly flat along low-frequency bends, so the solve can "improve"
    # median ray angle while moving the model AWAY from the data in pixel
    # terms (measured on the 512-orbit v1-track graph: median reproj 2.1 ->
    # 9.8 px while theta improved). Pixel reprojection against the actual
    # observations is the honest acceptance test.
    med_after = float(np.median(rec.reprojection_errors()))
    if not np.isfinite(med_after) or med_after > max(1.25 * med_before, 0.5):
        rec.tvecs[:], rec.points[:] = tvecs0, points0
        if verbose:
            print(f"[sfm_tpu_torch]   repositioning REVERTED: median reproj "
                  f"{med_before:.2f} -> {med_after:.2f} px")
        return False
    if verbose:
        moved = float(np.mean(np.linalg.norm(c_new - cen0[both], axis=1)))
        print(f"[sfm_tpu_torch]   repositioning: {int(both.sum())} cameras, "
              f"{int(fuse_pt.sum())} points, mean center move {moved:.3f} "
              f"(median reproj {med_before:.2f} -> {med_after:.2f} px)")
    return True


# ---------------------------------------------------------------------------
# MatchGraph front end + reconstruction straightening
# ---------------------------------------------------------------------------


def refine_graph_poses(graph, feats_xy: np.ndarray, intrinsics: np.ndarray,
                       edge_mask: np.ndarray, chunk: int = 4096,
                       iters: int = 10, *, device) -> tuple[np.ndarray, np.ndarray]:
    """Re-estimate the masked edges' relative poses by batched two-view
    reprojection refinement (ops.relpose) on `device`. Returns refined
    (rel_rvecs [E, 3], rel_tvecs [E, 3]) for the FULL edge array with
    unmasked rows passed through unchanged.

    Edges are dispatched in chunks of at most `chunk`: at Rome16K-scale
    graphs (~50k pose edges) the [chunk, K] correspondence batches stay
    ~16 MB.
    """
    from sfm_tpu_torch.ops.relpose import (gather_edge_correspondences,
                                           refine_relative_poses)

    rel_r = np.asarray(graph.rvec, np.float32).copy()
    rel_t = np.asarray(graph.tvec, np.float32).copy()
    ids = np.where(edge_mask)[0]
    if len(ids) == 0:
        return rel_r, rel_t
    # Huber in normalized units: ~2 px at the median focal.
    med_f = float(np.median(intrinsics[:, 0])) or 1.0
    for s in range(0, len(ids), chunk):
        sub = ids[s:s + chunk]
        x1, x2, mask = gather_edge_correspondences(
            graph, feats_xy, intrinsics, sub)
        rv, tv, _ = refine_relative_poses(
            *(torch.from_numpy(a).to(device) for a in (x1, x2, mask, rel_r[sub], rel_t[sub])),
            huber=2.0 / med_f, iters=iters)
        rel_r[sub] = rv.cpu().numpy()
        rel_t[sub] = tv.cpu().numpy()
    return rel_r, rel_t


def pose_graph_poses(graph, num_images: int, min_inliers: int = 0,
                     feats=None, intrinsics=None, *, device,
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global world->camera poses from a verified MatchGraph alone.

    Uses edges with ok & pose_ok (correspondence-only edges carry no usable
    relative pose — stages.MatchGraph.pose_ok). Returns (rvecs [N, 3],
    tvecs [N, 3], valid [N]); the gauge (global rotation, translation,
    scale) is arbitrary.

    When `feats` (FeatureSet or raw xy array) and `intrinsics` are given,
    every pose edge is first re-refined by two-view reprojection GN
    (ops.relpose): the RANSAC poses minimize epipolar error, whose optimum
    is measurably offset from the reprojection optimum on short-baseline
    edges (0.33 -> 0.18 deg median edge rotation error on the 512-orbit
    ladder graph) — averaging integrates that noise around the graph.
    """
    use = np.asarray(graph.ok).copy()
    if graph.pose_ok is not None:
        use &= np.asarray(graph.pose_ok)
    if min_inliers:
        use &= np.asarray(graph.num_inliers) >= min_inliers
    if feats is not None and intrinsics is not None:
        feats_xy = feats if isinstance(feats, np.ndarray) else feats.xy
        all_r, all_t = refine_graph_poses(
            graph, feats_xy, np.asarray(intrinsics, np.float32), use, device=device)
        rel_r = all_r[use]
        rel_t = all_t[use]
    else:
        rel_r = np.asarray(graph.rvec)[use]
        rel_t = np.asarray(graph.tvec)[use]
    pairs = np.asarray(graph.pairs)[use]
    wts = np.asarray(graph.num_inliers)[use].astype(np.float64)

    R, valid, res_rad = rotation_averaging(pairs, rel_r, num_images,
                                           weights=wts)
    # World-frame center direction per edge: d = -R_i^T R_ij^T t_ij.
    Rrel = _so3_exp_np(rel_r)
    Ri = R[pairs[:, 0]] if len(pairs) else np.zeros((0, 3, 3))
    d = -np.einsum("eji,ekj,ek->ei", Ri, Rrel, rel_t) if len(pairs) else rel_t
    # Gross-rotation edges carry corrupt translations too (a bad two-view
    # pose is bad as a unit): zero them out of the direction solve.
    t_wts = wts.copy()
    if len(res_rad):
        med = np.median(res_rad[np.isfinite(res_rad)]) if np.isfinite(res_rad).any() else 0.0
        t_wts[res_rad > max(3.0 * med, np.radians(10.0))] = 0.0
    if feats is not None and intrinsics is not None:
        # Scaled-displacement centers: per-edge baseline scales synced
        # through shared-track two-view depths. Direction-only averaging is
        # blind to spacing along collinear motion (arc clusters); the scale
        # sync removes that degeneracy using data the graph already carries.
        feats_xy = feats if isinstance(feats, np.ndarray) else feats.xy
        intr = np.asarray(intrinsics, np.float64)
        xn = (feats_xy - intr[:, None, 2:4]) / intr[:, None, 0:2]
        k1 = intr[:, 4]
        if np.any(k1) or np.any(intr[:, 5]):
            x = xn.copy()
            for _ in range(4):
                r2 = np.sum(x * x, axis=-1)
                x = xn / (1.0 + intr[:, None, 4] * r2
                          + intr[:, None, 5] * r2 * r2)[..., None]
            xn = x
        centers, solved = edge_scale_centers(
            pairs, d, rel_r, rel_t, np.asarray(graph.idx_i)[use],
            np.asarray(graph.idx_j)[use], np.asarray(graph.inlier)[use],
            xn, num_images, valid, weights=t_wts)
    else:
        centers, solved = translation_averaging(pairs, d, num_images, valid,
                                                weights=t_wts)
    rvecs = _so3_log_np(R)
    tvecs = -np.einsum("nij,nj->ni", R, centers)
    return rvecs.astype(np.float32), tvecs.astype(np.float32), solved


def straighten_reconstruction(rec, graph, cfg=None, verbose: bool = False,
                              feats=None, *, device) -> bool:
    """Replace a reconstruction's poses with sim3-aligned pose-graph poses
    and retriangulate its points (in place). Returns False (model untouched)
    when the pose graph doesn't cover enough of the model to align.

    This is the low-frequency-drift rescue for chained/merged large-scale
    models (BASELINE.md 10k postmortems): bundle adjustment's reprojection
    cost is flat along slow bends, but rotation averaging over the (densified)
    match graph is globally stiff. The caller should follow with the usual
    BA -> filter -> BA polish; this function only moves poses + DLT points.

    When `feats` is given, the pose-graph solve uses two-view-refined edge
    poses and scale-synced displacement centers (edge_scale_centers) —
    markedly stiffer along sequential-capture arcs.
    """
    from sfm_tpu_torch.geometry.similarity import umeyama_np

    K = len(rec.registered)
    rvecs_pg, tvecs_pg, valid = pose_graph_poses(
        graph, K, feats=feats,
        intrinsics=rec.intrinsics if feats is not None else None, device=device)
    both = valid & rec.registered
    if both.sum() < max(3, 0.5 * rec.registered.sum()):
        return False

    Rpg = _so3_exp_np(rvecs_pg[both])
    c_pg = -np.einsum("nji,nj->ni", Rpg, tvecs_pg[both])
    Rcur = _so3_exp_np(rec.rvecs[both])
    c_cur = -np.einsum("nji,nj->ni", Rcur, rec.tvecs[both])
    # ROBUST gauge alignment. The model being straightened is by assumption
    # damaged — a merged model can contain cluster chunks at wildly wrong
    # relative scale (a 512-run global-cluster merge measured sim3 chunk
    # scales spanning 0.006..28), and a plain umeyama against it explodes
    # (observed mean center move 1.5e7, followed by retriangulation
    # collapse and revert). Normalize both models to unit median spread
    # first (bounds the scale estimate), then umeyama, then a 50% trimmed
    # refit so the gauge comes from the largest consistent chunk.
    def _spread(c):
        return max(float(np.median(np.linalg.norm(c - c.mean(0), axis=1))),
                   1e-12)
    sp_pg, sp_cur = _spread(c_pg), _spread(c_cur)
    s, Rw, t = umeyama_np(c_pg / sp_pg, c_cur / sp_cur)
    fit = (s * (c_pg / sp_pg) @ np.asarray(Rw).T + np.asarray(t)) * sp_cur
    err = np.linalg.norm(fit - c_cur, axis=1)
    keep = err <= np.quantile(err, 0.5)
    if keep.sum() >= 3:
        s, Rw, t = umeyama_np(c_pg[keep], c_cur[keep])
    else:
        s, t = s * sp_cur / sp_pg, np.asarray(t) * sp_cur
    Rw = np.asarray(Rw)

    ids = np.where(both)[0]
    R_new = _so3_exp_np(rvecs_pg[ids]) @ Rw.T
    c_new = s * (-np.einsum("nji,nj->ni", _so3_exp_np(rvecs_pg[ids]),
                            tvecs_pg[ids])) @ Rw.T + np.asarray(t)
    rec.rvecs[ids] = _so3_log_np(R_new).astype(np.float32)
    rec.tvecs[ids] = (-np.einsum("nij,nj->ni", R_new, c_new)).astype(np.float32)
    if verbose:
        moved = float(np.mean(np.linalg.norm(c_new - c_cur, axis=1)))
        print(f"[sfm_tpu_torch]   pose-graph straighten: {int(both.sum())}/"
              f"{int(rec.registered.sum())} cameras, mean center move {moved:.3f}")
    # Poses may have moved a long way; a tight re-DLT gate would reject the
    # long tracks the following polish depends on.
    retriangulate_reconstruction(rec, cfg=cfg, max_error_px=16.0,
                                 min_angle_deg=0.5, device=device)
    return True


def retriangulate_reconstruction(rec, cfg=None, max_views: int = 16,
                                 max_error_px: float | None = None,
                                 min_angle_deg: float | None = None,
                                 only_points: np.ndarray | None = None, *, device) -> int:
    """Re-DLT every valid point from its observations at the CURRENT poses
    (in place; batched on `device`). Tracks longer than max_views use an evenly
    strided view subset — DLT conditioning saturates long before that.
    Returns the number of points that re-triangulated validly.

    max_error_px loosens the triangulation acceptance gate (it is a MAX
    over the track's views): graduated polish schedules retriangulate at
    rough poses where long tracks legitimately carry tens of px of max
    error — the default ~3 px gate would reject exactly the long tracks
    whose consolidation the polish depends on (measured on the 512-orbit
    oracle-track study: 600 full-ring tracks -> 1 surviving without this).
    """
    from sfm_tpu_torch.ops.triangulate import triangulate_tracks

    if rec.obs_point is None or not rec.num_points:
        return 0
    min_angle = min_angle_deg if min_angle_deg is not None else (
        1.5 if cfg is None else cfg.engine.min_triangulation_angle_deg)
    order = np.argsort(rec.obs_point, kind="stable")
    op = rec.obs_point[order]
    starts = np.searchsorted(op, np.arange(len(rec.points)), side="left")
    ends = np.searchsorted(op, np.arange(len(rec.points)), side="right")
    sel_mask = rec.point_valid & (ends - starts >= 2)
    if only_points is not None:
        # Restricted mode (e.g. placing freshly split-off fragments):
        # untouched points keep their position AND validity.
        m = np.zeros(len(rec.points), bool)
        m[only_points] = True
        sel_mask &= m
    pids = np.where(sel_mask)[0]
    if len(pids) == 0:
        return 0
    T = len(pids)
    V = int(min(max_views, (ends - starts)[pids].max()))
    sel = np.zeros((T, V), np.int64)
    mask = np.zeros((T, V), bool)
    for k, p in enumerate(pids):              # host loop over points: O(P), cheap
        rows = order[starts[p]:ends[p]]
        if len(rows) > V:
            rows = rows[np.linspace(0, len(rows) - 1, V).astype(np.int64)]
        sel[k, :len(rows)] = rows
        mask[k, :len(rows)] = True

    img = rec.obs_image[sel]
    intr = rec.intrinsics[img]
    # Normalized camera coords; ladder/synthetic intrinsics carry no
    # distortion — apply the 2-term inverse only when k1/k2 are present.
    uv = rec.obs_uv[sel]
    xy = (uv - intr[..., 2:4]) / intr[..., 0:2]
    k1, k2 = intr[..., 4], intr[..., 5]
    if np.any(k1) or np.any(k2):
        x = xy.copy()
        for _ in range(4):                    # fixed-point undistort
            r2 = np.sum(x * x, axis=-1)
            x = xy / (1.0 + k1 * r2 + k2 * r2 * r2)[..., None]
        xy = x

    err_norm = (0.01 if max_error_px is None
                else max_error_px / max(float(np.median(rec.intrinsics[:, 0])), 1e-6))
    tri = triangulate_tracks(
        *(torch.from_numpy(np.ascontiguousarray(a)).to(device)
          for a in (rec.rvecs[img].astype(np.float32), rec.tvecs[img].astype(np.float32),
                    xy.astype(np.float32), mask)),
        min_angle_deg=float(min_angle), max_error_norm=float(err_norm),
    )
    pts = tri.points.cpu().numpy()
    ok = tri.valid.cpu().numpy()
    rec.points[pids] = pts
    rec.point_valid[pids] = ok
    if only_points is None:
        rec.point_valid[np.setdiff1d(np.where(rec.point_valid)[0], pids)] = False
    return int(ok.sum())
