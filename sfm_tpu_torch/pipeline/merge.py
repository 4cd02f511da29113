"""Cluster merge (port of sfm_tpu/pipeline/merge.py; SURVEY.md §2.7): sim3
alignment via shared cameras + track-level deduplication.

Host bookkeeping in numpy, carried over from the JAX package line for line
(its known faults included, so that both packages merge alike); the three
rotation helpers run in torch on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry.projection import camera_center
from sfm_tpu_torch.geometry.rotations import so3_exp, matrix_to_aa
from sfm_tpu_torch.geometry.similarity import umeyama_np
from sfm_tpu_torch.scene.state import Reconstruction


def _centers(rec: Reconstruction, imgs: np.ndarray) -> np.ndarray:
    return camera_center(torch.from_numpy(np.asarray(rec.rvecs[imgs], np.float32)),
                         torch.from_numpy(np.asarray(rec.tvecs[imgs], np.float32))).numpy()


def apply_sim3_to_reconstruction(rec: Reconstruction, s: float, R: np.ndarray, t: np.ndarray) -> Reconstruction:
    """Transform a reconstruction's world frame: x' = s R x + t.

    Camera pose update (preserving pixel projections, depth scaled by s):
    R' = R_cam R^T, t' = s t_cam - R' t.
    """
    rec = Reconstruction(**{**rec.__dict__})
    Rc = so3_exp(torch.from_numpy(np.asarray(rec.rvecs, np.float32))).numpy()
    Rp = np.einsum("kij,lj->kil", Rc, R)  # R_cam @ R^T
    rec.rvecs = matrix_to_aa(torch.from_numpy(Rp.astype(np.float32))).numpy()
    rec.tvecs = (s * rec.tvecs - np.einsum("kij,j->ki", Rp, t)).astype(np.float32)
    rec.points = (s * rec.points @ R.T + t).astype(np.float32)
    return rec


_MIN_SHARED_POINTS = 16  # track-only alignment support threshold
_MAX_EDGE_REL_RMS = 0.08  # sim3 edges whose trimmed alignment residual
                          # exceeds this fraction of the correspondence
                          # spread are measurements of nothing — reject


def _obs_identity_match(base: Reconstruction, other: Reconstruction):
    """(image, keypoint)-keyed observation match — geometry-free.

    Returns (matched [O_other] bool, base_pid_of_row [O_other] int)."""
    kb = base.obs_image.astype(np.int64) << 32 | base.obs_kp.astype(np.int64)
    ko = other.obs_image.astype(np.int64) << 32 | other.obs_kp.astype(np.int64)
    order = np.argsort(kb, kind="stable")
    kb_sorted = kb[order]
    pos = np.searchsorted(kb_sorted, ko)
    pos_c = np.minimum(pos, len(kb_sorted) - 1) if len(kb_sorted) else np.zeros_like(pos)
    matched = (len(kb_sorted) > 0) & (kb_sorted[pos_c] == ko)
    base_pid_of_row = np.where(matched, base.obs_point[order[pos_c]], -1)
    return matched, base_pid_of_row


def relative_sim3(base: Reconstruction, other: Reconstruction, min_shared: int = 3):
    """Trimmed sim3 aligning `other` into `base`'s frame: x_base = s R x + t.

    Correspondences are shared registered camera centers PLUS shared 3D
    points (tracks matched by observation identity). The overlap cameras
    alone are a short, nearly-collinear arc of the capture path, so a
    camera-only Umeyama leaves a free rotation about that arc; shared tracks
    pin it. An iterated 25%-trimmed re-fit drops wrongly-linked tracks.
    Returns (s, R, t, support, rel_rms) where rel_rms is the trimmed RMS
    alignment residual as a fraction of the correspondence spread (the
    edge-quality score). Raises ValueError when the pair shares neither
    min_shared cameras nor _MIN_SHARED_POINTS tracks — a pair CAN be aligned
    on shared tracks alone (long tracks cross cluster seams even where the
    seam cameras failed to register; without those edges a closed capture
    loop synchronizes as a tree and keeps its drift)."""
    shared = np.where(base.registered & other.registered)[0]

    matched, base_pid_of_row = _obs_identity_match(base, other)
    pair_rows = np.where(
        matched
        & other.point_valid[other.obs_point]
        & base.point_valid[np.maximum(base_pid_of_row, 0)]
    )[0]
    pid_pairs = np.unique(
        np.stack([other.obs_point[pair_rows], base_pid_of_row[pair_rows]], axis=1), axis=0
    ) if len(pair_rows) else np.zeros((0, 2), np.int64)
    if len(shared) < min_shared and len(pid_pairs) < _MIN_SHARED_POINTS:
        raise ValueError(
            f"only {len(shared)} shared cameras and {len(pid_pairs)} shared tracks"
        )

    src = np.concatenate([_centers(other, shared), other.points[pid_pairs[:, 0]]])
    dst = np.concatenate([_centers(base, shared), base.points[pid_pairs[:, 1]]])
    # Host-numpy solve: this runs O(n_clusters^2) times with pair-specific
    # correspondence counts — device dispatch would pay per-shape compiles.
    s, R, t = umeyama_np(src, dst)
    keep = np.ones(len(src), bool)
    if len(src) > 2 * len(shared):
        # Iterated 25%-trim: a single trim pass left wrongly-linked tracks
        # in control of track-dominated edges (the 10k scale-chimera run —
        # one bad tree edge scaled a whole cluster subtree ~190x).
        for _ in range(3):
            res = np.linalg.norm((s * src @ R.T + t) - dst, axis=1)
            new_keep = res <= np.quantile(res[keep], 0.75)
            if new_keep.sum() < max(3, len(src) // 8):
                break
            keep = new_keep
            s, R, t = umeyama_np(src[keep], dst[keep])
    # Alignment quality: trimmed RMS residual relative to the correspondence
    # spread — callers reject edges that merely found SOME transform.
    res = np.linalg.norm((s * src[keep] @ R.T + t) - dst[keep], axis=1)
    spread = np.linalg.norm(dst[keep] - dst[keep].mean(0), axis=1).mean() + 1e-12
    rel_rms = float(np.sqrt((res ** 2).mean()) / spread)
    return s, R, t, int(keep.sum()), rel_rms


def merge_two(base: Reconstruction, other: Reconstruction, min_shared: int = 3, verbose: bool = False,
              align: bool = True) -> Reconstruction:
    """Align `other` into `base`'s frame (see relative_sim3), then union
    points/observations with (image, keypoint)-keyed dedup.

    align=False skips the sim3 (the caller has already placed both models in
    one frame, e.g. via synchronize_sim3)."""
    if align:
        s, R, t, _, _ = relative_sim3(base, other, min_shared)
        other = apply_sim3_to_reconstruction(other, s, R, t)

    matched, base_pid_of_row = _obs_identity_match(base, other)

    # Merged camera set: base wins on shared cameras.
    out = Reconstruction(**{**base.__dict__})
    out.rvecs = base.rvecs.copy()
    out.tvecs = base.tvecs.copy()
    out.registered = base.registered.copy()
    only_other = other.registered & ~base.registered
    out.rvecs[only_other] = other.rvecs[only_other]
    out.tvecs[only_other] = other.tvecs[only_other]
    out.registered |= other.registered

    valid_row = other.point_valid[other.obs_point]
    P_other = len(other.points)
    # Track-level link: an other-track that shares any (image, kp) with base
    # merges into that base point (smallest matching id on conflicts).
    target = np.full(P_other, np.iinfo(np.int64).max, np.int64)
    link_rows = np.where(matched & valid_row)[0]
    np.minimum.at(target, other.obs_point[link_rows], base_pid_of_row[link_rows].astype(np.int64))
    linked = target != np.iinfo(np.int64).max

    # Fresh points for unlinked valid tracks that actually carry observations.
    has_rows = np.zeros(P_other, bool)
    has_rows[other.obs_point[valid_row]] = True
    fresh = other.point_valid & ~linked & has_rows
    n_base = len(base.points)
    fresh_ids = np.cumsum(fresh) - 1 + n_base
    target = np.where(fresh, fresh_ids, target)

    # Rows to append: valid-track rows whose key is not already in base.
    app = np.where(valid_row & ~matched & (linked | fresh)[other.obs_point])[0]
    # Guard against duplicate keys inside `other` itself (keep first).
    ko = other.obs_image.astype(np.int64) << 32 | other.obs_kp.astype(np.int64)
    _, first_idx = np.unique(ko[app], return_index=True)
    app = app[np.sort(first_idx)]

    out.points = np.concatenate([base.points, other.points[fresh]]).astype(np.float32)
    out.point_valid = np.concatenate([base.point_valid, np.ones(int(fresh.sum()), bool)])
    out.point_errors = np.zeros(len(out.points), np.float32)
    out.obs_point = np.concatenate([base.obs_point, target[other.obs_point[app]]]).astype(np.int32)
    out.obs_image = np.concatenate([base.obs_image, other.obs_image[app]]).astype(np.int32)
    out.obs_kp = np.concatenate([base.obs_kp, other.obs_kp[app]]).astype(np.int32)
    out.obs_uv = np.concatenate([base.obs_uv, other.obs_uv[app]]).astype(np.float32)
    return out


def _project_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    return R


def synchronize_sim3(recs: list[Reconstruction], min_shared: int = 3, verbose: bool = False):
    """Global sim3 synchronization over the cluster-overlap graph.

    Chaining pairwise alignments accumulates drift — at 19 clusters around a
    closed capture loop the chained merge bent the ring by ~30% of its
    radius while staying internally consistent (windowed BA cannot undo a
    smooth global deformation). Reference-class large-scale SfM closes the
    loop by estimating EVERY overlapping pair's relative sim3 and solving
    one small synchronization problem over cluster frames (SURVEY.md §2.7
    merge/alignment):

      rotations:    R_j ~ R_i @ R_ij  — spanning-tree init + weighted
                    chordal Gauss-Seidel sweeps with SO(3) projection;
      log-scales:   log s_j - log s_i = log s_ij — linear LS on the graph;
      translations: t_j - t_i = s_i R_i t_ij     — linear LS given (s, R).

    Returns per-cluster (s_i, R_i, t_i) mapping cluster frames into the
    anchor (largest cluster) frame, or None for clusters disconnected from
    the anchor's component. The graph has as many nodes as clusters, so the
    whole solve is microseconds of host linear algebra.
    """
    n = len(recs)
    anchor = 0  # recs are sorted largest-first by the caller
    edges = []     # (i, j, s_ij, R_ij, t_ij, w): x_i = s_ij R_ij x_j + t_ij
    rejected = []  # (edge, rel_rms) — kept for connectivity re-admission
    for i in range(n):
        for j in range(i + 1, n):
            try:
                s, R, t, support, rel_rms = relative_sim3(recs[i], recs[j], min_shared)
            except ValueError:
                continue
            edge = (i, j, s, R, t, float(support))
            if rel_rms > _MAX_EDGE_REL_RMS:
                # An alignment whose trimmed residual is a large fraction of
                # the correspondence spread is not a measurement — one such
                # edge in a TREE-shaped sync graph scaled a 10k-run cluster
                # subtree by ~190x (the scale-chimera postmortem, NOTES.md).
                if verbose:
                    print(f"[sfm_tpu_torch] sim3 edge ({i},{j}) REJECTED: "
                          f"rel_rms={rel_rms:.3f} support={support} s={s:.3g}")
                rejected.append((edge, rel_rms))
                continue
            if verbose:
                print(f"[sfm_tpu_torch] sim3 edge ({i},{j}): support={support} "
                      f"s={s:.4g} rel_rms={rel_rms:.4f}")
            edges.append(edge)

    # Connectivity re-admission: a poor seam alignment plus the global
    # polish beats silently dropping every camera in a severed component.
    target = _reach(n, edges + [e for e, _ in rejected], anchor)
    reach = _reach(n, edges, anchor)
    while (target & ~reach).any() and rejected:
        cand = [(rel, k) for k, (e, rel) in enumerate(rejected)
                if reach[e[0]] != reach[e[1]]]
        if not cand:
            break
        _, k = min(cand)
        edge, rel = rejected.pop(k)
        if verbose:
            print(f"[sfm_tpu_torch] sim3 edge ({edge[0]},{edge[1]}) re-admitted for "
                  f"connectivity (rel_rms={rel:.3f})")
        edges.append(edge)
        reach = _reach(n, edges, anchor)

    if verbose:
        print(f"[sfm_tpu_torch] sim3 sync: {n} clusters, {len(edges)} overlap edges")

    edges = _audit_edges(n, edges, anchor, verbose)
    return _finish_sync(n, edges, anchor)


def _audit_edges(n, edges, anchor, verbose=False):
    """Scale-consistency audit: with redundant edges, one inconsistent
    measurement shows up as a large per-edge log-scale residual after the
    LS solve; drop the worst and re-solve while the graph stays connected.
    (A tree cannot be audited — its residuals are exactly 0; the rel_rms
    rejection in synchronize_sim3 is the tree's only defense.)"""
    for _attempt in range(4):
        s_g, _R_g, _t_g, comp = _sync_solve(n, edges, anchor)
        resid = [
            (abs(np.log(max(s_g[i], 1e-12) * s_ij / max(s_g[j], 1e-12))), e_id)
            for e_id, (i, j, s_ij, *_r) in enumerate(edges)
            if comp[i] and comp[j]
        ]
        if not resid:
            break
        worst, worst_id = max(resid)
        if worst < np.log(1.3):
            break
        trial = [e for k, e in enumerate(edges) if k != worst_id]
        if not _stays_connected(n, trial, anchor, comp):
            if verbose:
                print(f"[sfm_tpu_torch] sim3 audit: worst edge residual {worst:.2f} "
                      "but graph would disconnect; keeping")
            break
        if verbose:
            i, j, s_ij, *_ = edges[worst_id]
            print(f"[sfm_tpu_torch] sim3 audit: dropping edge ({i},{j}) "
                  f"(log-scale residual {worst:.2f}, s_ij={s_ij:.3g})")
        edges = trial
    return edges


def _reach(n, edges, anchor) -> np.ndarray:
    adj = [[] for _ in range(n)]
    for (i, j, *_r) in edges:
        adj[i].append(j)
        adj[j].append(i)
    seen = np.zeros(n, bool)
    seen[anchor] = True
    stack = [anchor]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                stack.append(v)
    return seen


def _stays_connected(n, edges, anchor, comp_before) -> bool:
    return bool((_reach(n, edges, anchor) | ~comp_before).all())


def _finish_sync(n, edges, anchor):
    s_g, R_g, t_g, comp = _sync_solve(n, edges, anchor)
    return [((float(s_g[i]), R_g[i], t_g[i]) if comp[i] else None) for i in range(n)]


def _sync_solve(n, edges, anchor):
    """Spanning-tree init + chordal rotation averaging + log-scale and
    translation LS over the given edge list (see synchronize_sim3)."""
    # Connected component of the anchor via the edge list.
    adj = [[] for _ in range(n)]
    for e_id, (i, j, *_rest) in enumerate(edges):
        adj[i].append((j, e_id))
        adj[j].append((i, e_id))
    comp = np.zeros(n, bool)
    comp[anchor] = True
    # Spanning-tree initialization of rotations/scales/translations.
    s_g = np.ones(n)
    R_g = np.tile(np.eye(3), (n, 1, 1))
    t_g = np.zeros((n, 3))
    stack = [anchor]
    while stack:
        i = stack.pop()
        for j, e_id in adj[i]:
            if comp[j]:
                continue
            comp[j] = True
            ei, ej, s_ij, R_ij, t_ij, _w = edges[e_id]
            if ei == i:  # x_i = s_ij R_ij x_j + t_ij  ->  T_j = T_i o M_ij
                s_g[j] = s_g[i] * s_ij
                R_g[j] = R_g[i] @ R_ij
                t_g[j] = s_g[i] * R_g[i] @ t_ij + t_g[i]
            else:        # inverse measurement
                s_inv = 1.0 / s_ij
                R_inv = R_ij.T
                t_inv = -s_inv * R_inv @ t_ij
                s_g[j] = s_g[i] * s_inv
                R_g[j] = R_g[i] @ R_inv
                t_g[j] = s_g[i] * R_g[i] @ t_inv + t_g[i]
            stack.append(j)

    in_edges = [(i, j, s, R, t, w) for (i, j, s, R, t, w) in edges if comp[i] and comp[j]]
    if not in_edges:
        return s_g, R_g, t_g, comp

    # Rotation averaging: weighted chordal Gauss-Seidel.
    for _ in range(8):
        for node in range(n):
            if node == anchor or not comp[node]:
                continue
            acc = np.zeros((3, 3))
            for (i, j, _s, R_ij, _t, w) in in_edges:
                if j == node:
                    acc += w * (R_g[i] @ R_ij)
                elif i == node:
                    acc += w * (R_g[j] @ R_ij.T)
            if np.abs(acc).sum() > 0:
                R_g[node] = _project_so3(acc)

    # Log-scale LS on the graph (anchor pinned to 0).
    free = [i for i in range(n) if comp[i] and i != anchor]
    col = {node: k for k, node in enumerate(free)}
    if free:
        A = np.zeros((len(in_edges), len(free)))
        b = np.zeros(len(in_edges))
        w_sqrt = np.sqrt([w for (*_x, w) in in_edges])
        for r, (i, j, s_ij, _R, _t, w) in enumerate(in_edges):
            # s_j = s_i * s_ij  ->  log s_j - log s_i = log s_ij
            if j != anchor:
                A[r, col[j]] += 1.0
            if i != anchor:
                A[r, col[i]] -= 1.0
            b[r] = np.log(s_ij)
        sol = np.linalg.lstsq(A * w_sqrt[:, None], b * w_sqrt, rcond=None)[0]
        for node, k in col.items():
            s_g[node] = np.exp(sol[k])

        # Translation LS given (s, R): t_i - t_j = -s_j R_j inv? Derive from
        # T_i = T_j o M_ji ... use the forward relation per edge:
        # x_i = s_ij R_ij x_j + t_ij and T_i o that = T_j:
        #   t_j = s_i R_i t_ij + t_i  ->  t_j - t_i = s_i R_i t_ij
        A3 = np.zeros((3 * len(in_edges), 3 * len(free)))
        b3 = np.zeros(3 * len(in_edges))
        for r, (i, j, _s, _R, t_ij, w) in enumerate(in_edges):
            rhs = s_g[i] * R_g[i] @ t_ij
            sw = np.sqrt(w)
            if j != anchor:
                A3[3 * r: 3 * r + 3, 3 * col[j]: 3 * col[j] + 3] = sw * np.eye(3)
            if i != anchor:
                A3[3 * r: 3 * r + 3, 3 * col[i]: 3 * col[i] + 3] -= sw * np.eye(3)
            b3[3 * r: 3 * r + 3] = sw * rhs
        sol3 = np.linalg.lstsq(A3, b3, rcond=None)[0]
        for node, k in col.items():
            t_g[node] = sol3[3 * k: 3 * k + 3]

    return s_g, R_g, t_g, comp


def merge_tracks_by_correspondence(
    rec: Reconstruction, graph, min_votes: int = 2, dist_frac: float = 0.05,
    verbose: bool = False,
) -> int:
    """Consolidate fragmented tracks using verified match-graph edges
    (COLMAP CompleteAndMergeTracks analog, SURVEY.md §2.5 retriangulation).

    Partitioned reconstruction never consumes cross-cluster match edges: each
    cluster builds tracks from its masked subgraph, and the merge dedups only
    identical (image, kp) observations. Every inlier correspondence
    (i, ki) ~ (j, kj) whose endpoints landed in two DIFFERENT merged points
    is therefore unused evidence that those points are one physical track.
    This pass counts such votes per point pair and union-finds pairs with
    >= min_votes votes whose 3D separation is below dist_frac of the scene
    scale (RMS point spread) — the distance gate keeps repeated-texture
    false matches from gluing distant structure. Mutates `rec` in place;
    returns the number of merged (absorbed) points. Host-side numpy: the
    vote table is O(total correspondences), microseconds-per-million rows.
    """
    pv = rec.point_valid
    val_rows = pv[rec.obs_point]
    kb = (rec.obs_image[val_rows].astype(np.int64) << 32) | rec.obs_kp[val_rows].astype(np.int64)
    pb = rec.obs_point[val_rows]
    order = np.argsort(kb, kind="stable")
    kb_s, pb_s = kb[order], pb[order]
    if len(kb_s) == 0:
        return 0

    def lookup(img, kp):
        ko = (img.astype(np.int64) << 32) | kp.astype(np.int64)
        pos = np.searchsorted(kb_s, ko)
        pos_c = np.minimum(pos, len(kb_s) - 1)
        hit = kb_s[pos_c] == ko
        return hit, np.where(hit, pb_s[pos_c], -1)

    ok_e = np.where(graph.ok)[0]
    if len(ok_e) == 0:
        return 0
    e_idx, m_idx = np.where(graph.inlier[ok_e])
    img_i = graph.pairs[ok_e][e_idx, 0]
    img_j = graph.pairs[ok_e][e_idx, 1]
    kp_i = graph.idx_i[ok_e][e_idx, m_idx]
    kp_j = graph.idx_j[ok_e][e_idx, m_idx]
    hi, pi = lookup(img_i, kp_i)
    hj, pj = lookup(img_j, kp_j)
    both = hi & hj & (pi != pj)
    if not both.any():
        return 0
    a = np.minimum(pi[both], pj[both]).astype(np.int64)
    b = np.maximum(pi[both], pj[both]).astype(np.int64)
    key, counts = np.unique((a << 32) | b, return_counts=True)
    key = key[counts >= min_votes]
    if len(key) == 0:
        return 0
    pa = (key >> 32).astype(np.int64)
    pb2 = (key & 0xFFFFFFFF).astype(np.int64)

    pts = rec.points
    centroid = pts[pv].mean(0)
    scale = float(np.sqrt(((pts[pv] - centroid) ** 2).sum(-1).mean()))
    d = np.linalg.norm(pts[pa] - pts[pb2], axis=1)
    keep = d <= dist_frac * max(scale, 1e-9)
    pa, pb2 = pa[keep], pb2[keep]
    if len(pa) == 0:
        return 0
    n = _apply_point_merges(rec, pa, pb2)
    if verbose and n:
        print(f"[sfm_tpu_torch] track merge: absorbed {n} fragment points "
              f"({len(pa)} voted pairs)")
    return n


def _apply_point_merges(rec: Reconstruction, pa: np.ndarray, pb: np.ndarray) -> int:
    """Union-find the accepted point pairs and rewrite `rec` in place:
    absorbed points invalidate, their observations remap to the surviving
    root (observation-count-weighted mean position — the follow-up polish
    BA refines it), and (image, kp)-duplicate rows created by the remap are
    dropped. Returns the number of absorbed points."""
    pts = rec.points
    pv = rec.point_valid
    val_rows = pv[rec.obs_point]

    # Union-find with path halving over the accepted pairs.
    parent = np.arange(len(pts), dtype=np.int64)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for x, y in zip(pa, pb):
        rx, ry = find(int(x)), find(int(y))
        if rx != ry:
            parent[max(rx, ry)] = min(rx, ry)
    root = np.array([find(i) for i in range(len(pts))], dtype=np.int64)
    absorbed = (root != np.arange(len(pts))) & pv

    w = np.bincount(rec.obs_point[val_rows], minlength=len(pts)).astype(np.float64)
    w = np.where(pv, np.maximum(w, 1.0), 0.0)
    sum_xyz = np.zeros((len(pts), 3))
    np.add.at(sum_xyz, root, w[:, None] * pts)
    sum_w = np.zeros(len(pts))
    np.add.at(sum_w, root, w)
    merged_roots = np.unique(root[absorbed])
    pts[merged_roots] = (sum_xyz[merged_roots] / np.maximum(sum_w[merged_roots], 1e-9)[:, None]).astype(np.float32)
    rec.point_valid = pv & ~absorbed

    rec.obs_point = root[rec.obs_point].astype(np.int32)
    # Dedup exact (image, kp, point) rows created by the remap.
    okey = (rec.obs_image.astype(np.int64) << 32) | rec.obs_kp.astype(np.int64)
    _, first = np.unique(okey, return_index=True)
    sel = np.sort(first)
    rec.obs_point = rec.obs_point[sel]
    rec.obs_image = rec.obs_image[sel]
    rec.obs_kp = rec.obs_kp[sel]
    rec.obs_uv = rec.obs_uv[sel]
    return int(absorbed.sum())


def _so3_exp_np(rvecs: np.ndarray) -> np.ndarray:
    """Batched numpy angle-axis -> rotation matrices (host-side gating paths
    must not pay a remote-device round trip per call)."""
    rvecs = np.asarray(rvecs, np.float64)
    th = np.linalg.norm(rvecs, axis=-1, keepdims=True)
    th = np.where(th < 1e-12, 1e-12, th)
    k = rvecs / th
    K = np.zeros(rvecs.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    s = np.sin(th)[..., None]
    c = (1.0 - np.cos(th))[..., None]
    return np.eye(3) + s * K + c * (K @ K)


def _project_np(
    x_world: np.ndarray, R: np.ndarray, t: np.ndarray, intr: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side projection matching geometry.projection.project: per-row
    world point -> (pixel, camera-frame depth) under the row's camera
    (radial k1/k2 model). Depth is returned so gates can reject
    behind-camera placements — those reproject to FINITE pixels (x/z double
    sign flip) and would otherwise pass any pixel-error threshold."""
    xc = np.einsum("oij,oj->oi", R, x_world) + t
    z = xc[:, 2]
    zs = np.where(np.abs(z) < 1e-8, np.where(z < 0, -1e-8, 1e-8), z)
    xy = xc[:, :2] / zs[:, None]
    r2 = (xy * xy).sum(-1)
    xy = xy * (1.0 + r2 * (intr[:, 4] + r2 * intr[:, 5]))[:, None]
    return xy * intr[:, :2] + intr[:, 2:4], z


def _union_reproj_gate(
    rec: Reconstruction, pa: np.ndarray, pb: np.ndarray,
    rel_factor: float, floor_px: float, max_px: float, gate_obs_cap: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Quality-preserving union-reprojection gate over candidate point pairs.

    For each pair, the observation-count-weighted merged position must
    reproject into EACH side's observations (per-side gate: a long healthy
    track must not vote down its own absorption of a short bad one) with
    mean error within min(max_px, max(rel_factor x the sides' current worst
    per-side fit, floor_px)). Cheirality hard-fails a side. Returns
    (indices into pa/pb that pass, per-pair worst mean error).

    Rationale for the relative gate: two arc-copies of the SAME physical
    point and two DISTINCT sub-blob features can sit at the same 3D
    separation (the 10k blob scene: child splats subtend ~2.6px, the same
    range as residual cluster-alignment drift), so an absolute max_px gate
    fuses distinct features and bakes in irreducible ~d/2 residuals
    (observed: 2048-ladder refine rounds ended at 2.15px mean reprojection
    vs 0.56px unrefined). The relative gate only accepts fusions the
    current geometry certifies as near-lossless.
    """
    pv = rec.point_valid
    # Per-point observation index (sorted-by-point rows, capped per track).
    val_rows = np.where(pv[rec.obs_point])[0]
    order = val_rows[np.argsort(rec.obs_point[val_rows], kind="stable")]
    op_sorted = rec.obs_point[order]
    starts = np.searchsorted(op_sorted, np.arange(len(rec.points)))
    counts = np.bincount(op_sorted, minlength=len(rec.points))
    cap_counts = np.minimum(counts, gate_obs_cap)

    def _side_rows(pids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Observation rows (into rec.obs_*) for each pair's side + the pair
        index of every row. Long tracks are strided down to gate_obs_cap."""
        c = cap_counts[pids]
        total = int(c.sum())
        pair_of_row = np.repeat(np.arange(len(pids)), c)
        # Within-pair offsets 0..c-1 without a Python loop.
        off = np.arange(total) - np.repeat(np.cumsum(c) - c, c)
        stride = np.maximum(counts[pids] // np.maximum(c, 1), 1)
        rows = order[starts[pids][pair_of_row] + off * stride[pair_of_row]]
        return rows, pair_of_row

    # Merged candidate position: observation-count-weighted mean.
    w_a = counts[pa].astype(np.float64)[:, None]
    w_b = counts[pb].astype(np.float64)[:, None]
    m_pos = (w_a * rec.points[pa] + w_b * rec.points[pb]) / np.maximum(w_a + w_b, 1e-9)

    R_all = _so3_exp_np(rec.rvecs)
    side_err, side_pre = [], []
    for pids in (pa, pb):
        rows, pair_of_row = _side_rows(pids)
        img = rec.obs_image[rows]
        Rv, tv, Kv, uv = R_all[img], rec.tvecs[img], rec.intrinsics[img], rec.obs_uv[rows]
        nobs = np.maximum(np.bincount(pair_of_row, minlength=len(pa)), 1)
        proj, depth = _project_np(m_pos[pair_of_row], Rv, tv, Kv)
        err = np.linalg.norm(proj - uv, axis=1)
        # Cheirality: a merged position behind any observing camera fails
        # the pair outright (finite-pixel sign-flip projections must not
        # average into an acceptable mean error).
        err = np.where(depth > 0, err, np.inf)
        side_err.append(np.bincount(pair_of_row, weights=err, minlength=len(pa)) / nobs)
        # Each side's CURRENT fit (its own position over the same rows):
        # the baseline for the quality-preservation gate below.
        proj0, depth0 = _project_np(rec.points[pids][pair_of_row], Rv, tv, Kv)
        err0 = np.linalg.norm(proj0 - uv, axis=1)
        err0 = np.where(depth0 > 0, err0, np.inf)
        side_pre.append(np.bincount(pair_of_row, weights=err0, minlength=len(pa)) / nobs)
    worst = np.maximum(side_err[0], side_err[1])
    baseline = np.minimum(np.maximum(side_pre[0], side_pre[1]), max_px)
    gate = np.minimum(max_px, np.maximum(rel_factor * baseline, floor_px))
    return np.where(worst <= gate)[0], worst


def conflict_tolerant_track_ids(graph, feats, dedup_px: float = 1.5) -> np.ndarray:
    """[B, K] component id per keypoint over the verified match graph, with
    same-position detection ALIASING and no same-image conflict cut.

    The production track-building code's dup-tolerant union-find REFUSES unions
    that would put two keypoints of one image in one track — the right
    policy for building BA tracks, but it fragments transitive identity:
    ~36% of detections have a scale-space duplicate within 1-2 px (measured,
    512-orbit), the matcher alternates between the duplicates across edges,
    and every alternation is a refused union (global tracks: mean length
    7.7 vs ~170 images seeing a blob). Here duplicates within dedup_px
    alias to one canonical node first (grid hash — genuinely distinct
    sub-blob features at >=2.6 px stay distinct), and components are then
    plain connected components of the correspondence graph: contamination
    that conflict-cutting would have caught is instead handled by the
    union-reprojection gate + consensus splits downstream.

    Min-label propagation with pointer doubling (vectorized numpy): O(E)
    per round, converges in ~log(diameter) rounds.
    """
    xy = np.asarray(feats.xy)
    B, K = xy.shape[:2]

    # Alias EDGES: keypoints of one image sharing a dedup_px grid cell link
    # into a star. Two half-cell-offset grids so boundary-straddling
    # duplicates (a 0.3 px pair can split across adjacent cells of a single
    # grid) are still caught by the other grid.
    def _alias_edges(offset):
        cell = np.floor((xy + offset) / max(dedup_px, 1e-6)).astype(np.int64)
        key = (np.arange(B, dtype=np.int64)[:, None] << 44) \
            | ((cell[..., 0] & 0x3FFFFF) << 22) | (cell[..., 1] & 0x3FFFFF)
        flat = key.reshape(-1)
        order = np.argsort(flat, kind="stable")
        srt = flat[order]
        first = np.r_[True, srt[1:] != srt[:-1]]
        run_id = np.cumsum(first) - 1
        run_first = order[np.where(first)[0]]
        # Star: every member links to its run's first member.
        return run_first[run_id], order

    edges_a, edges_b = [], []
    for off in (0.0, dedup_px * 0.5):
        a, b = _alias_edges(off)
        edges_a.append(a)
        edges_b.append(b)

    ok_e = np.where(graph.ok)[0]
    if len(ok_e):
        e_idx, m_idx = np.where(graph.inlier[ok_e])
        edges_a.append(graph.pairs[ok_e][e_idx, 0].astype(np.int64) * K
                       + graph.idx_i[ok_e][e_idx, m_idx])
        edges_b.append(graph.pairs[ok_e][e_idx, 1].astype(np.int64) * K
                       + graph.idx_j[ok_e][e_idx, m_idx])
    a = np.concatenate(edges_a)
    b = np.concatenate(edges_b)
    parent = np.arange(B * K, dtype=np.int64)
    for _ in range(64):
        pa, pb = parent[a], parent[b]
        lo = np.minimum(pa, pb)
        changed = False
        for hi, lo_ in ((pa, lo), (pb, lo)):
            upd = lo_ < parent[hi]
            if upd.any():
                np.minimum.at(parent, hi[upd], lo_[upd])
                changed = True
        # Pointer doubling until the tree flattens.
        for _ in range(4):
            gp = parent[parent]
            if (gp == parent).all():
                break
            parent = gp
        if not changed:
            break
    return parent.reshape(B, K)


def merge_tracks_by_track_id(
    rec: Reconstruction, graph, num_images: int, max_kp: int,
    rel_factor: float = 3.0, floor_px: float = 2.0, max_px: float = 8.0,
    gate_obs_cap: int = 64, verbose: bool = False, tracks=None,
    exclude: set | None = None, gid_map: np.ndarray | None = None,
) -> int:
    """Consolidate cross-cluster duplicate points by TRANSITIVE match-graph
    identity (full-graph union-find track ids), the missing closure of
    merge_tracks_by_correspondence (SURVEY.md §2.5/§2.7 track merging).

    Direct correspondence votes require a verified edge whose two endpoint
    keypoints BOTH survived into the merged model as observations — at 512
    images that yields single-digit voted pairs while mean track length
    sits ~15x below the oracle (the r4 consolidation study's gap). Identity
    through the FULL match graph's union-find is transitive: cluster A's
    copy and cluster B's copy of one physical blob link through chains of
    correspondences, including keypoints no cluster retained. Each merged
    point maps to the majority global-track-id of its observations; points
    sharing a majority id are fused into the group's best-observed member,
    gated by the union-reprojection check (generous settings — the 2D
    identity evidence is strong; sub-blob features are naturally excluded
    because the dup-tolerant union-find CUTS same-image keypoint conflicts,
    giving distinct sub-blob detections distinct global ids).

    `gid_map` ([B, K] per-keypoint component ids, e.g. from
    conflict_tolerant_track_ids) takes precedence; otherwise `tracks` (a
    TrackSet) or a fresh build_tracks supplies the identity. Either can be
    passed in to reuse one union-find across refine rounds. Mutates rec;
    returns absorbed-point count.
    """
    pv = rec.point_valid
    val_rows = np.where(pv[rec.obs_point])[0]
    if len(val_rows) == 0:
        return 0
    if gid_map is not None:
        gids = gid_map[rec.obs_image[val_rows], rec.obs_kp[val_rows]].astype(np.int64)
        T = int(gid_map.max())
    else:
        from sfm_tpu_torch.scene.tracks import build_tracks

        if tracks is None:
            tracks = build_tracks(graph, num_images, max_kp)
        if tracks.num_tracks == 0:
            return 0
        # (image, kp) -> global track id lookup.
        kb = (tracks.obs_image.astype(np.int64) << 32) | tracks.obs_kp.astype(np.int64)
        order = np.argsort(kb, kind="stable")
        kb_s, gid_s = kb[order], tracks.track_id[order]
        if len(kb_s) == 0:
            return 0
        ko = (rec.obs_image[val_rows].astype(np.int64) << 32) | rec.obs_kp[val_rows].astype(np.int64)
        pos = np.minimum(np.searchsorted(kb_s, ko), len(kb_s) - 1)
        hit = kb_s[pos] == ko
        gids = np.where(hit, gid_s[pos], -1)
        T = int(tracks.num_tracks)
    pids = rec.obs_point[val_rows].astype(np.int64)

    m = gids >= 0
    if not m.any():
        return 0
    pg = pids[m] * (T + 1) + gids[m]
    key, cnt = np.unique(pg, return_counts=True)
    # ANY shared id links two points, not just majority-vs-majority: a
    # fragmented point's observations spread over several components, and
    # requiring the TOP component to coincide dropped ~60% of the genuine
    # links (512 study: 721 majority pairs vs 1720 any-shared). Stray
    # single-observation links are the union gate's job to reject (and
    # measured identical pools at >=1 vs >=2 obs: 1720 vs 1706).
    del cnt
    k_pid, k_gid = key // (T + 1), key % (T + 1)
    if len(k_pid) == 0:
        return 0

    # Group (point, gid) rows by gid; fuse each group into its
    # best-observed member (star topology per gid: every accepted pair
    # shares the group root, so one call cannot chain-collapse through
    # unchecked transitive unions; a point shared across gids can bridge
    # two stars — the union gate checked both pairs, and consensus splits
    # repair the rare bad bridge).
    counts_obs = np.bincount(rec.obs_point[val_rows], minlength=len(rec.points))
    og = np.lexsort((counts_obs[k_pid], k_gid))
    g_srt, p_srt = k_gid[og], k_pid[og]
    new_grp = np.r_[True, g_srt[1:] != g_srt[:-1]]
    grp_id = np.cumsum(new_grp) - 1
    # Root = last member of each group in (gid, obs-count) order.
    grp_last = np.r_[new_grp[1:], True]
    roots = np.zeros(grp_id[-1] + 1, np.int64)
    roots[grp_id[grp_last]] = p_srt[grp_last]
    member = ~grp_last
    if not member.any():
        return 0
    pb = p_srt[member]
    pa = roots[grp_id[member]]
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]
    if len(pa) == 0:
        return 0
    # One gate evaluation per distinct pair (the same pair can arrive via
    # several shared components).
    pk = np.unique((np.minimum(pa, pb) << 32) | np.maximum(pa, pb))
    pa, pb = pk >> 32, pk & 0xFFFFFFFF
    if exclude:
        # (parent, fragment) pairs a consensus split created: the fragment
        # inherits the parent's global id, so id identity alone must not
        # re-glue what geometry just separated.
        pk = (np.minimum(pa, pb) << 32) | np.maximum(pa, pb)
        keep = ~np.isin(pk, np.fromiter(exclude, np.int64, len(exclude)))
        pa, pb = pa[keep], pb[keep]
        if len(pa) == 0:
            return 0

    acc, worst = _union_reproj_gate(rec, pa, pb, rel_factor, floor_px,
                                    max_px, gate_obs_cap)
    if len(acc) == 0:
        return 0
    n = _apply_point_merges(rec, pa[acc], pb[acc])
    if verbose and n:
        print(f"[sfm_tpu_torch] track-id merge: absorbed {n} duplicate points "
              f"({len(pa)} id-linked pairs, {len(acc)} passed the union-"
              f"reprojection gate [{rel_factor:.1f}x fit, floor "
              f"{floor_px:.1f}px, cap {max_px:.1f}px])")
    return n


def merge_tracks_by_proximity(
    rec: Reconstruction, max_px: float = 6.0, knn: int = 8,
    radius_frac: float = 0.35, gate_obs_cap: int = 64, verbose: bool = False,
    rel_factor: float = 2.0, floor_px: float = 1.0,
) -> int:
    """Fuse duplicated tracks by 3D proximity + union-reprojection fitness
    (COLMAP retriangulation/MergeTracks analog, SURVEY.md §2.5/§2.7).

    Divide-and-conquer over a sequentially-matched capture leaves every
    physical point as one copy PER CLUSTER ARC: the match graph has no
    long-range edges, so correspondence votes cannot fuse copies whose
    observing images were never matched (the 10k ladder's bend postmortem —
    6301 points for ~450 physical blobs, zero tracks spanning >2 arcs, and a
    global BA that cannot see the low-frequency bend because no constraint
    spans it). Geometry can: two copies of one physical point sit close in
    3D (adjacent-arc copies: median 2-7% of scene scale) and a single
    position reprojects acceptably into BOTH tracks' observations, while two
    genuinely distinct points at similar 3D separation reproject tens of px
    off at SfM camera/focal geometry.

    Per call: for each valid point, its knn nearest valid neighbors within
    radius_frac * (RMS scene scale) become candidate pairs; a pair is
    accepted when the observation-weighted merged position reprojects into
    EACH track separately (per-side gate: a long healthy track must not
    vote down its own absorption of a short bad one) with mean error within
    the quality-preservation gate min(max_px, max(rel_factor x the tracks'
    current worst per-side fit, floor_px)) — see the inline rationale;
    accepted pairs are greedily matched (each point merges at most once per
    call, best-fit first) so one call never chain-collapses a whole
    neighborhood through an unchecked transitive union. Interleave calls
    with global BA (`partition._polish_phase` refine rounds): each merge
    adds long-range rigidity, the next BA straightens the model, which
    brings farther copies under the gate — the loop converges when no pair
    passes. Host numpy throughout (candidate generation is a KD-tree query;
    the gate is O(pairs * gate_obs_cap) projections).
    """
    from scipy.spatial import cKDTree

    pv = rec.point_valid
    ids = np.where(pv)[0]
    if len(ids) < 2:
        return 0
    pts = rec.points[ids]
    centroid = pts.mean(0)
    scale = float(np.sqrt(((pts - centroid) ** 2).sum(-1).mean()))
    radius = radius_frac * max(scale, 1e-9)

    tree = cKDTree(pts)
    k = min(knn + 1, len(ids))
    dist, nbr = tree.query(pts, k=k, distance_upper_bound=radius)
    # Drop self-matches and out-of-radius fills; canonicalize (a < b).
    src = np.repeat(np.arange(len(ids)), k - 1)
    dst = nbr[:, 1:].ravel()
    dd = dist[:, 1:].ravel()
    ok = np.isfinite(dd) & (dst < len(ids))
    a_loc = np.minimum(src[ok], dst[ok])
    b_loc = np.maximum(src[ok], dst[ok])
    pair_key = np.unique(a_loc.astype(np.int64) << 32 | b_loc.astype(np.int64))
    if len(pair_key) == 0:
        return 0
    pa = ids[(pair_key >> 32).astype(np.int64)]
    pb = ids[(pair_key & 0xFFFFFFFF).astype(np.int64)]

    acc, worst = _union_reproj_gate(rec, pa, pb, rel_factor, floor_px,
                                    max_px, gate_obs_cap)
    if len(acc) == 0:
        return 0

    # Greedy best-fit matching: each point participates in at most one merge
    # per call (transitive unions within a call would be unchecked).
    used = np.zeros(len(rec.points), bool)
    sel_a, sel_b = [], []
    for i in acc[np.argsort(worst[acc])]:
        x, y = int(pa[i]), int(pb[i])
        if used[x] or used[y]:
            continue
        used[x] = used[y] = True
        sel_a.append(x)
        sel_b.append(y)
    if not sel_a:
        return 0
    n = _apply_point_merges(rec, np.asarray(sel_a), np.asarray(sel_b))
    if verbose and n:
        print(f"[sfm_tpu_torch] proximity track merge: fused {n} duplicate points "
              f"({len(pair_key)} candidates, {len(acc)} passed the "
              f"quality-preserving union-reprojection gate "
              f"[{rel_factor:.1f}x current fit, floor {floor_px:.1f}px, "
              f"cap {max_px:.1f}px])")
    return n


def split_tracks_by_consensus(
    rec: Reconstruction, max_px: float = 4.0, min_keep: int = 2,
    verbose: bool = False, split_log: list | None = None,
) -> int:
    """Break CONTAMINATED tracks by geometric consensus at the current poses
    (the round-4 consolidation study's binding constraint: on the 512-orbit
    blob scene ~54% of union-find tracks glue temporally disjoint fragments
    of DIFFERENT physical points — zero conflict evidence exists at union
    time, so only geometry can see it; NOTES.md round-4).

    For every valid track, observations whose reprojection error at the
    CURRENT point exceeds max_px (or whose depth is non-positive) are
    DETACHED — but not dropped: each track's detached set becomes a fresh
    candidate point (appended to the point table) when it has >= 2 rows, so
    a glued pair of fragments separates into two tracks instead of losing
    the minority fragment. The follow-up retriangulate places the new
    points (and rejects them if the detached set is itself inconsistent —
    a multi-fragment glue unwinds over successive consolidation rounds).
    Tracks whose consensus core would fall below min_keep rows are left
    intact (retriangulation owns their fate). Mutates rec; returns the
    number of detached observations.
    """
    pv = rec.point_valid
    if rec.obs_point is None or not pv.any():
        return 0
    err, depth = rec.reprojection_errors_depths()
    valid_rows = pv[rec.obs_point]
    bad = valid_rows & ((err > max_px) | (depth <= 0))
    if not bad.any():
        return 0
    # Core size per track (rows that stay); only split where the core keeps
    # min_keep rows AND at least one row detaches.
    P0 = len(rec.points)
    good_cnt = np.bincount(rec.obs_point[valid_rows & ~bad], minlength=P0)
    split_ok = good_cnt[rec.obs_point] >= min_keep
    detach = bad & split_ok
    if not detach.any():
        return 0

    # One new point per affected old track; detached rows remap to it.
    old_pid = rec.obs_point[detach]
    affected = np.unique(old_pid)
    new_of_old = -np.ones(P0, np.int64)
    new_of_old[affected] = P0 + np.arange(len(affected))
    n_new = len(affected)

    rec.points = np.concatenate([rec.points, rec.points[affected]], axis=0)
    rec.point_errors = np.concatenate(
        [rec.point_errors, np.zeros(n_new, rec.point_errors.dtype)])
    # New candidates start valid only if they can triangulate (>= 2 rows);
    # singletons park at an INVALID new point, preserving the row for a
    # future correspondence-vote fuse instead of deleting the evidence.
    det_cnt = np.bincount(old_pid, minlength=P0)
    can_tri = det_cnt[affected] >= 2
    rec.point_valid = np.concatenate([rec.point_valid, can_tri])

    rec.obs_point = rec.obs_point.copy()
    rec.obs_point[detach] = new_of_old[old_pid].astype(np.int32)
    if split_log is not None:
        # (parent, fragment) pairs — callers exclude them from id-based
        # re-fusion (the fragment's observations still carry the parent's
        # global track id; re-fusing would undo the geometric evidence).
        split_log.append((affected.copy(), P0 + np.arange(len(affected))))
    n_det = int(detach.sum())
    if verbose:
        print(f"[sfm_tpu_torch] track split: detached {n_det} obs from "
              f"{len(affected)} contaminated tracks "
              f"({int(can_tri.sum())} new candidate points)")
    return n_det


def merge_reconstructions(recs: list[Reconstruction], cfg: PipelineConfig) -> Reconstruction:
    """Sim3-synchronize all clusters into the anchor frame (loop closure),
    then fuse. Clusters disconnected from the anchor component are dropped
    with a warning; 2-cluster merges skip the synchronization (the pairwise
    alignment IS the global solution there)."""
    recs = sorted(recs, key=lambda r: -r.num_registered)
    if len(recs) == 1:
        return recs[0]
    if len(recs) == 2:
        try:
            return merge_two(recs[0], recs[1], verbose=cfg.verbose)
        except ValueError:
            if cfg.verbose:
                print("[sfm_tpu_torch] 1 cluster(s) could not be aligned (no shared cameras)")
            return recs[0]

    transforms = synchronize_sim3(recs, verbose=cfg.verbose)
    merged = None
    dropped = 0
    for rec, tr in zip(recs, transforms):
        if tr is None:
            dropped += 1
            continue
        s, R, t = tr
        placed = apply_sim3_to_reconstruction(rec, s, R, t)
        merged = placed if merged is None else merge_two(merged, placed, align=False)
    if dropped and cfg.verbose:
        print(f"[sfm_tpu_torch] {dropped} cluster(s) could not be aligned (no shared cameras)")
    return merged
