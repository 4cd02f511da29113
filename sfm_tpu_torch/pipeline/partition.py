"""Divide-and-conquer reconstruction (port of sfm_tpu/pipeline/partition.py;
SURVEY.md §2.7) — the IIT-Delhi-lineage large-scale strategy: partition the
image match graph into overlapping clusters, reconstruct each independently,
merge with a similarity transform, finish with a merged global BA.

The graph is tiny (<=10^4 nodes), so partitioning is host-side greedy BFS
growth by edge weight; per-cluster reconstructions are independent work
units; the merge bookkeeping is numpy on the host and the per-cluster
engines, the PnP rescue, re-triangulation and every BA run on `device`.

Divergences from the JAX package:
- the merged polish has no survival path: the JAX package wraps its solve in
  try/except, retries and falls back to camera windows because of remote
  compile failures; here a kernel that fails to build or launch raises, and
  the windowed sweep runs only above _POLISH_MAX_CAMERAS cameras;
- a cluster that cannot reconstruct is skipped on the engines' own
  ReconstructionError only, so that no CUDA or build error is swallowed;
- the capacities threaded between polishes (which kept one compiled program
  alive) are kept only because they fix the problem's padded shapes, as in
  the JAX package;
- the rescue's PnP minimal sets come from ops/ransac.draw_minimal_sets keyed
  by (seed + 77, attempt, "pnp"), as the engine's do;
- the phases' wall seconds land on Reconstruction.stage_seconds as
  partition.* keys (clusters, merge, rescue, polish).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
from sfm_tpu_torch.scene.state import Reconstruction, ReconstructionError
from sfm_tpu_torch.utils.logging import StageTimer


def partition_images(graph: MatchGraph, num_images: int, target_size: int, overlap: int) -> list[np.ndarray]:
    """Greedy weighted BFS partitioning with boundary-camera overlap.

    Seeds each cluster at the strongest unassigned image and grows by maximum
    connectivity-to-cluster (edge weight = verified inlier count), then adds
    the `overlap` most-connected outside images so neighbouring clusters
    share cameras for the merge alignment.
    """
    # Sparse adjacency (CSR): a dense [B, B] matrix plus per-step row slicing
    # is O(B^2) memory / O(B^3)-ish host time at Rome16K scale.
    # Connectivity-to-cluster is maintained incrementally: adding member m
    # costs one sparse row add.
    from scipy.sparse import csr_matrix

    ok_e = np.where(graph.ok)[0]
    i_arr = graph.pairs[ok_e, 0].astype(np.int64)
    j_arr = graph.pairs[ok_e, 1].astype(np.int64)
    w_arr = graph.num_inliers[ok_e].astype(np.float64)
    W = csr_matrix(
        (np.concatenate([w_arr, w_arr]),
         (np.concatenate([i_arr, j_arr]), np.concatenate([j_arr, i_arr]))),
        shape=(num_images, num_images),
    )
    degree = np.asarray(W.sum(axis=1)).reshape(-1)

    def row(m: int) -> np.ndarray:
        out = np.zeros(num_images)
        s, e = W.indptr[m], W.indptr[m + 1]
        out[W.indices[s:e]] = W.data[s:e]
        return out

    assigned = np.zeros(num_images, bool)
    clusters = []
    while not assigned.all():
        remaining = np.where(~assigned)[0]
        if degree[remaining].max() == 0:
            # Isolated images: one throwaway cluster each (they cannot register).
            assigned[remaining] = True
            break
        seed = int(remaining[np.argmax(degree[remaining])])
        members = [seed]
        assigned[seed] = True
        conn = row(seed)                       # connectivity of ALL images to cluster
        while len(members) < target_size and not assigned.all():
            cand = np.where(conn > 0, ~assigned, False)
            masked = np.where(cand, conn, 0.0)
            nxt = int(np.argmax(masked))
            if masked[nxt] == 0:
                break
            members.append(nxt)
            assigned[nxt] = True
            conn += row(nxt)
        core = np.asarray(members)
        # Overlap: strongest outside connections (may already be in another cluster).
        if overlap > 0:
            conn_out = conn.copy()
            conn_out[core] = 0.0
            extra = np.argsort(-conn_out)[:overlap]
            extra = extra[conn_out[extra] > 0]
            cluster = np.concatenate([core, extra])
        else:
            cluster = core
        clusters.append(np.sort(cluster.astype(np.int64)))
    return clusters


def _mask_graph_to_cluster(graph: MatchGraph, cluster: np.ndarray) -> MatchGraph:
    inside = np.zeros(int(graph.pairs.max()) + 1 if len(graph.pairs) else 1, bool)
    inside[cluster] = True
    ok = graph.ok & inside[graph.pairs[:, 0]] & inside[graph.pairs[:, 1]]
    return MatchGraph(
        pairs=graph.pairs, idx_i=graph.idx_i, idx_j=graph.idx_j, inlier=graph.inlier,
        num_inliers=graph.num_inliers, num_h_inliers=graph.num_h_inliers,
        rvec=graph.rvec, tvec=graph.tvec, ok=ok, pose_ok=graph.pose_ok,
    )


def partitioned_reconstruct(
    feats: FeatureSet, graph: MatchGraph, intrinsics: np.ndarray, cfg: PipelineConfig,
    device: torch.device | str, store=None, key: str | None = None,
) -> Reconstruction:
    """Cluster -> reconstruct -> merge -> global BA (config ladder #5), device
    steps on `device`. The result's stage_seconds holds the phases' wall
    seconds under partition.* keys.

    store/key: optional ArtifactStore checkpoint slots. The cluster
    reconstructions are saved as stage 'clusters', and the merged and
    rescued model as 'merged_prepolish' before the polish, so a rerun with
    the same key resumes past the clusters, or straight into the polish.
    """
    from sfm_tpu_torch.pipeline.engine import incremental_reconstruct
    from sfm_tpu_torch.pipeline.merge import merge_reconstructions

    device = torch.device(device)
    timer = StageTimer(verbose=False, device=device)
    checkpoints = store is not None and key is not None
    if checkpoints and store.is_complete("merged_prepolish", key):
        merged = store.load_reconstruction(stage="merged_prepolish")
        if cfg.verbose:
            print("[sfm_tpu_torch] resuming from merged_prepolish artifact "
                  f"({merged.num_registered} cams, {merged.num_points} pts)")
        with timer.stage("partition.polish"):
            _polish_phase(merged, feats, graph, intrinsics, cfg, device)
        merged.stage_seconds = dict(timer.durations)
        return merged

    B = len(feats.xy)
    clusters = partition_images(
        graph, B, cfg.partition.target_cluster_size, cfg.partition.overlap_cameras
    )
    if cfg.verbose:
        print(f"[sfm_tpu_torch] partitioned {B} images into {len(clusters)} clusters: "
              f"{[len(c) for c in clusters]}")

    def run_cluster(ci_cluster):
        ci, cluster = ci_cluster
        if len(cluster) < 2:
            return None
        sub = _mask_graph_to_cluster(graph, cluster)
        if not sub.ok.any():
            return None
        try:
            if cfg.engine_mode == "global":
                # Per-cluster global SfM (the reference-lineage shape:
                # divide-and-conquer with averaging-based solves inside each
                # cluster). At cluster size the pose graph's diameter is a
                # few hops, where rotation/position averaging is accurate;
                # the cross-cluster merge + polish path below is shared with
                # the incremental mode.
                from sfm_tpu_torch.pipeline.global_engine import global_reconstruct

                rec = global_reconstruct(feats, sub, intrinsics, cfg, device)
            else:
                rec = incremental_reconstruct(feats, sub, intrinsics, cfg, device)
        except ReconstructionError as e:
            if cfg.verbose:
                print(f"[sfm_tpu_torch] cluster {ci} failed: {e}")
            return None
        # A cluster is only usable if it actually built a map: a 2-camera /
        # 0-point result can neither be aligned nor contribute structure.
        return rec if rec.num_registered >= 2 and rec.num_points >= 8 else None

    # Clusters are independent work units. parallel_clusters > 1 overlaps
    # their host-side bookkeeping with device work via threads.
    workers = max(1, cfg.partition.parallel_clusters)
    work = list(enumerate(clusters))
    with timer.stage("partition.clusters"):
        if checkpoints and store.is_complete("clusters", key):
            recs = _load_cluster_recs(store)
            if cfg.verbose:
                print(f"[sfm_tpu_torch] resuming from {len(recs)} cluster artifacts")
        else:
            if workers > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(max_workers=workers) as ex:
                    recs = [r for r in ex.map(run_cluster, work) if r is not None]
            else:
                recs = [r for r in map(run_cluster, work) if r is not None]
            if checkpoints and recs:
                _save_cluster_recs(store, key, recs)
    if not recs:
        raise ReconstructionError("no cluster produced a reconstruction")

    if cfg.engine_mode == "global" and len(recs) >= 4:
        # Cluster-quality gate: a per-cluster global solve can land in a
        # collapsed-but-self-consistent basin (low reprojection error, but
        # the structure imploded). Its signature is a starved point table —
        # on the 512-orbit ladder the three bad clusters measured 5-13
        # points/camera vs 25-37 for their 17 healthy siblings (23-27% vs
        # <=5% center error vs GT). Dropping them is safe: their images
        # re-register through the post-merge PnP rescue against the merged
        # model, exactly like incremental stragglers.
        ppc = np.asarray([r.point_valid.sum() / max(r.num_registered, 1)
                          for r in recs])
        gate = 0.4 * float(np.median(ppc))
        bad = ppc < gate
        if bad.any() and (~bad).sum() >= max(2, len(recs) // 2):
            if cfg.verbose:
                print(f"[sfm_tpu_torch] cluster gate: dropping {int(bad.sum())} "
                      f"collapsed cluster(s) (pts/cam {ppc[bad].round(1)} "
                      f"< {gate:.1f}); their images go to the rescue pass")
            recs = [r for r, b in zip(recs, bad) if not b]

    with timer.stage("partition.merge"):
        if cfg.engine_mode == "global":
            # Global-mode merge: register every cluster into the full-graph
            # pose-averaged frame instead of chaining pairwise overlap sim3s.
            # Per-cluster global solves register fewer seam cameras than the
            # incremental march, so the cluster-overlap graph can fall apart.
            # The scale-synced pose graph is globally stiff, covers every
            # camera, and needs no overlap at all.
            merged = _merge_via_pose_graph(recs, feats, graph, intrinsics, cfg, device)
            if merged is None:
                merged = merge_reconstructions(recs, cfg)
        else:
            merged = merge_reconstructions(recs, cfg)

        # Cross-cluster track consolidation (COLMAP merge-tracks analog): the
        # per-cluster engines never see cross-cluster match edges, so one
        # physical track surfaces as several merged points. Fusing them both
        # shrinks the point table AND adds long-range rigidity — merged tracks
        # tie cameras in distant clusters together, which is exactly the
        # constraint the global polish needs to remove low-frequency
        # deformation.
        if cfg.partition.merge_tracks_min_votes > 0:
            from sfm_tpu_torch.pipeline.merge import merge_tracks_by_correspondence
            merge_tracks_by_correspondence(
                merged, graph, min_votes=cfg.partition.merge_tracks_min_votes,
                dist_frac=cfg.partition.merge_tracks_dist_frac, verbose=cfg.verbose,
            )

    # Post-merge rescue: images that failed PnP inside their (partial-map)
    # cluster often succeed against the MERGED global model — its tracks
    # span every cluster. Rescue BEFORE the polish so the global BA also
    # optimizes the recovered cameras, then once more after (the polished
    # map is more accurate).
    with timer.stage("partition.rescue"):
        _rescue_unregistered(merged, feats, graph, intrinsics, cfg, device)
    if checkpoints:
        store.save_reconstruction(key, merged, stage="merged_prepolish")

    with timer.stage("partition.polish"):
        _polish_phase(merged, feats, graph, intrinsics, cfg, device)
    merged.stage_seconds = dict(timer.durations)
    return merged


_REC_FIELDS = ("intrinsics", "rvecs", "tvecs", "registered", "points",
               "point_errors", "point_valid", "obs_point", "obs_image",
               "obs_kp", "obs_uv")


def _save_cluster_recs(store, key: str, recs) -> None:
    """The cluster reconstructions as one stage artifact ('clusters'), in
    sfm_tpu's layout: the cluster phase dominates at scale while merge and
    polish run in minutes, so merge-logic iteration resumes here."""
    arrays = {"n": np.asarray(len(recs))}
    for ci, r in enumerate(recs):
        for f in _REC_FIELDS:
            arrays[f"c{ci}_{f}"] = getattr(r, f)
    store.save("clusters", key, arrays)


def _load_cluster_recs(store):
    data = store.load("clusters")
    n = int(data["n"])
    return [Reconstruction(**{f: data[f"c{ci}_{f}"] for f in _REC_FIELDS}) for ci in range(n)]


def _merge_via_pose_graph(recs, feats, graph, intrinsics, cfg, device):
    """Place every cluster model into the full-graph pose-averaged frame.

    One pose_graph_poses solve (rotation averaging + edge-scale-synced
    centers) over the WHOLE match graph, then a trimmed per-cluster sim3
    fit of each cluster's registered camera centers onto the pose-graph
    centers. No cluster-overlap requirement, no chaining, no drift
    accumulation; a cluster whose fit residual stays large relative to its
    spread is dropped (collapsed basin) and its images go to the rescue
    pass. Returns None when the pose graph covers too little of the scene
    (callers fall back to the overlap sim3 sync).
    """
    from sfm_tpu_torch.geometry.similarity import umeyama_np
    from sfm_tpu_torch.pipeline.global_pose import _so3_exp_np, pose_graph_poses
    from sfm_tpu_torch.pipeline.merge import (apply_sim3_to_reconstruction,
                                        merge_two)

    B = len(intrinsics)
    rvecs_pg, tvecs_pg, valid = pose_graph_poses(graph, B, feats=feats,
                                                 intrinsics=intrinsics, device=device)
    if valid.sum() < 0.5 * max(r.num_registered for r in recs):
        return None
    Rpg = _so3_exp_np(rvecs_pg.astype(np.float64))
    c_pg = -np.einsum("nji,nj->ni", Rpg, tvecs_pg.astype(np.float64))

    merged = None
    dropped = 0
    for ci, rec in enumerate(recs):
        both = rec.registered & valid
        ids = np.where(both)[0]
        if len(ids) < 3:
            dropped += 1
            continue
        Rc = _so3_exp_np(rec.rvecs[ids].astype(np.float64))
        c_cl = -np.einsum("nji,nj->ni", Rc, rec.tvecs[ids].astype(np.float64))
        dst = c_pg[ids]
        s, Rw, t = umeyama_np(c_cl, dst)
        for _ in range(2):  # trimmed refit
            fit = s * c_cl @ np.asarray(Rw).T + np.asarray(t)
            err = np.linalg.norm(fit - dst, axis=1)
            keep = err <= np.quantile(err, 0.75)
            if keep.sum() < 3:
                break
            s, Rw, t = umeyama_np(c_cl[keep], dst[keep])
        fit = s * c_cl @ np.asarray(Rw).T + np.asarray(t)
        err = np.linalg.norm(fit - dst, axis=1)
        spread = float(np.linalg.norm(dst - dst.mean(0), axis=1).mean()) + 1e-12
        rel = float(np.sqrt((err ** 2).mean()) / spread)
        if rel > 0.35:
            # The cluster's internal shape disagrees with the pose graph —
            # a collapsed or folded basin that no rigid+scale fit explains.
            if cfg.verbose:
                print(f"[sfm_tpu_torch] pose-graph merge: cluster {ci} dropped "
                      f"(fit rel_rms {rel:.2f})")
            dropped += 1
            continue
        placed = apply_sim3_to_reconstruction(rec, float(s), np.asarray(Rw),
                                              np.asarray(t))
        merged = placed if merged is None else merge_two(merged, placed,
                                                         align=False)
        if cfg.verbose:
            print(f"[sfm_tpu_torch] pose-graph merge: cluster {ci} placed "
                  f"({len(ids)} cams, fit rel_rms {rel:.3f})")
    if merged is None:
        return None
    if dropped and cfg.verbose:
        print(f"[sfm_tpu_torch] pose-graph merge: {dropped} cluster(s) dropped")
    return merged


def _polish_phase(
    merged: Reconstruction, feats: FeatureSet, graph: MatchGraph,
    intrinsics: np.ndarray, cfg: PipelineConfig, device: torch.device,
) -> None:
    """Global polish + second-pass consolidation/rescue on the merged model
    (mutates `merged` in place)."""
    from sfm_tpu_torch.pipeline.merge import (
        merge_tracks_by_correspondence, merge_tracks_by_proximity,
    )

    if cfg.partition.straighten_pose_graph and merged.num_points > 4:
        # Pose-graph straightening (rotation averaging + 1DSfM-class
        # translation averaging over the verified match graph): the merged
        # model's failure mode at 10k is a low-frequency bend along the
        # cluster chain that reprojection cost is FLAT along — but the pose
        # graph's long-range relative-rotation constraints (densified edges)
        # are globally stiff. Replace poses, retriangulate, let the BA
        # below restore local accuracy. Reverts if retriangulation collapses
        # (pose-graph poses inconsistent with the observations).
        from sfm_tpu_torch.pipeline.global_pose import straighten_reconstruction

        snap = (merged.rvecs.copy(), merged.tvecs.copy(),
                merged.points.copy(), merged.point_valid.copy())
        n_valid_before = int(merged.point_valid.sum())
        if straighten_reconstruction(merged, graph, cfg=cfg,
                                     verbose=cfg.verbose, feats=feats, device=device):
            if int(merged.point_valid.sum()) < 0.5 * n_valid_before:
                (merged.rvecs, merged.tvecs,
                 merged.points, merged.point_valid) = snap
                if cfg.verbose:
                    print("[sfm_tpu_torch]   pose-graph straighten reverted "
                          "(retriangulation collapse)")

    if cfg.partition.merge_global_ba and merged.num_points > 4:
        # Capacity threading: every polish in this phase solves the SAME
        # cameras over monotonically shrinking obs/point sets (filters drop,
        # proximity merges fuse), so the first solve's tight capacities are
        # reused across all refine rounds. _merged_polish re-validates fit —
        # the rescue pass APPENDS observations and may outgrow the caps.
        caps = _merged_polish(merged, cfg, device)
        # Second consolidation at a tighter gate on the straightened model:
        # fragments the pre-polish distance gate rejected (cluster-alignment
        # error) are now adjacent; fuse and re-polish.
        n_merged2 = 0
        if cfg.partition.merge_tracks_min_votes > 0:
            n_merged2 = merge_tracks_by_correspondence(
                merged, graph, min_votes=cfg.partition.merge_tracks_min_votes,
                dist_frac=0.4 * cfg.partition.merge_tracks_dist_frac,
                verbose=cfg.verbose,
            )
        n2 = 0
        if not merged.registered.all():
            n2 = _rescue_unregistered(merged, feats, graph, intrinsics, cfg, device)
        if n2 or n_merged2:
            caps = _merged_polish(merged, cfg, device, caps=caps)

        # Iterative global refinement (COLMAP IterativeGlobalRefinement
        # analog): proximity-merge duplicated tracks -> global BA -> repeat.
        # Sequentially-matched captures reconstruct one copy of each
        # physical point PER cluster arc; correspondence votes cannot fuse
        # copies whose images were never matched, so the merged model has no
        # long-range constraints and global BA leaves the low-frequency
        # cluster-chain bend in place (10k postmortem: RMSE 30% of orbit
        # radius at 0.49px mean reprojection). Each round fuses the copies
        # the current geometry can certify (union-reprojection gate at the
        # filter threshold), which adds exactly the long-range rigidity the
        # next BA needs; straightening brings farther copies under the gate.
        # Converges when a round fuses nothing.
        from sfm_tpu_torch.pipeline.global_pose import retriangulate_reconstruction
        from sfm_tpu_torch.pipeline.merge import (
            merge_tracks_by_track_id, split_tracks_by_consensus,
        )

        # Full-graph union-find built once and reused across refine rounds
        # (the transitive-identity evidence is geometry-independent; only
        # the gate's acceptance changes as the model straightens).
        id_gids = None
        no_refuse: set = set()
        if cfg.partition.id_merge:
            from sfm_tpu_torch.pipeline.merge import conflict_tolerant_track_ids
            id_gids = conflict_tolerant_track_ids(graph, feats)

        id_cap = cfg.partition.id_merge_max_px
        for _ in range(cfg.partition.refine_rounds):
            # Split contaminated tracks first (observations breaking
            # geometric consensus detach into new candidate points — the
            # round-4 study's 54%-contamination finding; merges on polluted
            # tracks average unrelated structure). Then correspondence
            # votes (2D evidence: fusing extends track spans, which exposes
            # NEW cross-point votes on the same edges next round —
            # transitive closure over rounds), then geometric proximity for
            # copies whose images were never matched.
            n_fused = 0
            if cfg.engine.split_tracks_px > 0:
                P0 = len(merged.points)
                split_log: list = []
                n_split = split_tracks_by_consensus(
                    merged, max_px=cfg.engine.split_tracks_px,
                    verbose=cfg.verbose, split_log=split_log)
                for par, frag in split_log:
                    lo = np.minimum(par, frag).astype(np.int64)
                    hi = np.maximum(par, frag).astype(np.int64)
                    no_refuse.update(((lo << 32) | hi).tolist())
                if n_split:
                    # Place only the fresh fragments; untouched points keep
                    # their polished positions/validity.
                    retriangulate_reconstruction(
                        merged, cfg=cfg,
                        only_points=np.arange(P0, len(merged.points)), device=device)
                n_fused += n_split
            if id_gids is not None:
                # Transitive identity first: it carries the long-range
                # fusions (cross-cluster copies linked through keypoints no
                # cluster retained) that votes and proximity cannot see.
                n_fused += merge_tracks_by_track_id(
                    merged, graph, len(merged.registered), feats.xy.shape[1],
                    rel_factor=cfg.partition.id_merge_rel_factor,
                    floor_px=cfg.partition.id_merge_floor_px,
                    max_px=id_cap,
                    verbose=cfg.verbose, gid_map=id_gids, exclude=no_refuse,
                )
                id_cap = max(id_cap * cfg.partition.id_merge_anneal,
                             cfg.partition.id_merge_min_px)
            if cfg.partition.merge_tracks_min_votes > 0:
                n_fused += merge_tracks_by_correspondence(
                    merged, graph, min_votes=cfg.partition.merge_tracks_min_votes,
                    dist_frac=cfg.partition.merge_tracks_dist_frac,
                    verbose=cfg.verbose,
                )
            n_fused += merge_tracks_by_proximity(
                merged, max_px=cfg.engine.max_reprojection_error_px,
                verbose=cfg.verbose,
            )
            if n_fused == 0:
                break
            caps = _merged_polish(merged, cfg, device, caps=caps)


def _rescue_unregistered(
    merged: Reconstruction, feats: FeatureSet, graph: MatchGraph,
    intrinsics: np.ndarray, cfg: PipelineConfig, device: torch.device,
) -> int:
    """PnP-register still-unregistered images against the merged model.

    2D-3D correspondences come from the verified match graph: for an
    unregistered image q, every inlier correspondence (kq, kr) to a
    registered image r whose (r, kr) observation belongs to a merged track
    links q's keypoint kq to that track's 3D point. Appends the inlier
    links as observations so the follow-up polish constrains the new
    cameras. Returns the number of images registered."""
    from sfm_tpu_torch.ops import ransac as ransac_ops
    from sfm_tpu_torch.ops.pnp import pnp_ransac
    from sfm_tpu_torch.pipeline.engine import _PNP_CAP, _to_camera

    todo = np.where(~merged.registered)[0]
    if len(todo) == 0:
        return 0

    # (image, kp) -> merged point id lookup over valid-track observations.
    val = merged.point_valid[merged.obs_point]
    kb = (merged.obs_image[val].astype(np.int64) << 32) | merged.obs_kp[val].astype(np.int64)
    pb = merged.obs_point[val]
    order = np.argsort(kb, kind="stable")
    kb_sorted, pb_sorted = kb[order], pb[order]

    def lookup(img_arr, kp_arr):
        ko = (img_arr.astype(np.int64) << 32) | kp_arr.astype(np.int64)
        pos = np.searchsorted(kb_sorted, ko)
        pos_c = np.minimum(pos, max(len(kb_sorted) - 1, 0))
        hit = (len(kb_sorted) > 0) & (kb_sorted[pos_c] == ko)
        return hit, np.where(hit, pb_sorted[pos_c], -1)

    # Candidate links per unregistered image, from graph edges to registered
    # images (inlier correspondences only).
    in_todo = np.zeros(len(merged.registered), bool)
    in_todo[todo] = True
    ei = graph.pairs[:, 0]
    ej = graph.pairs[:, 1]
    use_edge = graph.ok & (
        (in_todo[ei] & merged.registered[ej]) | (in_todo[ej] & merged.registered[ei])
    )
    links: dict[int, list] = {int(q): [] for q in todo}
    for e in np.where(use_edge)[0]:
        i, j = int(ei[e]), int(ej[e])
        inl = graph.inlier[e]
        ki, kj = graph.idx_i[e][inl], graph.idx_j[e][inl]
        if in_todo[i]:
            q, kq, kr, r = i, ki, kj, j
        else:
            q, kq, kr, r = j, kj, ki, i
        hit, pid = lookup(np.full(len(kr), r), kr)
        if hit.any():
            links[q].append((kq[hit], pid[hit]))

    rescued = []
    attempt = 0
    new_op, new_oi, new_ok_, new_uv = [], [], [], []
    for q in todo:
        if not links[int(q)]:
            continue
        kq = np.concatenate([a for a, _ in links[int(q)]])
        pid = np.concatenate([b for _, b in links[int(q)]])
        # One link per keypoint (a kp matched into several registered images
        # votes once), majority point on conflicts via first-seen.
        _, first = np.unique(kq, return_index=True)
        kq, pid = kq[first], pid[first]
        if len(kq) < cfg.engine.abs_pose_min_inliers:
            continue
        kq, pid = kq[:_PNP_CAP], pid[:_PNP_CAP]

        X = np.zeros((_PNP_CAP, 3), np.float32)
        uv = np.zeros((_PNP_CAP, 2), np.float32)
        mask = np.zeros(_PNP_CAP, bool)
        X[: len(kq)] = merged.points[pid]
        uv_pix = feats.xy[q, kq]
        uv[: len(kq)] = _to_camera(uv_pix, np.broadcast_to(intrinsics[q], (len(kq), 6)), device)
        mask[: len(kq)] = True
        f = (intrinsics[q, 0] + intrinsics[q, 1]) * 0.5
        thr = float((cfg.engine.abs_pose_error_px / f) ** 2)
        attempt += 1
        mask_t = torch.from_numpy(mask).to(device)
        idx = ransac_ops.draw_minimal_sets(cfg.seed + 77, attempt, mask_t,
                                           cfg.ransac.num_hypotheses, 8, "pnp")
        pose, inl, _n, ok = pnp_ransac(
            idx, torch.from_numpy(X).to(device), torch.from_numpy(uv).to(device), mask_t,
            threshold_sq=thr, min_inliers=cfg.engine.abs_pose_min_inliers,
        )
        if not bool(ok):
            continue
        pose = pose.cpu().numpy()
        merged.rvecs[q] = pose[:3]
        merged.tvecs[q] = pose[3:]
        merged.registered[q] = True
        inl_h = inl.cpu().numpy()[: len(kq)]
        new_op.append(pid[inl_h])
        new_oi.append(np.full(int(inl_h.sum()), q, np.int32))
        new_ok_.append(kq[inl_h])
        new_uv.append(uv_pix[inl_h])
        rescued.append(int(q))

    if rescued:
        merged.obs_point = np.concatenate([merged.obs_point, *new_op]).astype(np.int32)
        merged.obs_image = np.concatenate([merged.obs_image, *new_oi]).astype(np.int32)
        merged.obs_kp = np.concatenate([merged.obs_kp, *new_ok_]).astype(np.int32)
        merged.obs_uv = np.concatenate([merged.obs_uv, *new_uv]).astype(np.float32)
        if cfg.verbose:
            print(f"[sfm_tpu_torch] post-merge rescue: registered {len(rescued)} of "
                  f"{len(todo)} leftover images")
    return len(rescued)


# Single-problem polish ceiling (the JAX package's): up to this many cameras
# the merged model is polished by ONE global BA (block Gauss-Seidel windows
# cannot remove low-frequency deformation); above it, by the windowed sweep.
_POLISH_MAX_CAMERAS = 16384
_WINDOW_CAMERAS = 2048


def _merged_polish(
    merged: Reconstruction, cfg: PipelineConfig, device: torch.device | str,
    caps: tuple[int, int] | None = None,
) -> tuple[int, int] | None:
    """BA -> filter -> BA on the merged model (the engine's final-polish
    schedule): sim3-chained clusters carry alignment drift and a few
    wrongly-linked cross-cluster tracks; one robust solve leaves those as
    gross outliers, so filter and re-solve.

    caps: (obs_capacity, point_capacity) from a previous polish of the same
    model, reused while the model fits them; ignored (rebuilt tight) when
    the model has outgrown them. Returns the capacities used on the global
    path, or None when the windowed sweep ran (more than _POLISH_MAX_CAMERAS
    registered cameras)."""
    import dataclasses

    from sfm_tpu_torch.ba import build_problem, dispatch_bundle_adjust, writeback
    from sfm_tpu_torch.scene.state import filter_observations

    if cfg.partition.polish_ba_iterations > 0:
        cfg = dataclasses.replace(
            cfg, ba=dataclasses.replace(cfg.ba, max_iterations=cfg.partition.polish_ba_iterations)
        )

    if merged.num_registered <= _POLISH_MAX_CAMERAS:
        # Pre-solve sanitation: wrongly-linked cross-cluster tracks leave a
        # few thousand 1e3..1e4-px observations whose Jacobians (f/z scale)
        # push normal-equation blocks toward fp32 overflow and whose huber
        # weights still dominate the gradient. Anything past this loose gate
        # is garbage by any standard; the BA->filter->BA loop below handles
        # the marginal cases at the real threshold.
        pre = filter_observations(
            merged, max(32.0, 4.0 * cfg.engine.max_reprojection_error_px)
        )
        if cfg.verbose and pre:
            print(f"[sfm_tpu_torch] pre-polish sanitation: dropped {pre} gross-outlier obs")
        if caps is not None:
            # Caller-supplied caps fit only while the model shrinks; the
            # rescue pass appends observations (and can revive points), so
            # re-validate against build_problem's selection exactly.
            sel = merged.point_valid[merged.obs_point] & merged.registered[merged.obs_image]
            if int(sel.sum()) > caps[0] or int(np.unique(merged.obs_point[sel]).size) > caps[1]:
                caps = None
        for round_ in range(2):
            # tight=True: the polish is a one-shot solve, so fine-grained
            # capacities beat geometric buckets (C=9998 would otherwise pad
            # to 16384 — every camera-axis op 64% dead weight). Round 2
            # reuses round 1's capacities (the filter only DROPS
            # observations, so they always fit).
            prob, cams, pids = build_problem(
                merged, tight=True,
                obs_capacity=caps[0] if caps else None,
                point_capacity=caps[1] if caps else None,
                device=device,
            )
            caps = (prob.obs_w.shape[0], prob.num_points)
            if cfg.verbose:
                print(f"[sfm_tpu_torch] merged global BA: C={prob.num_cameras} "
                      f"P={prob.num_points} O={prob.obs_w.shape[0]} "
                      f"align={prob.point_align}", flush=True)
            out, _ = dispatch_bundle_adjust(prob, cfg)
            writeback(merged, out, cams, pids)
            dropped = filter_observations(merged, cfg.engine.max_reprojection_error_px)
            if cfg.verbose and dropped:
                print(f"[sfm_tpu_torch] merge polish {round_}: dropped {dropped} outlier obs")
            if dropped == 0:
                break
        return caps

    # Windowed polish: 50%-overlapping windows of registered cameras; cameras
    # already polished this sweep are held fixed in later windows so the
    # solution stitches instead of re-gauging. Window order is image-id
    # order, which follows capture/cluster locality for sequential datasets;
    # two sweeps propagate corrections both ways around loops.
    for sweep in range(2):
        reg = np.where(merged.registered)[0]
        polished = np.zeros(len(merged.registered), bool)
        step = _WINDOW_CAMERAS // 2
        for s in range(0, len(reg), step):
            window = reg[s: s + _WINDOW_CAMERAS]
            if len(window) < 16:
                continue
            anchored = polished[window]
            free = window[~anchored] if anchored.any() else None
            if free is not None and len(free) == 0:
                continue
            prob, cams, pids = build_problem(merged, cam_indices=window, free_cams=free,
                                             device=device)
            out, _ = dispatch_bundle_adjust(prob, cfg)
            writeback(merged, out, cams, pids)
            polished[window] = True
        dropped = filter_observations(merged, cfg.engine.max_reprojection_error_px)
        if cfg.verbose:
            print(f"[sfm_tpu_torch] windowed merge polish sweep {sweep}: "
                  f"{(len(reg) + step - 1) // step} windows, dropped {dropped} outlier obs")
    return None
