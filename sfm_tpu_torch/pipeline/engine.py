"""Incremental reconstruction engine (port of sfm_tpu/pipeline/engine.py).

Host-driven outer loop (register -> triangulate -> local BA -> periodic
global BA is data-dependent by nature), device inner steps on `device`
(PnP RANSAC, masked-DLT triangulation, Schur-LM bundle adjustment, pixel
normalisation). Host bookkeeping is numpy, as in the JAX package.

Divergences from the JAX package:
- no jit bucketing: pixel normalisation runs eagerly on the device on the
  exact arrays, and triangulation takes the exact candidate count (padding
  there only fixed jit shapes; the results are the same);
- PnP minimal sets come from ops/ransac.draw_minimal_sets keyed by
  (seed + 1, registration attempt, "pnp"): every attempt, a retry of the
  same image included, gets fresh draws, as jax.random.split gives them;
- the per-phase wall seconds (pnp, triangulate, local_ba, global_ba,
  filter) land on Reconstruction.stage_seconds as engine.* keys, always,
  instead of behind the SFM_TPU_ENGINE_PROFILE environment switch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sfm_tpu_torch.ba import build_problem, dispatch_bundle_adjust, writeback
from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.geometry.cameras import pixel_to_camera
from sfm_tpu_torch.geometry.rotations import matrix_to_aa, so3_exp
from sfm_tpu_torch.ops import ransac as ransac_ops
from sfm_tpu_torch.ops import solvers
from sfm_tpu_torch.ops.pnp import pnp_ransac
from sfm_tpu_torch.ops.triangulate import triangulate_tracks
from sfm_tpu_torch.pipeline.stages import FeatureSet, MatchGraph
from sfm_tpu_torch.scene.state import Reconstruction, ReconstructionError
from sfm_tpu_torch.scene.tracks import TrackSet, build_tracks
from sfm_tpu_torch.utils.logging import StageTimer

_PNP_CAP = 2048      # 2D-3D correspondence budget per registration (and the
                     # length of the mask the PnP draws are taken over)
_MIN_PNP_FLOOR = 6   # stall-rescue floor: EPnP needs >=6 links
_TRI_VIEW_CAP = 8    # observations used per track triangulation
_PARALLAX_CHUNK = 4096


def _to_camera(uv_pix: np.ndarray, intr: np.ndarray, device: torch.device) -> np.ndarray:
    """Pixel -> normalized camera coords on the device, back to the host."""
    uv = torch.from_numpy(np.ascontiguousarray(uv_pix, np.float32)).to(device)
    it = torch.from_numpy(np.ascontiguousarray(intr, np.float32)).to(device)
    return pixel_to_camera(uv, it).cpu().numpy()


@dataclass
class EngineState:
    """Mutable host-side scene bookkeeping during incremental SfM. Points
    live in preallocated arrays (amortized doubling)."""

    feats: FeatureSet
    tracks: TrackSet
    intrinsics: np.ndarray           # [B, 6]
    rvecs: np.ndarray                # [B, 3]
    tvecs: np.ndarray                # [B, 3]
    registered: np.ndarray           # [B] bool
    failed: np.ndarray               # [B] bool (PnP failed; retry later)
    track_point: np.ndarray          # [T] int32 point id or -1
    points: np.ndarray = None        # [cap, 3] preallocated
    point_valid: np.ndarray = None   # [cap] bool
    num_points: int = 0
    obs_alive: np.ndarray = None     # [O] per track-observation row

    def ensure_point_capacity(self, n: int) -> None:
        cap = len(self.points)
        if n <= cap:
            return
        while cap < n:
            cap *= 2
        pts = np.zeros((cap, 3), np.float32)
        pv = np.zeros(cap, bool)
        pts[: self.num_points] = self.points[: self.num_points]
        pv[: self.num_points] = self.point_valid[: self.num_points]
        self.points = pts
        self.point_valid = pv

    def materialize(self) -> Reconstruction:
        """Snapshot as a Reconstruction (active obs only). Point arrays are
        VIEWS into the engine state: BA writeback flows straight through."""
        pts = self.points[: self.num_points]
        pv = self.point_valid[: self.num_points]
        tr = self.tracks
        has_pt = self.track_point[tr.track_id] >= 0
        act = self.obs_alive & self.registered[tr.obs_image] & has_pt
        if len(pv):
            act &= np.where(has_pt, pv[np.maximum(self.track_point[tr.track_id], 0)], False)
        else:  # no points triangulated yet: an empty-but-valid Reconstruction
            act[:] = False
        rows = np.where(act)[0]
        return Reconstruction(
            intrinsics=self.intrinsics,
            rvecs=self.rvecs,
            tvecs=self.tvecs,
            registered=self.registered.copy(),
            points=pts,
            point_errors=np.zeros(len(pts), np.float32),
            point_valid=pv,
            obs_point=self.track_point[tr.track_id[rows]].astype(np.int32),
            obs_image=tr.obs_image[rows].astype(np.int32),
            obs_kp=tr.obs_kp[rows].astype(np.int32),
            obs_uv=self._uv(rows),
        )

    def _uv(self, rows: np.ndarray) -> np.ndarray:
        return self.feats.xy[self.tracks.obs_image[rows], self.tracks.obs_kp[rows]].astype(np.float32)


def _np_rotmat(rvec: np.ndarray) -> np.ndarray:
    """Host Rodrigues for edge ranking: angle-axis [..., 3] -> [..., 3, 3]."""
    theta = np.linalg.norm(rvec, axis=-1)
    k = rvec / np.maximum(theta, 1e-12)[..., None]
    K = np.zeros(rvec.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    st, ct = np.sin(theta)[..., None, None], np.cos(theta)[..., None, None]
    R = np.eye(3) + st * K + (1.0 - ct) * (K @ K)
    R[theta < 1e-10] = np.eye(3)
    return R


def _edge_parallax_deg(graph: MatchGraph, edges: np.ndarray, feats: FeatureSet,
                       intrinsics: np.ndarray) -> np.ndarray:
    """Median rotation-compensated ray angle per edge (degrees): the
    triangulation angle the bootstrap would get (COLMAP's init criterion,
    pinhole-only, on the host)."""
    i, j = graph.pairs[edges, 0], graph.pairs[edges, 1]
    uv_i = feats.xy[i[:, None], graph.idx_i[edges]].astype(np.float64)  # [E, M, 2]
    uv_j = feats.xy[j[:, None], graph.idx_j[edges]].astype(np.float64)

    def rays(uv, intr):
        f = intr[:, None, 0:2]
        c = intr[:, None, 2:4]
        xy = (uv - c) / np.maximum(f, 1e-6)
        r = np.concatenate([xy, np.ones_like(xy[..., :1])], axis=-1)
        return r / np.linalg.norm(r, axis=-1, keepdims=True)

    r_i = rays(uv_i, intrinsics[i])
    r_j = rays(uv_j, intrinsics[j])
    R = _np_rotmat(graph.rvec[edges].astype(np.float64))       # cam_i -> cam_j
    r_j_in_i = np.einsum("ekj,emk->emj", R, r_j)               # R^T @ r_j
    cosang = np.clip(np.sum(r_i * r_j_in_i, axis=-1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cosang))
    ang = np.where(graph.inlier[edges], ang, np.nan)
    with np.errstate(all="ignore"):
        med = np.nanmedian(ang, axis=-1)
    return np.where(np.isfinite(med), med, 0.0)


def rank_init_pairs(graph: MatchGraph, feats: FeatureSet, intrinsics: np.ndarray,
                    cfg: PipelineConfig) -> np.ndarray:
    """Ranked bootstrap candidates, edge ids best-first: many inliers, not
    homography-degenerate, and with real parallax. Edges failing the
    parallax gate rank after every edge that passes it."""
    pose_ok = graph.pose_ok if graph.pose_ok is not None else graph.ok
    ok = graph.ok & pose_ok
    h_ratio = graph.num_h_inliers / np.maximum(graph.num_inliers, 1)
    ok &= graph.num_inliers >= cfg.engine.init_min_inliers
    ok &= h_ratio <= cfg.engine.init_max_h_ratio
    if not ok.any():
        # Fallback: relax the inlier bar but keep the degeneracy gate.
        ok = graph.ok & pose_ok & (h_ratio <= cfg.engine.init_max_h_ratio)
        if not ok.any():
            # Fully planar scene: bootstrap from the best-supported edge
            # with a usable pose (correspondence-only edges cannot seed).
            ok = graph.ok & pose_ok
            if not ok.any():
                return np.zeros(0, np.int64)
    score = np.where(ok, graph.num_inliers * (1.0 - 0.5 * h_ratio), -1.0)
    top = np.where(score > 0)[0]
    if len(top) == 0:
        return np.zeros(0, np.int64)
    parallax = np.concatenate([
        _edge_parallax_deg(graph, top[s: s + _PARALLAX_CHUNK], feats, intrinsics)
        for s in range(0, len(top), _PARALLAX_CHUNK)
    ])
    gate = parallax >= max(cfg.engine.init_min_triangulation_angle_deg, 1e-3)
    # Pass-group by score; fail-group by parallax (most parallax first).
    order = np.lexsort((-np.where(gate, score[top], parallax), ~gate))
    return top[order]


def _register_bootstrap(st: EngineState, graph: MatchGraph, edge: int,
                        rvec: np.ndarray, tvec: np.ndarray):
    i, j = graph.pairs[edge]
    st.rvecs[i] = 0.0
    st.tvecs[i] = 0.0
    st.rvecs[j] = rvec
    st.tvecs[j] = tvec
    st.registered[i] = st.registered[j] = True


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], -1)


def _two_view_pose_search(x1, x2, mask, rvec0, tvec0, min_angle_deg: float, thr_norm_sq: float):
    """Best relative pose for a bootstrap edge, by triangulability.

    Refits E and H on the edge's inlier correspondences (normalized camera
    coords, masked) and scores all nine candidates (the stored verify pose,
    4 from E, 4 from H) by how many correspondences land in front of both
    cameras with parallax above the gate and a midpoint that reprojects
    within the threshold in both views. Returns (rvec, tvec, count)."""
    w = mask.to(x1.dtype)
    E = solvers.essential_minimal(x1, x2, w)
    Re, te = solvers.decompose_essential_all(E)
    Rh, th = solvers.decompose_homography_all(solvers.homography_4pt(x1, x2, w))
    t0 = tvec0 / torch.linalg.vector_norm(tvec0).clamp_min(1e-9)
    Rs = torch.cat([so3_exp(rvec0)[None], Re, Rh])        # [9, 3, 3]
    ts = torch.cat([t0[None], te, th])                    # [9, 3]

    f1, f2 = _homog(x1), _homog(x2)
    r1 = f1 / torch.linalg.vector_norm(f1, dim=-1, keepdim=True)
    r2 = f2 / torch.linalg.vector_norm(f2, dim=-1, keepdim=True)
    cos_gate = float(np.cos(np.deg2rad(min_angle_deg)))

    z1, z2 = solvers.two_view_depths(Rs, ts, x1[None], x2[None])     # [9, M]
    cosang = (r1 * (r2 @ Rs)).sum(-1)                                # R^T r2 rowwise
    # Midpoint of the two ray endpoints, checked in both views: a garbage
    # pose can fake parallax, but its rays are skew.
    Xm = 0.5 * (z1[..., None] * f1 + (z2[..., None] * f2 - ts[:, None, :]) @ Rs)
    zm1 = torch.where(Xm[..., 2].abs() < 1e-9, torch.full_like(z1, 1e-9), Xm[..., 2])
    e1 = ((Xm[..., :2] / zm1[..., None] - x1) ** 2).sum(-1)
    Xc2 = Xm @ Rs.transpose(-1, -2) + ts[:, None, :]
    zm2 = torch.where(Xc2[..., 2].abs() < 1e-9, torch.full_like(z1, 1e-9), Xc2[..., 2])
    e2 = ((Xc2[..., :2] / zm2[..., None] - x2) ** 2).sum(-1)
    ok = (mask & (z1 > 0) & (z2 > 0) & (Xm[..., 2] > 0) & (Xc2[..., 2] > 0)
          & (cosang <= cos_gate) & (e1 <= thr_norm_sq) & (e2 <= thr_norm_sq))
    counts = ok.sum(-1)
    best = torch.argmax(counts)
    return matrix_to_aa(Rs[best]), ts[best], counts[best]


def _triangulate_new(st: EngineState, cfg: PipelineConfig, device: torch.device,
                     min_angle_override: float | None = None) -> int:
    """Triangulate tracks seen by >=2 registered images that lack a point.

    min_angle_override: bootstrap passes the (much lower) seed-pair parallax
    floor here; steady-state triangulation uses the map-quality gate."""
    tr = st.tracks
    reg_obs = st.obs_alive & st.registered[tr.obs_image]
    seen = np.bincount(tr.track_id[reg_obs], minlength=tr.num_tracks)
    cand = np.where((seen >= 2) & (st.track_point < 0))[0]
    if len(cand) == 0:
        return 0

    T, V = len(cand), _TRI_VIEW_CAP
    rvecs = np.zeros((T, V, 3), np.float32)
    tvecs = np.zeros((T, V, 3), np.float32)
    xy = np.zeros((T, V, 2), np.float32)
    mask = np.zeros((T, V), bool)

    # Up to V registered observations per candidate track: track rows are
    # sorted by track id, so each row's rank within its track comes from a
    # searchsorted; one fancy-index fill and one device normalisation.
    rows = np.where(reg_obs)[0]
    tids = tr.track_id[rows]
    slot_of_track = -np.ones(tr.num_tracks, np.int64)
    slot_of_track[cand] = np.arange(len(cand))
    keep = slot_of_track[tids] >= 0
    rows, tids = rows[keep], tids[keep]
    first = np.searchsorted(tids, tids, side="left")
    rank = np.arange(len(rows)) - first
    keep = rank < V
    rows, tids, rank = rows[keep], tids[keep], rank[keep]
    slots = slot_of_track[tids]

    imgs = tr.obs_image[rows]
    rvecs[slots, rank] = st.rvecs[imgs]
    tvecs[slots, rank] = st.tvecs[imgs]
    xy[slots, rank] = _to_camera(st.feats.xy[imgs, tr.obs_kp[rows]], st.intrinsics[imgs], device)
    mask[slots, rank] = True

    f_mean = float(np.mean(st.intrinsics[st.registered, 0]))
    min_angle = (cfg.engine.min_triangulation_angle_deg
                 if min_angle_override is None else min_angle_override)
    res = triangulate_tracks(
        *(torch.from_numpy(a).to(device) for a in (rvecs, tvecs, xy, mask)),
        min_angle_deg=min_angle,
        max_error_norm=cfg.engine.max_reprojection_error_px / f_mean,
    )
    valid = res.valid.cpu().numpy()
    pts = res.points.cpu().numpy()
    new = np.where(valid)[0]
    # Scene-state point budget (EngineConfig.max_points): keep the first
    # candidates that fit; the rest stay untriangulated.
    budget = cfg.engine.max_points - st.num_points
    if len(new) > budget:
        if cfg.verbose:
            print(f"[sfm_tpu_torch] point budget hit: dropping {len(new) - budget} of {len(new)} new points")
        new = new[:max(budget, 0)]
    n0 = st.num_points
    st.ensure_point_capacity(n0 + len(new))
    st.track_point[cand[new]] = n0 + np.arange(len(new))
    st.points[n0:n0 + len(new)] = pts[new]
    st.point_valid[n0:n0 + len(new)] = True
    st.num_points = n0 + len(new)
    return len(new)


def _pnp_register(st: EngineState, img: int, cfg: PipelineConfig, attempt: int,
                  device: torch.device, floor: int | None = None) -> bool:
    """Register image `img` by RANSAC-EPnP against the triangulated points it
    sees. `attempt` keys the minimal-set draws."""
    min_inl = cfg.engine.abs_pose_min_inliers if floor is None else floor
    tr = st.tracks
    rows = np.where((tr.obs_image == img) & st.obs_alive)[0]
    rows = rows[st.track_point[tr.track_id[rows]] >= 0]
    if len(rows) < min_inl:
        return False
    pts_arr = st.points[: st.num_points]
    pv = st.point_valid[: st.num_points]
    pids = st.track_point[tr.track_id[rows]]
    keep = pv[pids]
    rows, pids = rows[keep], pids[keep]
    if len(rows) < min_inl:
        return False
    rows = rows[:_PNP_CAP]
    pids = pids[:_PNP_CAP]

    X = np.zeros((_PNP_CAP, 3), np.float32)
    uv = np.zeros((_PNP_CAP, 2), np.float32)
    mask = np.zeros(_PNP_CAP, bool)
    X[: len(rows)] = pts_arr[pids]
    uv[: len(rows)] = _to_camera(st.feats.xy[img, tr.obs_kp[rows]],
                                 np.broadcast_to(st.intrinsics[img], (len(rows), 6)), device)
    mask[: len(rows)] = True

    f = (st.intrinsics[img, 0] + st.intrinsics[img, 1]) * 0.5
    thr = float((cfg.engine.abs_pose_error_px / f) ** 2)
    mask_t = torch.from_numpy(mask).to(device)
    idx = ransac_ops.draw_minimal_sets(cfg.seed + 1, attempt, mask_t, cfg.ransac.num_hypotheses,
                                       8, "pnp")
    pose, inl, _, ok = pnp_ransac(idx, torch.from_numpy(X).to(device), torch.from_numpy(uv).to(device),
                                  mask_t, threshold_sq=thr, min_inliers=min_inl)
    if not bool(ok):
        return False
    pose = pose.cpu().numpy()
    st.rvecs[img] = pose[:3]
    st.tvecs[img] = pose[3:]
    st.registered[img] = True
    # Kill the outlier 2D-3D links so they don't poison BA.
    bad = rows[~inl.cpu().numpy()[: len(rows)]]
    st.obs_alive[bad] = False
    return True


def _local_ba_cameras(rec: Reconstruction, window: np.ndarray, cap: int) -> np.ndarray:
    """Camera set for a local BA problem: the window plus the cameras most
    co-observing its points (capped), so local BA stays O(window)."""
    in_window = np.zeros(len(rec.registered), bool)
    in_window[window] = True
    win_obs = in_window[rec.obs_image]
    pts = np.zeros(len(rec.points), bool)
    pts[rec.obs_point[win_obs]] = True
    co_rows = pts[rec.obs_point] & ~win_obs
    counts = np.bincount(rec.obs_image[co_rows], minlength=len(rec.registered))
    counts[~rec.registered] = 0
    co = np.argsort(-counts)
    co = co[counts[co] > 0][: max(cap - len(window), 0)]
    return np.sort(np.concatenate([np.asarray(window), co]).astype(np.int64))


def _run_ba(st: EngineState, cfg: PipelineConfig, device: torch.device, free_cams=None) -> None:
    rec = st.materialize()
    if rec.num_observations < 8 or rec.num_points < 4:
        return
    # Intrinsics refinement only in global BA (free_cams None): local windows
    # lack the coverage to constrain focal/distortion.
    refine = free_cams is None and (cfg.ba.refine_focal or cfg.ba.refine_distortion)
    cam_indices = None
    if free_cams is not None:
        cam_indices = _local_ba_cameras(rec, free_cams, cfg.engine.local_ba_max_cameras)
    prob, cams, pids = build_problem(rec, cam_indices=cam_indices, free_cams=free_cams,
                                     refine_intrinsics=refine, device=device)
    out, _ = dispatch_bundle_adjust(prob, cfg)
    # rec.points is a view into st.points (materialize), so writeback lands
    # directly in the engine state; poses are plain arrays and copy back.
    writeback(rec, out, cams, pids)
    st.rvecs[:] = rec.rvecs
    st.tvecs[:] = rec.tvecs


def _filter_observations(st: EngineState, cfg: PipelineConfig) -> int:
    """Drop observations above the reprojection gate; invalidate starved points."""
    rec = st.materialize()
    if rec.num_observations == 0:
        return 0
    err = rec.reprojection_errors()
    bad = err > cfg.engine.max_reprojection_error_px
    # Map back to track rows: materialize() selected rows in order.
    tr = st.tracks
    has_pt = st.track_point[tr.track_id] >= 0
    pv = st.point_valid[: st.num_points]
    act = st.obs_alive & st.registered[tr.obs_image] & has_pt
    act &= np.where(has_pt, pv[np.maximum(st.track_point[tr.track_id], 0)], False)
    rows = np.where(act)[0]
    st.obs_alive[rows[bad]] = False

    # Points need >=2 alive registered observations.
    alive = st.obs_alive & st.registered[tr.obs_image]
    pids_alive = st.track_point[tr.track_id[alive]]
    counts = np.bincount(pids_alive[pids_alive >= 0], minlength=st.num_points)
    starved = counts < 2
    newly = pv & starved
    st.point_valid[: st.num_points] &= ~starved
    # Allow re-triangulation of their tracks later.
    dropped = np.zeros(st.num_points + 1, bool)
    dropped[np.where(newly)[0]] = True
    tp = st.track_point
    st.track_point = np.where((tp >= 0) & dropped[np.minimum(tp, st.num_points)], -1, tp)
    return int(bad.sum())


def incremental_reconstruct(
    feats: FeatureSet, graph: MatchGraph, intrinsics: np.ndarray, cfg: PipelineConfig,
    device: torch.device | str, checkpoint_cb=None,
) -> Reconstruction:
    """Incremental SfM over a verified match graph, device steps on `device`.

    checkpoint_cb(step, reconstruction) is invoked every
    cfg.engine.checkpoint_every registrations. The result's stage_seconds
    holds the engine's per-phase wall seconds under engine.* keys."""
    device = torch.device(device)
    B, N = feats.valid.shape
    if B > cfg.engine.max_images:
        raise ValueError(
            f"{B} images exceeds EngineConfig.max_images={cfg.engine.max_images}; "
            "raise the capacity or enable partitioning (PartitionConfig)"
        )
    tracks = build_tracks(graph, B, N)
    if tracks.num_tracks == 0:
        raise ReconstructionError("no tracks: match/verify produced no usable edges")
    if len(tracks.obs_image) > cfg.engine.max_observations:
        raise ValueError(
            f"{len(tracks.obs_image)} track observations exceed "
            f"EngineConfig.max_observations={cfg.engine.max_observations}; "
            "raise the capacity, prune the match graph, or partition"
        )
    timer = StageTimer(verbose=False, device=device)

    def phase(name: str):
        return timer.stage("engine." + name)

    st = EngineState(
        feats=feats,
        tracks=tracks,
        intrinsics=intrinsics.copy(),
        rvecs=np.zeros((B, 3), np.float32),
        tvecs=np.zeros((B, 3), np.float32),
        registered=np.zeros(B, bool),
        failed=np.zeros(B, bool),
        track_point=-np.ones(tracks.num_tracks, np.int32),
        points=np.zeros((4096, 3), np.float32),
        point_valid=np.zeros(4096, bool),
        obs_alive=np.ones(len(tracks.obs_image), bool),
    )

    cands = rank_init_pairs(graph, feats, intrinsics, cfg)
    if len(cands) == 0:
        raise ReconstructionError("no valid initial pair")
    # Bootstrap retry: an edge can pass two-view verification yet
    # triangulate nothing. Try ranked candidates until one produces a usable
    # seed map; roll the 2-camera state back in between.
    min_seed_pts = max(8, cfg.engine.abs_pose_min_inliers)

    def searched_pose(e: int):
        """Triangulability-scored pose for edge e (see _two_view_pose_search)."""
        i, j = graph.pairs[e]
        x1 = _to_camera(feats.xy[i, graph.idx_i[e]], np.broadcast_to(intrinsics[i], (graph.idx_i.shape[1], 6)), device)
        x2 = _to_camera(feats.xy[j, graph.idx_j[e]], np.broadcast_to(intrinsics[j], (graph.idx_j.shape[1], 6)), device)
        f_pair = float(np.sqrt(max(intrinsics[i, 0] * intrinsics[j, 0], 1.0)))
        thr = (cfg.ransac.error_threshold_px / f_pair) ** 2

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        rv, tv, n = _two_view_pose_search(t(x1), t(x2), t(graph.inlier[e]),
                                          t(graph.rvec[e].astype(np.float32)),
                                          t(graph.tvec[e].astype(np.float32)),
                                          float(cfg.engine.init_min_triangulation_angle_deg), thr)
        return rv.cpu().numpy(), tv.cpu().numpy(), int(n)

    tried = 0
    edge = int(cands[0])
    for cand in cands[: 4 * cfg.engine.init_candidates]:
        if tried >= cfg.engine.init_candidates:
            break
        edge = int(cand)
        rv, tv, n_tri = searched_pose(edge)
        if n_tri < min_seed_pts:
            if cfg.verbose:
                print(f"[sfm_tpu_torch] bootstrap edge {graph.pairs[edge]} rejected: "
                      f"best pose triangulates {n_tri} < {min_seed_pts}")
            tried += 1
            continue
        _register_bootstrap(st, graph, edge, rv, tv)
        _triangulate_new(st, cfg, device, min_angle_override=cfg.engine.init_min_triangulation_angle_deg)
        if st.num_points >= min_seed_pts:
            break
        if cfg.verbose:
            print(f"[sfm_tpu_torch] bootstrap edge {graph.pairs[edge]} rejected: "
                  f"{st.num_points} points < {min_seed_pts}")
        i, j = graph.pairs[edge]
        st.registered[i] = st.registered[j] = False
        st.rvecs[i] = st.rvecs[j] = 0.0
        st.tvecs[i] = st.tvecs[j] = 0.0
        st.track_point[:] = -1
        st.point_valid[: st.num_points] = False
        st.num_points = 0
        tried += 1
    if st.num_points == 0:
        # Last resort: take the globally best searched pose even below the
        # seed bar (a 2-camera map can still grow via retries).
        best = None
        for cand in cands[: cfg.engine.init_candidates]:
            rv, tv, n_tri = searched_pose(int(cand))
            if best is None or n_tri > best[3]:
                best = (int(cand), rv, tv, n_tri)
        if best is not None and best[3] > 0:
            edge = best[0]
            _register_bootstrap(st, graph, edge, best[1], best[2])
            _triangulate_new(st, cfg, device,
                             min_angle_override=cfg.engine.init_min_triangulation_angle_deg)
    if st.num_points == 0:
        raise ReconstructionError("bootstrap failed: no candidate pair triangulated any points")
    _run_ba(st, cfg, device)  # two-view BA
    if cfg.verbose:
        print(f"[sfm_tpu_torch] bootstrap edge {graph.pairs[edge]}: {st.num_points} points")

    attempt = 0
    recent: list[int] = list(graph.pairs[edge])
    since_global = 0
    since_retri = 0
    retries_left = 2
    # Adaptive PnP floor (stall rescue): when the march stalls and bounded
    # retries are exhausted, halve the floor (never below _MIN_PNP_FLOOR).
    floor = cfg.engine.abs_pose_min_inliers
    while True:
        # Rank unregistered images by visible triangulated points, then
        # register a ROUND of the best candidates before re-triangulating and
        # bundle-adjusting once.
        tr = st.tracks
        vis_rows = st.obs_alive & (st.track_point[tr.track_id] >= 0)
        counts = np.bincount(tr.obs_image[vis_rows], minlength=B)
        counts[st.registered | st.failed] = 0
        order = np.argsort(-counts)
        round_size = max(1, min(cfg.engine.local_ba_window // 2, 3))
        registered_round: list[int] = []
        with phase("pnp"):
            for img in order[:round_size + 2]:
                if len(registered_round) >= round_size:
                    break
                if counts[img] < floor:
                    break
                attempt += 1
                if _pnp_register(st, int(img), cfg, attempt, device, floor=floor):
                    registered_round.append(int(img))
                else:
                    st.failed[img] = True
        if registered_round:
            if floor < cfg.engine.abs_pose_min_inliers:
                # A rescue round advanced the frontier: return to the full
                # floor and re-arm one retry.
                floor = cfg.engine.abs_pose_min_inliers
                retries_left = max(retries_left, 1)
                st.failed[:] = False
            recent.extend(registered_round)
            with phase("triangulate"):
                n_new = _triangulate_new(st, cfg, device)
            window = recent[-cfg.engine.local_ba_window:]
            with phase("local_ba"):
                _run_ba(st, cfg, device, free_cams=np.asarray(window))
            if cfg.engine.filter_every:
                with phase("filter"):
                    _filter_observations(st, cfg)
            since_global += len(registered_round)
            since_retri += len(registered_round)
            # Geometric schedule: global BA on ~25% model growth at scale.
            ba_period = max(
                cfg.engine.global_ba_every,
                int((cfg.engine.global_ba_growth - 1.0) * st.registered.sum()),
            )
            if since_global >= ba_period:
                with phase("global_ba"):
                    _run_ba(st, cfg, device)
                with phase("filter"):
                    _filter_observations(st, cfg)
                with phase("triangulate"):
                    _triangulate_new(st, cfg, device)
                since_global = 0
                since_retri = 0
            elif cfg.engine.retriangulate_every and since_retri >= cfg.engine.retriangulate_every:
                # Periodic retriangulation between global BAs.
                _filter_observations(st, cfg)
                _triangulate_new(st, cfg, device)
                since_retri = 0
            if checkpoint_cb is not None:
                n_reg = int(st.registered.sum())
                every = max(cfg.engine.checkpoint_every, 1)
                if n_reg // every > (n_reg - len(registered_round)) // every:
                    checkpoint_cb(n_reg, st.materialize())
            if cfg.verbose:
                pv = st.point_valid[: st.num_points]
                print(f"[sfm_tpu_torch] registered {registered_round}: +{n_new} pts, "
                      f"{int(st.registered.sum())}/{B} cams, {int(pv.sum())} pts")
        else:
            # Bounded retry rounds: failed images get another chance once the
            # map has grown.
            if retries_left > 0 and st.failed.any() and st.registered.sum() > 2:
                retries_left -= 1
                st.failed[:] = False
                continue
            # Stall rescue: lower the PnP floor and try again.
            if floor > _MIN_PNP_FLOOR and st.registered.sum() >= 2 and not st.registered.all():
                floor = max(_MIN_PNP_FLOOR, floor // 2)
                st.failed[:] = False
                if cfg.verbose:
                    print(f"[sfm_tpu_torch] stall at {int(st.registered.sum())}/{B}: "
                          f"lowering PnP floor to {floor} for a rescue round")
                continue
            if cfg.verbose and not st.registered.all():
                top = order[:4]
                print(f"[sfm_tpu_torch] stall at {int(st.registered.sum())}/{B}: best "
                      f"unregistered candidates {[(int(t), int(counts[t])) for t in top]} "
                      f"(need >= {cfg.engine.abs_pose_min_inliers} visible points)")
            break

    # Final polish: global BA + filter + last retriangulation + BA.
    with phase("global_ba"):
        _run_ba(st, cfg, device)
        _filter_observations(st, cfg)
        _triangulate_new(st, cfg, device)
        _run_ba(st, cfg, device)
    rec = st.materialize()
    rec.stage_seconds = dict(timer.durations)
    return rec
