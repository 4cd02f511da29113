"""BA problem arrays: padded device views of the Reconstruction state
(port of sfm_tpu/ba/problem.py; build_problem, _align_segments and
writeback are the JAX package's host code with torch tensors out)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sfm_tpu_torch.scene.state import Reconstruction

CAM_DIM = 6   # rvec(3) + tvec(3); +2 (log-focal-scale, dk1) when refining intrinsics
CAM_DIM_INTR = 8
PT_DIM = 3

_ARRAY_FIELDS = (
    "cam_params", "intrinsics", "points", "obs_cam", "obs_point",
    "obs_uv", "obs_w", "cam_fixed", "point_fixed",
)


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Statically-shaped bundle adjustment problem (tensors on one device).

    Cameras and points are indexed densely [0, C) / [0, P); observations are
    padded to a fixed budget with obs_w = 0 and sorted by point. cam_fixed
    marks gauge-fixed or out-of-window cameras (their updates are zeroed).
    point_align != 0 certifies that no point's segment straddles a multiple
    of point_align (padding tail exempt). No kernel of the port reads it
    (K11 walks point segments directly); the alignment padding is kept so
    the padded capacities, which pick the reduced solver, match sfm_tpu's.
    """

    cam_params: torch.Tensor   # [C, 6] rvec + tvec
    intrinsics: torch.Tensor   # [C, 6]
    points: torch.Tensor       # [P, 3]
    obs_cam: torch.Tensor      # [O] int32
    obs_point: torch.Tensor    # [O] int32
    obs_uv: torch.Tensor       # [O, 2]
    obs_w: torch.Tensor        # [O] float (0 = padding)
    cam_fixed: torch.Tensor    # [C] bool
    point_fixed: torch.Tensor  # [P] bool
    point_align: int = 0

    def _replace(self, **kwargs) -> "BAProblem":
        return dataclasses.replace(self, **kwargs)

    @property
    def num_cameras(self):
        return self.cam_params.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]


def _align_segments(obs_point_sorted: np.ndarray, base_tile: int = 256,
                    max_tile: int = 1024) -> tuple[np.ndarray, int]:
    """Compute per-observation output positions so that no point's segment
    straddles a multiple of the chosen tile.

    Greedy in one pass: whenever the next segment would cross a tile
    boundary, skip to the boundary first (the gap is later filled with
    zero-weight padding rows carrying the PREVIOUS point id, which keeps
    point-sortedness). Alignment at `tile` implies alignment at every
    multiple of `tile`, so kernels may use any tile that is a multiple of
    the returned value.

    Returns (positions [O], tile). tile = 0 means alignment failed (a single
    segment longer than max_tile).
    """
    O = len(obs_point_sorted)
    if O == 0:
        return np.zeros(0, np.int64), base_tile
    starts_mask = np.empty(O, bool)
    starts_mask[0] = True
    np.not_equal(obs_point_sorted[1:], obs_point_sorted[:-1], out=starts_mask[1:])
    seg_starts = np.where(starts_mask)[0]
    seg_lens = np.diff(np.append(seg_starts, O))
    max_len = int(seg_lens.max())
    tile = base_tile
    while tile < max_len:
        tile *= 2
    if tile > max_tile:
        return np.arange(O, dtype=np.int64), 0

    # Greedy walk over segments (host-side; vectorizing is possible but the
    # decision at segment i depends on all padding before it).
    seg_offsets = np.empty(len(seg_lens), np.int64)
    off = 0
    for i, L in enumerate(seg_lens.tolist()):
        rem = off % tile
        if rem and rem + L > tile:
            off += tile - rem
        seg_offsets[i] = off
        off += L
    positions = seg_offsets[np.cumsum(starts_mask) - 1] + (np.arange(O) - seg_starts[np.cumsum(starts_mask) - 1])
    return positions, tile


def _round_up(n: int, m: int) -> int:
    """Round n up to m * 2^k — geometric capacity buckets so the incremental
    engine triggers only O(log) BA recompiles as the scene grows."""
    cap = m
    n = max(n, 1)
    while cap < n:
        cap *= 2
    return cap


def _ceil_to(n: int, m: int) -> int:
    """Round n up to the next multiple of m (tight one-shot capacities)."""
    return max(m, -(-n // m) * m)


def build_problem(
    rec: Reconstruction,
    cam_indices: np.ndarray | None = None,
    free_cams: np.ndarray | None = None,
    obs_capacity: int | None = None,
    point_capacity: int | None = None,
    refine_intrinsics: bool = False,
    tight: bool = False,
    *,
    device: torch.device | str,
) -> tuple[BAProblem, np.ndarray, np.ndarray]:
    """Extract a BA problem from the reconstruction.

    cam_indices: global image ids to include (default: all registered).
    free_cams: subset of cam_indices that are optimized (default: all but
      the first, which anchors the gauge).
    refine_intrinsics: widen the camera block to 8 — the extra params are
      (focal log-scale, k1 delta), applied on top of the stored intrinsics
      (SURVEY.md §2.6 intrinsics refinement; config-switched block width).
    tight: round capacities to fine-grained multiples instead of the
      geometric m*2^k buckets. Geometric buckets exist so the incremental
      engine recompiles only O(log) times as the scene grows; a ONE-SHOT
      solve (the merged-model global polish) prefers tight caps — the
      9,998-camera 10k polish otherwise pads to C=16384 and wastes ~64% of
      every camera-axis op on dead slots.
    device: where the problem's tensors live (required: a BA runs where
      its problem is, so a default would silently pick the solver's device).
    Returns (problem, cam_indices, point_ids) where point_ids maps local
    point rows back to reconstruction point ids.
    """
    if cam_indices is None:
        cam_indices = np.where(rec.registered)[0]
    cam_indices = np.asarray(cam_indices, dtype=np.int32)
    cam_lut = -np.ones(len(rec.registered), dtype=np.int32)
    cam_lut[cam_indices] = np.arange(len(cam_indices))

    # Observations whose image is in the camera set and point is valid.
    sel = (cam_lut[rec.obs_image] >= 0) & rec.point_valid[rec.obs_point]
    obs_rows = np.where(sel)[0]
    point_ids = np.unique(rec.obs_point[obs_rows])
    pt_lut = -np.ones(len(rec.points), dtype=np.int32)
    pt_lut[point_ids] = np.arange(len(point_ids))

    # Sort observations by (point, camera): point-indexed segment_sums in
    # the BA core then take the sorted fast path (segmented scan instead of
    # scatter-add) — they run twice per CG iteration.
    order = np.lexsort((rec.obs_image[obs_rows], rec.obs_point[obs_rows]))
    obs_rows = obs_rows[order]

    O = len(obs_rows)
    C = len(cam_indices)
    P = len(point_ids)
    local_pts = pt_lut[rec.obs_point[obs_rows]]

    # Tile-align point segments (see BAProblem.point_align): insert
    # zero-weight padding rows so no segment straddles a tile boundary —
    # the fused Schur-matvec kernel reduces point segments tile-locally.
    positions, align = _align_segments(local_pts)
    O_aligned = int(positions[-1]) + 1 if O else 0
    if align and obs_capacity is not None and O_aligned > obs_capacity:
        align = 0  # honor the caller's capacity bucket over alignment
    if not align:
        positions = np.arange(O, dtype=np.int64)
        O_aligned = O

    if tight:
        O_cap = obs_capacity or _ceil_to(O_aligned, 1024)
        P_cap = point_capacity or _ceil_to(P, 256)
        C_cap = _ceil_to(C, 256) if C > 256 else _round_up(C, 8)
    else:
        O_cap = obs_capacity or _round_up(O_aligned, 1024)
        P_cap = point_capacity or _round_up(P, 256)
        # Camera capacity is bucketed too: the incremental engine registers
        # one camera at a time, and without this every registration would
        # recompile the whole LM program (C appears in every array shape).
        C_cap = _round_up(C, 8)

    obs_cam = np.zeros(O_cap, np.int32)
    obs_uv = np.zeros((O_cap, 2), np.float32)
    obs_w = np.zeros(O_cap, np.float32)
    obs_cam[positions] = cam_lut[rec.obs_image[obs_rows]]
    obs_uv[positions] = rec.obs_uv[obs_rows]
    obs_w[positions] = 1.0
    # Padding rows (alignment gaps + tail) carry the id of the PREVIOUS real
    # observation's point so point-sortedness survives padding; their
    # contributions are exactly zero via obs_w = 0. Rows before any real
    # observation and the tail past the last one use the last point slot.
    obs_point = np.full(O_cap, max(P_cap - 1, 0), np.int32)
    if O:
        obs_point[positions] = local_pts
        mark = np.zeros(O_cap, bool)
        mark[positions] = True
        last_real = np.maximum.accumulate(np.where(mark, np.arange(O_cap), -1))
        interior = (last_real >= 0) & (np.arange(O_cap) <= positions[-1])
        obs_point[interior] = obs_point[np.maximum(last_real, 0)][interior]

    points = np.zeros((P_cap, 3), np.float32)
    points[:P] = rec.points[point_ids]

    if free_cams is None:
        fixed = np.zeros(C_cap, bool)
        fixed[0] = True  # gauge anchor
    else:
        free_set = set(int(i) for i in free_cams)
        fixed = np.array([int(g) not in free_set for g in cam_indices] + [True] * (C_cap - C))
        # Local-BA gauge: when every camera in the window is free (common
        # early on, when all registered cameras fit in local_ba_window) the
        # problem has a 7-DoF null space constrained only by LM damping.
        # Anchor the two oldest cameras (6 DoF + scale) in that case.
        if not fixed[:C].any():
            fixed[0] = True
            if C > 1:
                fixed[1] = True
    fixed[C:] = True  # padded camera slots never move

    cp = np.concatenate([rec.rvecs[cam_indices], rec.tvecs[cam_indices]], axis=1)
    if refine_intrinsics:
        cp = np.concatenate([cp, np.zeros((len(cam_indices), 2))], axis=1)
    cp = np.concatenate([cp, np.zeros((C_cap - C, cp.shape[1]))], axis=0)
    intr = np.concatenate(
        [rec.intrinsics[cam_indices],
         np.tile([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0]], (C_cap - C, 1))], axis=0
    )
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    prob = BAProblem(
        cam_params=t(cp.astype(np.float32)),
        intrinsics=t(intr.astype(np.float32)),
        points=t(points),
        obs_cam=t(obs_cam),
        obs_point=t(obs_point),
        obs_uv=t(obs_uv),
        obs_w=t(obs_w),
        cam_fixed=t(fixed),
        point_fixed=t(np.arange(P_cap) >= P),
        point_align=align,
    )
    return prob, cam_indices, point_ids


def writeback(rec: Reconstruction, prob: BAProblem, cam_indices: np.ndarray, point_ids: np.ndarray) -> None:
    """Write optimized parameters back into the reconstruction (in place)."""
    cp = prob.cam_params.cpu().numpy()[: len(cam_indices)]  # drop padded camera slots
    rec.rvecs[cam_indices] = cp[:, :3]
    rec.tvecs[cam_indices] = cp[:, 3:6]
    if cp.shape[1] >= CAM_DIM_INTR:
        scale = np.exp(cp[:, 6])
        rec.intrinsics[cam_indices, 0] *= scale
        rec.intrinsics[cam_indices, 1] *= scale
        rec.intrinsics[cam_indices, 4] += cp[:, 7]
    pts = prob.points.cpu().numpy()[: len(point_ids)]
    rec.points[point_ids] = pts
