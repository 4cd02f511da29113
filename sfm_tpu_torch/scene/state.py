"""Reconstruction state (port of sfm_tpu/scene/state.py).

The host-side scene: cameras (intrinsics + world->camera poses), sparse
points, and observations (point_id, image_id, keypoint_id, pixel), all plain
numpy. A track is the set of observation rows sharing a point_id.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from sfm_tpu_torch.geometry.projection import point_depth, project


class ReconstructionError(RuntimeError):
    """An engine could not reconstruct its input (no usable tracks, no valid
    initial pair, a bootstrap that triangulates nothing, no cluster with a
    map): the data's fault, as opposed to a device, build or launch error."""


@dataclass
class Reconstruction:
    """Cameras, poses, points, observations — the public API output."""

    intrinsics: np.ndarray          # [K, 6]
    rvecs: np.ndarray               # [K, 3] world->camera
    tvecs: np.ndarray               # [K, 3]
    registered: np.ndarray          # [K] bool
    image_names: list = field(default_factory=list)
    image_sizes: np.ndarray = None  # [K, 2] (width, height) of the input canvases

    points: np.ndarray = None       # [P, 3]
    point_errors: np.ndarray = None # [P] mean reprojection error
    point_valid: np.ndarray = None  # [P] bool

    obs_point: np.ndarray = None    # [O] int32
    obs_image: np.ndarray = None    # [O] int32
    obs_kp: np.ndarray = None       # [O] int32
    obs_uv: np.ndarray = None       # [O, 2] float32

    # Wall-clock seconds per pipeline stage of the run that produced this
    # reconstruction (device work synchronised at stage boundaries).
    stage_seconds: dict = field(default_factory=dict)

    @property
    def num_registered(self) -> int:
        return int(self.registered.sum())

    @property
    def num_points(self) -> int:
        return 0 if self.point_valid is None else int(self.point_valid.sum())

    @property
    def num_observations(self) -> int:
        return 0 if self.obs_point is None else len(self.obs_point)

    def reprojection_errors(self) -> np.ndarray:
        """Per-observation reprojection error in pixels. [O]."""
        return self.reprojection_errors_depths()[0]

    def reprojection_errors_depths(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-observation (reprojection error px, camera-frame depth), fp32 on
        the host. [O]."""
        if self.num_observations == 0:
            return np.zeros(0, dtype=np.float32), np.zeros(0, dtype=np.float32)
        pts = torch.from_numpy(self.points[self.obs_point].astype(np.float32))
        rv = torch.from_numpy(self.rvecs[self.obs_image].astype(np.float32))
        tv = torch.from_numpy(self.tvecs[self.obs_image].astype(np.float32))
        intr = torch.from_numpy(self.intrinsics[self.obs_image].astype(np.float32))
        uv = torch.from_numpy(self.obs_uv.astype(np.float32))
        err = torch.linalg.vector_norm(project(pts, rv, tv, intr) - uv, dim=-1)
        return err.numpy(), point_depth(pts, rv, tv).numpy()

    def mean_reprojection_error(self) -> float:
        """Mean pixel reprojection error over observations of valid points."""
        if self.num_observations == 0:
            return float("nan")
        err = self.reprojection_errors()
        ok = self.point_valid[self.obs_point]
        return float(err[ok].mean()) if ok.any() else float("nan")

    def track_lengths(self) -> np.ndarray:
        if self.num_observations == 0:
            return np.zeros(0, dtype=np.int32)
        counts = np.bincount(self.obs_point, minlength=len(self.points))
        return counts[self.point_valid]

    def summary(self) -> dict:
        """The reconstruction report (the BASELINE metrics)."""
        tl = self.track_lengths()
        err = self.reprojection_errors()
        hist_edges = [2, 3, 4, 6, 9, 14, 22]
        hist = np.histogram(tl, bins=hist_edges + [1 << 30])[0] if len(tl) else np.zeros(7, int)
        return {
            "num_images": int(len(self.registered)),
            "num_registered": self.num_registered,
            "num_points": self.num_points,
            "num_observations": self.num_observations,
            "mean_reproj_error_px": self.mean_reprojection_error(),
            "median_reproj_error_px": float(np.median(err)) if len(err) else float("nan"),
            "mean_track_length": float(tl.mean()) if len(tl) else 0.0,
            "track_length_hist": {f">={e}": int(c) for e, c in zip(hist_edges, hist)},
        }


def filter_observations(rec: Reconstruction, max_err_px: float) -> int:
    """Drop gross-outlier observations and starved points in place.

    Same policy as the engine's per-round filter, but operating on a
    materialized Reconstruction — used between global-BA passes after a
    divide-and-conquer merge, where wrongly-linked cross-cluster tracks
    poison the robust solve. Removes observations with reprojection error
    above max_err_px OR non-positive camera-frame depth (behind-camera
    points reproject to finite pixels, so the px gate alone passes them;
    their f/z^2 Jacobians then blow up the BA normal equations),
    invalidates points left with <2 observations, and prunes their
    remaining rows. Returns the number of rows removed.
    """
    if rec.num_observations == 0:
        return 0
    n0 = rec.num_observations
    errs, depths = rec.reprojection_errors_depths()
    keep = (errs <= max_err_px) & (depths > 0) & rec.point_valid[rec.obs_point]
    for name in ("obs_point", "obs_image", "obs_kp", "obs_uv"):
        setattr(rec, name, getattr(rec, name)[keep])
    counts = np.bincount(rec.obs_point, minlength=len(rec.points))
    rec.point_valid &= counts >= 2
    keep2 = rec.point_valid[rec.obs_point]
    for name in ("obs_point", "obs_image", "obs_kp", "obs_uv"):
        setattr(rec, name, getattr(rec, name)[keep2])
    return n0 - rec.num_observations
