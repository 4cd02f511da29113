"""Camera-sharded bundle adjustment (port of sfm_tpu/dist/sharded_ba.py).

Observations are sharded across the processes by camera blocks (each
process's rows are the observations of its cameras); camera and point
parameters are replicated. Every observation-indexed sum of the LM
completes with an all_reduce (ba/core.py's `group` argument, where sfm_tpu
psums), after which every process holds the same normal equations and the
CG and LM iterates stay bitwise identical across processes; the LM's exit
test reads an all-reduced cost, so every process leaves on the same
iteration.

The kernels' point-segment tables need each process's rows sorted by point,
and a camera-major order is not: each process sorts its own rows by point
(stable, rank-local) before the invariants are built, the padding rows
(obs_w = 0) kept at the tail. sfm_tpu voids its point-tile contract instead
(point_align = 0).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ba.core import BAStats, bundle_adjust
from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.dist.mesh import Mesh


def shard_problem_by_camera(prob: BAProblem, num_shards: int) -> BAProblem:
    """Reorder and pad the observations so that shard s, rows
    [s * cap, (s + 1) * cap), holds whole cameras' observations of roughly
    equal count (greedy longest-processing-time balance by per-camera
    observation count); cap is the least 256 * 2^k that holds the largest
    shard. Padding rows carry row 0's indices and obs_w = 0. sfm_tpu's
    function on the host (numpy), the same balance and bucket."""
    obs_cam = prob.obs_cam.cpu().numpy()
    obs_w = prob.obs_w.cpu().numpy()
    C = prob.num_cameras

    counts = np.bincount(obs_cam[obs_w > 0], minlength=C)
    order = np.argsort(-counts)
    shard_of_cam = np.zeros(C, np.int32)
    load = np.zeros(num_shards, np.int64)
    for c in order:
        s = int(np.argmin(load))
        shard_of_cam[c] = s
        load[s] += counts[c]

    per_shard_rows = [np.where((shard_of_cam[obs_cam] == s) & (obs_w > 0))[0] for s in range(num_shards)]
    cap = max(1, max(len(r) for r in per_shard_rows))
    bucket = 256
    while bucket < cap:
        bucket *= 2
    cap = bucket

    idx = np.zeros(num_shards * cap, np.int64)
    w = np.zeros(num_shards * cap, np.float32)
    for s, rows in enumerate(per_shard_rows):
        idx[s * cap: s * cap + len(rows)] = rows
        w[s * cap: s * cap + len(rows)] = obs_w[rows]

    dev = prob.obs_w.device
    idx_t = torch.from_numpy(idx).to(dev)
    return prob._replace(
        obs_cam=prob.obs_cam[idx_t], obs_point=prob.obs_point[idx_t], obs_uv=prob.obs_uv[idx_t],
        obs_w=torch.from_numpy(w).to(dev), point_align=0)


def local_rows(prob: BAProblem, rank: int, num_shards: int) -> BAProblem:
    """Shard `rank`'s rows of a sharded problem, sorted by point (stable,
    rank-local), its padding rows (obs_w = 0) after them."""
    cap = prob.obs_w.shape[0] // num_shards
    rows = slice(rank * cap, (rank + 1) * cap)
    w, op = prob.obs_w[rows], prob.obs_point[rows]
    key = torch.where(w > 0, op.long(), torch.full_like(op, prob.num_points, dtype=torch.long))
    order = torch.argsort(key, stable=True)
    return prob._replace(obs_cam=prob.obs_cam[rows][order].contiguous(), obs_point=op[order].contiguous(),
                         obs_uv=prob.obs_uv[rows][order].contiguous(), obs_w=w[order].contiguous())


def bundle_adjust_sharded(prob: BAProblem, cfg: BAConfig, mesh: Mesh) -> tuple[BAProblem, BAStats]:
    """Sharded LM on a problem from shard_problem_by_camera (every process
    passes the same problem, on its own device); each process solves with
    its shard's rows. Returns (prob with the optimized parameters, stats),
    the same on every process. Always the PCG solver, as in sfm_tpu, whose
    dense route is single-device only; the CG steps run two all_reduces
    each (K11's point half and camera half)."""
    if prob.obs_w.shape[0] % mesh.size:
        raise ValueError(f"{prob.obs_w.shape[0]} observation rows do not split into {mesh.size} shards")
    out, stats = bundle_adjust(local_rows(prob, mesh.rank, mesh.size), cfg, group=mesh.group)
    return prob._replace(cam_params=out.cam_params, points=out.points), stats
