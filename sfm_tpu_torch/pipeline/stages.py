"""Stage drivers (port of sfm_tpu/pipeline/stages.py, single device,
unguided): feature extraction over image chunks, exhaustive pairs, and
match + verification over pair blocks. Stages return plain numpy for the
host bookkeeping between them.

Divergences from the JAX package: the last image chunk and the last pair
block are not padded to a fixed size (that padding only fixed jit shapes);
outputs are the same per image and per pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.ops.match import match_block
from sfm_tpu_torch.ops.sift import extract_features
from sfm_tpu_torch.ops.verify import verify_block
from sfm_tpu_torch.pipeline.ingest import ImageBatch

_FEATURE_CHUNK = 8  # images per device batch in the feature stage


@dataclass
class FeatureSet:
    """Host-side features for all images (canvas pixel coords)."""

    xy: np.ndarray        # [B, N, 2]
    sigma: np.ndarray     # [B, N]
    angle: np.ndarray     # [B, N]
    response: np.ndarray  # [B, N]
    desc: np.ndarray      # [B, N, 128]
    valid: np.ndarray     # [B, N]


@dataclass
class MatchGraph:
    """Verified match graph: edges + two-view geometry."""

    pairs: np.ndarray          # [E, 2] image indices (i < j)
    idx_i: np.ndarray          # [E, M] keypoint indices in image i
    idx_j: np.ndarray          # [E, M]
    inlier: np.ndarray         # [E, M] bool (geometric inliers)
    num_inliers: np.ndarray    # [E]
    num_h_inliers: np.ndarray  # [E]
    rvec: np.ndarray           # [E, 3] relative pose i->j
    tvec: np.ndarray           # [E, 3]
    ok: np.ndarray             # [E] bool
    pose_ok: np.ndarray | None = None  # [E] bool; False = correspondence-only edge


def extract_stage(batch: ImageBatch, cfg: PipelineConfig, device: torch.device) -> FeatureSet:
    B = batch.canvases.shape[0]
    outs = []
    for s in range(0, B, _FEATURE_CHUNK):
        e = min(s + _FEATURE_CHUNK, B)
        f = extract_features(torch.from_numpy(batch.canvases[s:e]).to(device), cfg.sift,
                             torch.from_numpy(batch.valid_hw[s:e]).to(device))
        outs.append([a.cpu().numpy() for a in f])
    cat = [np.concatenate([o[k] for o in outs]) for k in range(6)]
    return FeatureSet(*cat)


def _bucket_keypoints(n: int, cap: int) -> int:
    """Power-of-2 keypoint-axis bucket in [512, cap] covering n."""
    b = 512
    while b < n:
        b *= 2
    return min(b, cap)


def exhaustive_pairs(num_images: int) -> np.ndarray:
    """All N(N-1)/2 pairs (i < j)."""
    ii, jj = np.triu_indices(num_images, k=1)
    return np.stack([ii, jj], axis=1).astype(np.int32)


def match_and_verify_stage(feats: FeatureSet, pairs: np.ndarray, intrinsics: np.ndarray,
                           cfg: PipelineConfig, device: torch.device, seed: int = 0) -> MatchGraph:
    """Match + geometric verification over pair blocks. Each pair's RANSAC
    draws are keyed by its global pair index, so results do not depend on
    the block size."""
    if cfg.match.guided:
        raise NotImplementedError(
            "match.guided is not ported yet (ROADMAP.md queue 1 item 4: guided matching)")
    E = len(pairs)
    P = cfg.match.block_pairs
    M = cfg.match.max_matches
    out_idx_i = np.zeros((E, M), np.int32)
    out_idx_j = np.zeros((E, M), np.int32)
    out_inlier = np.zeros((E, M), bool)
    out_ninl = np.zeros(E, np.int32)
    out_nh = np.zeros(E, np.int32)
    out_rvec = np.zeros((E, 3), np.float32)
    out_tvec = np.zeros((E, 3), np.float32)
    out_ok = np.zeros(E, bool)
    out_pose_ok = np.zeros(E, bool)

    # Keypoints are response-sorted with validity masks: bucket the keypoint
    # axis down to the occupancy (power of 2, floor 512); indices are
    # prefix-stable.
    N_eff = _bucket_keypoints(int(feats.valid.sum(axis=1).max()), feats.valid.shape[1])
    desc_all = torch.from_numpy(feats.desc[:, :N_eff]).to(device)
    valid_all = torch.from_numpy(feats.valid[:, :N_eff]).to(device)
    xy_all = torch.from_numpy(feats.xy[:, :N_eff]).to(device)
    intr_all = torch.from_numpy(intrinsics.astype(np.float32)).to(device)

    for s in range(0, E, P):
        e = min(s + P, E)
        bi = torch.from_numpy(pairs[s:e, 0].astype(np.int64)).to(device)
        bj = torch.from_numpy(pairs[s:e, 1].astype(np.int64)).to(device)
        pm = match_block(desc_all[bi], valid_all[bi], desc_all[bj], valid_all[bj], cfg.match)
        uv_i = torch.gather(xy_all[bi], 1, pm.idx_i.long()[..., None].expand(-1, -1, 2))
        uv_j = torch.gather(xy_all[bj], 1, pm.idx_j.long()[..., None].expand(-1, -1, 2))
        geom = verify_block(s, uv_i, uv_j, pm.valid, intr_all[bi], intr_all[bj], cfg.ransac, seed)

        out_idx_i[s:e] = pm.idx_i.cpu().numpy()
        out_idx_j[s:e] = pm.idx_j.cpu().numpy()
        out_inlier[s:e] = geom.inliers.cpu().numpy()
        out_ninl[s:e] = geom.num_inliers.cpu().numpy()
        out_nh[s:e] = geom.num_h_inliers.cpu().numpy()
        out_rvec[s:e] = geom.rvec.cpu().numpy()
        out_tvec[s:e] = geom.tvec.cpu().numpy()
        out_ok[s:e] = geom.ok.cpu().numpy()
        out_pose_ok[s:e] = geom.pose_ok.cpu().numpy()

    enough = out_ninl >= cfg.ransac.min_inliers
    return MatchGraph(
        pairs=pairs, idx_i=out_idx_i, idx_j=out_idx_j, inlier=out_inlier,
        num_inliers=out_ninl, num_h_inliers=out_nh,
        rvec=out_rvec, tvec=out_tvec, ok=out_ok & enough,
        pose_ok=out_pose_ok & enough,
    )
