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
# The match stage keeps the descriptors and keypoints of every image on the
# device below this size (sfm_tpu's _DEVICE_FEATURE_CACHE_BYTES): 6 GiB holds
# about 3,000 images of 4,096 keypoints in fp32.
_DEVICE_FEATURE_CACHE_BYTES = 6 << 30


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
    desc, valid, xy = feats.desc[:, :N_eff], feats.valid[:, :N_eff], feats.xy[:, :N_eff]
    intr = intrinsics.astype(np.float32)
    # Each image takes part in O(N) pairs: below _DEVICE_FEATURE_CACHE_BYTES
    # its features go to the device once and each pair block gathers them
    # there; above it each pair block is sliced on the host and moved.
    on_device = desc.nbytes + xy.nbytes <= _DEVICE_FEATURE_CACHE_BYTES
    if on_device:
        desc_all, valid_all, xy_all, intr_all = (
            torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (desc, valid, xy, intr))

    for s in range(0, E, P):
        e = min(s + P, E)
        if on_device:
            bi = torch.from_numpy(pairs[s:e, 0].astype(np.int64)).to(device)
            bj = torch.from_numpy(pairs[s:e, 1].astype(np.int64)).to(device)
            di, vi, dj, vj = desc_all[bi], valid_all[bi], desc_all[bj], valid_all[bj]
            xy_i, xy_j, intr_i, intr_j = xy_all[bi], xy_all[bj], intr_all[bi], intr_all[bj]
        else:
            bi, bj = pairs[s:e, 0], pairs[s:e, 1]
            di, vi, dj, vj, xy_i, xy_j, intr_i, intr_j = (
                torch.from_numpy(a).to(device)
                for a in (desc[bi], valid[bi], desc[bj], valid[bj], xy[bi], xy[bj], intr[bi], intr[bj]))
        pm = match_block(di, vi, dj, vj, cfg.match)
        uv_i = torch.gather(xy_i, 1, pm.idx_i.long()[..., None].expand(-1, -1, 2))
        uv_j = torch.gather(xy_j, 1, pm.idx_j.long()[..., None].expand(-1, -1, 2))
        geom = verify_block(s, uv_i, uv_j, pm.valid, intr_i, intr_j, cfg.ransac, seed)

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
