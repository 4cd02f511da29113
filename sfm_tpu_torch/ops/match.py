"""Pairwise descriptor matching (port of sfm_tpu/ops/match.py).

The 128-D L2 nearest-neighbour search is a Gram product: d(i, j) =
|a_i|^2 + |b_j|^2 - 2 a_i.b_j, with the cross term in bf16 and fp32
accumulation. Lowe's ratio test on the two nearest neighbours, a mutual
check, and compaction of the survivors to the static budget
cfg.max_matches, best distance first. Every function takes a leading
pair axis [P, ...].

Two paths: ``match_pair`` materializes the [P, N1, N2] distance matrix
(the reference); ``match_pair_kernel`` runs kernel K2 (top-2 per row, no
distance matrix) twice, the second time with the operands swapped for the
mutual check. cfg.use_pallas selects the kernel path.

``guided_match_pair`` re-matches a verified pair inside the epipolar band
of its E (materialized matrices, as in the JAX package, which runs no
kernel there either); ``guided_match_block`` takes its pairs in slices of
at most _GUIDED_SLICE_BYTES per [P, N1, N2] fp32 matrix (32 pairs of 4096
keypoints would be 2.1 GB each, and the gate holds several).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import MatchConfig
from sfm_tpu_torch.geometry.cameras import pixel_to_camera
from sfm_tpu_torch.kernels.match_topk import BIG, match_topk2
from sfm_tpu_torch.ops.detect import top_k_stable


class PairMatches(NamedTuple):
    """Correspondences for a block of image pairs, fixed budget M."""

    idx_i: torch.Tensor   # [P, M] keypoint index in image i
    idx_j: torch.Tensor   # [P, M] keypoint index in image j
    valid: torch.Tensor   # [P, M] bool


def descriptor_distances(da: torch.Tensor, db: torch.Tensor, use_bf16: bool) -> torch.Tensor:
    """Squared L2 distances [P, Na, Nb] between unit-norm descriptor sets."""
    if use_bf16:
        gram = da.to(torch.bfloat16).float() @ db.to(torch.bfloat16).float().transpose(1, 2)
    else:
        gram = da @ db.transpose(1, 2)
    na = (da * da).sum(-1, keepdim=True)
    nb = (db * db).sum(-1, keepdim=True)
    return (na + nb.transpose(1, 2) - 2.0 * gram).clamp_min(0.0)


def _compact(d1, nn, ok, M: int):
    """Top-M accepted rows by distance -> (idx_a, idx_b, valid), padded to M."""
    score = torch.where(ok, -d1, torch.full((), -BIG, device=d1.device))
    top_scores, idx_a = top_k_stable(score, min(M, score.shape[1]))
    idx_b = torch.gather(nn, 1, idx_a)
    valid = top_scores > -BIG / 2
    pad = M - idx_a.shape[1]
    if pad > 0:
        idx_a = torch.nn.functional.pad(idx_a, (0, pad))
        idx_b = torch.nn.functional.pad(idx_b, (0, pad))
        valid = torch.nn.functional.pad(valid, (0, pad))
    return idx_a.to(torch.int32), idx_b.to(torch.int32), valid


def match_pair(da, va, db, vb, cfg: MatchConfig):
    """Reference matcher on the materialized distance matrix:
    da [P, N1, 128], va [P, N1] bool, db/vb likewise -> (idx_a, idx_b, valid) [P, M]."""
    d = descriptor_distances(da, db, cfg.use_bf16_matmul)
    d = torch.where(va[:, :, None] & vb[:, None, :], d, torch.full((), BIG, device=d.device))
    neg2, idx2 = top_k_stable(-d, 2)
    d1, d2 = -neg2[..., 0], -neg2[..., 1]
    nn = idx2[..., 0]
    ok = (d1 < BIG / 2) & (d1 < cfg.ratio_threshold**2 * d2) & va
    if cfg.mutual_check:
        nn_back = torch.argmin(d, dim=1)                        # best a for each b
        ar = torch.arange(d.shape[1], device=d.device)
        ok = ok & (torch.gather(nn_back, 1, nn) == ar)
    return _compact(d1, nn, ok, cfg.max_matches)


def match_pair_kernel(da, va, db, vb, cfg: MatchConfig):
    """Same contract as match_pair through kernel K2 (bf16 norms in d1)."""
    d1, d2, nn = match_topk2(da, db, vb)
    nn = nn.long()
    ok = (d1 < BIG / 2) & (d1 < cfg.ratio_threshold**2 * d2) & va
    if cfg.mutual_check:
        _, _, nn_back = match_topk2(db, da, va)
        ar = torch.arange(da.shape[1], device=da.device)
        ok = ok & (torch.gather(nn_back.long(), 1, nn) == ar)
    return _compact(d1, nn, ok, cfg.max_matches)


def guided_match_pair(da, va, xy_a, db, vb, xy_b, E, intr_a, intr_b, cfg: MatchConfig):
    """Guided matching: candidates restricted to pairs whose Sampson error
    under the verified E [P, 3, 3] is inside cfg.guided_band_px, a relaxed
    ratio test (unambiguous singles accepted) and the mutual check.
    xy [P, N, 2] pixels, intr [P, 6] -> (idx_a, idx_b, valid) [P, M]."""
    x1 = pixel_to_camera(xy_a, intr_a[:, None, :])
    x2 = pixel_to_camera(xy_b, intr_b[:, None, :])
    x1h = torch.cat([x1, torch.ones_like(x1[..., :1])], -1)     # [P, N1, 3]
    x2h = torch.cat([x2, torch.ones_like(x2[..., :1])], -1)     # [P, N2, 3]
    l1 = x1h @ E.transpose(1, 2)                                # E x1   [P, N1, 3]
    l2 = x2h @ E                                                # E^T x2 [P, N2, 3]
    num = (l1 @ x2h.transpose(1, 2)) ** 2                       # [P, N1, N2]
    den = (l1[..., 0] ** 2 + l1[..., 1] ** 2)[:, :, None] + (l2[..., 0] ** 2 + l2[..., 1] ** 2)[:, None, :]
    sampson = num / den.clamp_min(1e-12)
    f = (intr_a[:, 0] + intr_a[:, 1] + intr_b[:, 0] + intr_b[:, 1]) * 0.25
    gate = sampson < ((cfg.guided_band_px / f) ** 2)[:, None, None]

    d = descriptor_distances(da, db, cfg.use_bf16_matmul)
    d = torch.where(gate & va[:, :, None] & vb[:, None, :], d, torch.full((), BIG, device=d.device))
    neg2, idx2 = top_k_stable(-d, 2)
    d1, d2 = -neg2[..., 0], -neg2[..., 1]
    nn = idx2[..., 0]
    ok = (d1 < BIG / 2) & ((d1 < cfg.guided_ratio**2 * d2) | (d2 > BIG / 2)) & va
    nn_back = torch.argmin(d, dim=1)
    ar = torch.arange(d.shape[1], device=d.device)
    ok = ok & (torch.gather(nn_back, 1, nn) == ar)
    return _compact(d1, nn, ok, cfg.max_matches)


_GUIDED_SLICE_BYTES = 512 << 20


def guided_match_block(desc_i, valid_i, xy_i, desc_j, valid_j, xy_j, E, intr_i, intr_j,
                       cfg: MatchConfig) -> PairMatches:
    """guided_match_pair over a block of pairs, in slices of pairs."""
    P, N1, N2 = desc_i.shape[0], desc_i.shape[1], desc_j.shape[1]
    step = max(1, _GUIDED_SLICE_BYTES // (4 * N1 * N2))
    outs = [guided_match_pair(desc_i[s:s + step], valid_i[s:s + step], xy_i[s:s + step],
                              desc_j[s:s + step], valid_j[s:s + step], xy_j[s:s + step],
                              E[s:s + step], intr_i[s:s + step], intr_j[s:s + step], cfg)
            for s in range(0, P, step)]
    return PairMatches(*(torch.cat(t) for t in zip(*outs)))


def match_block(desc_i, valid_i, desc_j, valid_j, cfg: MatchConfig) -> PairMatches:
    """Match a block of pairs: desc [P, N, 128], valid [P, N]."""
    fn = match_pair_kernel if cfg.use_pallas else match_pair
    return PairMatches(*fn(desc_i, valid_i, desc_j, valid_j, cfg))
