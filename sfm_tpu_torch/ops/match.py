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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import MatchConfig
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


def match_block(desc_i, valid_i, desc_j, valid_j, cfg: MatchConfig) -> PairMatches:
    """Match a block of pairs: desc [P, N, 128], valid [P, N]."""
    fn = match_pair_kernel if cfg.use_pallas else match_pair
    return PairMatches(*fn(desc_i, valid_i, desc_j, valid_j, cfg))
