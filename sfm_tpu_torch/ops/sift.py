"""SIFT feature extraction: images -> fixed-budget keypoints + descriptors
(port of sfm_tpu/ops/sift.py extract_features).

Batched over images [B, H, W]; per octave: pyramid level stacks, extremum
scores (kernel K1 when cfg.use_pallas), exact top-k candidates, refinement,
compaction to the per-octave descriptor budget, orientation (with Lowe's
second-peak duplicates) and descriptors (kernel K12 on the card). Output
obeys the padding contract: exactly cfg.max_keypoints slots per image with
a validity mask. The parts run inside the spans sift.pyramid, sift.detect,
sift.orientation and sift.descriptors (utils/logging.span), one of each per
octave; the pyramid's build and the final cross-octave selection have spans
of their own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels.dog_extrema import dog_extrema_scores
from sfm_tpu_torch.kernels.sift_descriptors import sift_descriptors
from sfm_tpu_torch.ops import pyramid as pyr
from sfm_tpu_torch.ops.detect import (
    OctaveKeypoints, assign_orientation, extrema_score_map, pre_threshold,
    refine_candidates, select_candidates, take, top_k_stable,
)
from sfm_tpu_torch.utils.logging import span


class Features(NamedTuple):
    """Per-image feature sets, fixed budget N = cfg.max_keypoints."""

    xy: torch.Tensor        # [B, N, 2] pixel coords in the canvas
    sigma: torch.Tensor     # [B, N]
    angle: torch.Tensor     # [B, N]
    response: torch.Tensor  # [B, N]
    desc: torch.Tensor      # [B, N, 128] L2-normalized
    valid: torch.Tensor     # [B, N] bool


def _octave_scores(stack: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    if cfg.use_pallas:
        return dog_extrema_scores(stack, pre_threshold(cfg))
    return extrema_score_map(stack[:, 1:] - stack[:, :-1], cfg)


def extract_features(images: torch.Tensor, cfg: SiftConfig,
                     valid_hw: torch.Tensor | None = None) -> Features:
    """images: [B, H, W] float32 grayscale in [0, 1]; valid_hw: optional
    [B, 2] (height, width) of the un-padded content of each canvas."""
    B = images.shape[0]
    with span("sift.pyramid"):
        octaves = pyr.build_pyramid(images, cfg)
    factor0 = 0.5 if cfg.upsample_first_octave else 1.0   # octave 0 pixels -> canvas pixels
    k_budget = max(cfg.max_candidates // cfg.num_octaves, 32)
    per_oct = []
    for o, stack in enumerate(octaves):
        with span("sift.pyramid"):
            dx, dy = pyr.pyramid_gradients(stack)
        _, L, H, W = stack.shape
        k_this = min(k_budget, (L - 1) * H * W)
        desc_budget = min(cfg.desc_per_octave, k_this)

        with span("sift.detect"):
            idx, scores = select_candidates(_octave_scores(stack, cfg), k_this)
            kps = refine_candidates(stack, idx, scores, cfg)               # [B * k_this]
            # Compact to the survivors before orientation and descriptors.
            sc = torch.where(kps.valid, kps.response, torch.full((), -1.0, device=images.device))
            _, keep = top_k_stable(sc.reshape(B, k_this), desc_budget)
            keep = (keep + torch.arange(B, device=images.device)[:, None] * k_this).reshape(-1)
            kps = take(kps, keep)                                          # [B * desc_budget]
        with span("sift.orientation"):
            kps, angle2, valid2 = assign_orientation(kps, dx, dy, cfg)
            if cfg.multi_orientation:
                second = kps._replace(angle=angle2, valid=kps.valid & valid2)
                kps = OctaveKeypoints(*(
                    torch.cat([a.reshape(B, -1), b.reshape(B, -1)], 1).reshape(-1)
                    for a, b in zip(kps, second)))
        with span("sift.descriptors"):
            desc = sift_descriptors(kps, dx, dy, cfg)
            scale = factor0 * 2.0**o
            per_oct.append(dict(
                xy=torch.stack([kps.x, kps.y], -1).reshape(B, -1, 2) * scale,
                sigma=(kps.sigma * scale).reshape(B, -1),
                angle=kps.angle.reshape(B, -1),
                response=kps.response.reshape(B, -1),
                desc=desc.reshape(B, -1, desc.shape[-1]),
                valid=kps.valid.reshape(B, -1),
            ))

    with span("sift.detect"):
        cat = {k: torch.cat([p[k] for p in per_oct], dim=1) for k in per_oct[0]}
        if valid_hw is not None:
            margin = 1.0
            hw = valid_hw.to(cat["xy"].dtype)
            inside = ((cat["xy"][..., 0] >= margin) & (cat["xy"][..., 0] < hw[:, None, 1] - margin)
                      & (cat["xy"][..., 1] >= margin) & (cat["xy"][..., 1] < hw[:, None, 0] - margin))
            cat["valid"] = cat["valid"] & inside

        score = torch.where(cat["valid"], cat["response"], torch.full((), -1.0, device=images.device))
        n = min(cfg.max_keypoints, score.shape[1])
        top_scores, top = top_k_stable(score, n)

        def gather(a):
            if a.dim() > 2:
                return torch.gather(a, 1, top[..., None].expand(-1, -1, a.shape[-1]))
            return torch.gather(a, 1, top)

        return Features(
            xy=gather(cat["xy"]),
            sigma=gather(cat["sigma"]),
            angle=gather(cat["angle"]),
            response=gather(cat["response"]),
            desc=gather(cat["desc"]),
            valid=gather(cat["valid"]) & (top_scores > 0),
        )
