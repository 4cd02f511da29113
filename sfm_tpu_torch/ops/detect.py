"""Scale-space keypoint detection (port of sfm_tpu/ops/detect.py).

Whole octaves are dense tensor ops over a batch of images: 3x3x3 extremum
scores (kernel K1 or its plain version), exact top-k candidate selection
(kernel K15 with its plain version in kernels/select_candidates.py;
subpixel refinement, a batch of 3x3 solves, is kernel K14 with its plain
version in kernels/subpixel_refine.py), and orientation from a
Gaussian-weighted 36-bin gradient histogram. Rejected candidates keep
valid=False (fixed-capacity padding contract).

Keypoints of a batch are flattened to one axis with an explicit image index
(`img`) wherever the JAX package vmapped over images.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels.dog_extrema import scores_from_dog
from sfm_tpu_torch.kernels.select_candidates import EMPTY, INDEX_MASK, select_keys
from sfm_tpu_torch.ops.descriptor import sample_gradients


class OctaveKeypoints(NamedTuple):
    """Candidate keypoints of one octave, octave-local coordinates. All [N]."""

    img: torch.Tensor       # image index in the batch
    x: torch.Tensor
    y: torch.Tensor
    level: torch.Tensor     # refined continuous DoG level
    sigma: torch.Tensor     # octave-relative blur
    response: torch.Tensor  # |interpolated DoG contrast|
    angle: torch.Tensor     # radians, filled by assign_orientation
    valid: torch.Tensor     # bool


def take(kps: OctaveKeypoints, index: torch.Tensor) -> OctaveKeypoints:
    return OctaveKeypoints(*(f[index] for f in kps))


def pre_threshold(cfg: SiftConfig) -> float:
    return 0.8 * cfg.contrast_threshold / cfg.scales_per_octave


def extrema_score_map(dog: torch.Tensor, cfg: SiftConfig) -> torch.Tensor:
    """Score maps [B, Ld, H, W] from DoG volumes [B, Ld, H, W]: |dog| where a
    voxel is the max/min of its 26 neighbours and clears the pre-threshold,
    in the interior only; else 0. The reference for kernel K1."""
    return scores_from_dog(dog, pre_threshold(cfg))


def top_k_stable(values: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties to the lower index first (the
    order of jax.lax.top_k; torch.topk gives no order on ties)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_candidates(score: torch.Tensor, k_budget: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over per-image score maps [B, ...] of entries >= 0 (K1's: |DoG|
    or 0): (flat indices [B, K] int64, scores [B, K] float32), exactly
    top_k_stable's (ties to the lower index; where a map has fewer than K
    positive entries, its first 0 entries in index order), as compact
    tensors in memory that follows K, not the maps: kernel K15 (or its
    plain version) selects each map's keys, a sort of [B, 3K] orders them."""
    keys = torch.full((score.shape[0], 3 * k_budget), EMPTY, dtype=torch.int64, device=score.device)
    select_keys(score, k_budget, keys)
    keys = torch.sort(keys, dim=1).values[:, :k_budget]
    bits = INDEX_MASK - torch.bitwise_right_shift(keys, 31)
    return torch.bitwise_and(keys, INDEX_MASK), bits.to(torch.int32).view(torch.float32)


_ORI_GRID_N = 13
_ORI_SPACING = 0.75
_ORI_SIGMA_W = 1.5


def assign_orientation(kps: OctaveKeypoints, dx_stack: torch.Tensor, dy_stack: torch.Tensor,
                       cfg: SiftConfig):
    """Dominant gradient orientation per keypoint, plus Lowe's second peak.

    Returns (keypoints with angle set, second angle [N], second valid [N]).
    """
    nb = cfg.num_orientation_bins
    dev = kps.x.device
    g = torch.arange(_ORI_GRID_N, dtype=torch.float32, device=dev) - (_ORI_GRID_N - 1) / 2.0
    vv, uu = torch.meshgrid(g, g, indexing="ij")
    lattice = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1) * _ORI_SPACING
    w_gauss = torch.exp(-(lattice**2).sum(-1) / (2.0 * _ORI_SIGMA_W**2))

    off_x = lattice[None, :, 0] * kps.sigma[:, None]
    off_y = lattice[None, :, 1] * kps.sigma[:, None]
    gx, gy = sample_gradients(dx_stack, dy_stack, kps, off_x, off_y)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ang = torch.atan2(gy, gx)

    binf = (ang / (2.0 * torch.pi) * nb) % nb
    b0 = torch.floor(binf)
    frac = binf - b0
    bins = torch.arange(nb, dtype=torch.float32, device=dev)
    w = mag * w_gauss[None, :]
    d0 = (bins[None, None, :] - b0[..., None]) % nb
    zero = torch.zeros((), device=dev)
    contrib = torch.where(d0 == 0, 1.0 - frac[..., None], torch.where(d0 == 1, frac[..., None], zero))
    hist = (w[..., None] * contrib).sum(1)

    for _ in range(2):
        hist = (6.0 * hist
                + 4.0 * (torch.roll(hist, 1, -1) + torch.roll(hist, -1, -1))
                + (torch.roll(hist, 2, -1) + torch.roll(hist, -2, -1))) / 16.0

    def peak_angle(h, peak):
        hp = torch.gather(h, 1, peak[:, None])[:, 0]
        hl = torch.gather(h, 1, ((peak - 1) % nb)[:, None])[:, 0]
        hr = torch.gather(h, 1, ((peak + 1) % nb)[:, None])[:, 0]
        denom = hl - 2.0 * hp + hr
        interp = torch.where(denom.abs() > 1e-9, 0.5 * (hl - hr) / denom, zero)
        angle = ((peak.float() + interp) / nb) * 2.0 * torch.pi
        return torch.where(angle > torch.pi, angle - 2.0 * torch.pi, angle), hp

    peak1 = torch.argmax(hist, dim=-1)
    angle1, h1 = peak_angle(hist, peak1)

    is_local_peak = (hist >= torch.roll(hist, 1, -1)) & (hist >= torch.roll(hist, -1, -1))
    masked = torch.where(is_local_peak, hist, torch.full((), -1.0, device=dev))
    cols = torch.arange(nb, device=dev)[None, :]
    masked = torch.where(cols == peak1[:, None], torch.full((), -1.0, device=dev), masked)
    peak2 = torch.argmax(masked, dim=-1)
    angle2, h2 = peak_angle(hist, peak2)
    valid2 = (h2 >= cfg.orientation_peak_ratio * h1) & (torch.gather(masked, 1, peak2[:, None])[:, 0] > 0)
    return kps._replace(angle=angle1), angle2, valid2
