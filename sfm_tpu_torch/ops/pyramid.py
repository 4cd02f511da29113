"""Gaussian scale-space pyramid (port of sfm_tpu/ops/pyramid.py).

A Gaussian blur of a whole image is two banded-Toeplitz matrix products,
blurred = T @ img @ T^T, with reflect boundaries baked into the band; every
level of an octave is blurred directly from the octave base. On the card
kernel K13 (kernels/blur_levels.py) makes an octave's levels in one launch
from T's band; on the CPU the products are plain fp32 ``torch.matmul``
(TF32 is off package-wide).

Octave o, level i has blur sigma0 * 2^(o + i/s); each next octave starts by
2x-decimating level s of the previous one (Lowe). With
cfg.upsample_first_octave the first octave is the image upsampled 2x
(bilinear, half-pixel centres, edges clamped: jax.image.resize's
"bilinear" at a factor of 2), carrying twice the assumed blur.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels.blur_levels import blur_levels


def downsample2(images: torch.Tensor) -> torch.Tensor:
    return images[..., ::2, ::2]


def build_pyramid(images: torch.Tensor, cfg: SiftConfig) -> list[torch.Tensor]:
    """images [B, H, W] float32 in [0, 1] -> per octave [B, L, H_o, W_o]
    Gaussian stacks, L = scales_per_octave + 3."""
    s = cfg.scales_per_octave
    num_levels = s + 3
    k = 2.0 ** (1.0 / s)

    def deltas(from_sigma: float) -> tuple[float, ...]:
        return tuple(math.sqrt(max((cfg.sigma0 * k**i) ** 2 - from_sigma**2, 0.0))
                     for i in range(num_levels))

    current = images
    current_sigma = cfg.assumed_blur
    if cfg.upsample_first_octave:
        current = torch.nn.functional.interpolate(images[:, None], scale_factor=2.0, mode="bilinear",
                                                  align_corners=False)[:, 0]
        current_sigma = cfg.assumed_blur * 2.0
    octaves = []
    for _ in range(cfg.num_octaves):
        stack = blur_levels(current, deltas(current_sigma))
        octaves.append(stack)
        current = downsample2(stack[:, s])
        current_sigma = cfg.sigma0
    return octaves


def pyramid_gradients(stack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference (wrap-around) gradients of [B, L, H, W] -> (dx, dy)."""
    return _central_difference(stack, -1), _central_difference(stack, -2)


def _central_difference(stack: torch.Tensor, dim: int) -> torch.Tensor:
    """0.5 * (roll(stack, -1, dim) - roll(stack, 1, dim)), the same ops on
    the same values, without the two rolled copies: the interior from two
    shifted views, the two wrapped ends from the opposite edges (a side of
    one entry has no two ends)."""
    n = stack.shape[dim]
    if n == 1:
        return 0.5 * (torch.roll(stack, -1, dims=dim) - torch.roll(stack, 1, dims=dim))
    out = torch.empty_like(stack)
    torch.sub(stack.narrow(dim, 2, n - 2), stack.narrow(dim, 0, n - 2), out=out.narrow(dim, 1, n - 2))
    torch.sub(stack.narrow(dim, 1, 1), stack.narrow(dim, n - 1, 1), out=out.narrow(dim, 0, 1))
    torch.sub(stack.narrow(dim, 0, 1), stack.narrow(dim, n - 2, 1), out=out.narrow(dim, n - 1, 1))
    return out.mul_(0.5)
