"""Gaussian scale-space pyramid (port of sfm_tpu/ops/pyramid.py).

A Gaussian blur of a whole image is two banded-Toeplitz matrix products,
blurred = T @ img @ T^T, with reflect boundaries baked into the band; every
level of an octave is blurred directly from the octave base. The products
are plain fp32 ``torch.matmul`` (TF32 is off package-wide).

Octave o, level i has blur sigma0 * 2^(o + i/s); each next octave starts by
2x-decimating level s of the previous one (Lowe). With
cfg.upsample_first_octave the first octave is the image upsampled 2x
(bilinear, half-pixel centres, edges clamped: jax.image.resize's
"bilinear" at a factor of 2), carrying twice the assumed blur.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.utils.logging import span


def gaussian_kernel1d(sigma: float) -> np.ndarray:
    """Odd-width normalized Gaussian; width = 2*ceil(4*sigma)+1."""
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=256)
def _toeplitz_blur(n: int, sigma_q: int) -> np.ndarray:
    """Banded blur operator [n, n] with reflect boundaries; sigma is
    quantized to 1e-4 (sigma_q = round(sigma * 1e4))."""
    sigma = sigma_q / 1e4
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    idx = np.arange(n)
    T = np.zeros((n, n), np.float32)
    for o, w in zip(range(-r, r + 1), k):
        j = idx + o
        j = np.where(j < 0, -j, j)
        j = np.where(j >= n, 2 * (n - 1) - j, j)
        np.add.at(T, (idx, j), w)
    return T


def _blur_levels(base: torch.Tensor, sigmas: tuple[float, ...]) -> torch.Tensor:
    """All octave levels from the base: base [B, S, S] -> [B, L, S, S]."""
    B, H, W = base.shape
    if H != W:
        raise ValueError("ingest pads to square canvases")
    with span("sift.pyramid.constants", h2d_bytes=len(sigmas) * H * H * 4):
        Ts = np.stack([
            np.eye(H, dtype=np.float32) if s <= 0 else _toeplitz_blur(H, int(round(s * 1e4)))
            for s in sigmas
        ])
        T = torch.from_numpy(Ts).to(base.device)
    return torch.matmul(torch.matmul(T[None], base[:, None]), T.transpose(1, 2)[None])


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
        stack = _blur_levels(current, deltas(current_sigma))
        octaves.append(stack)
        current = downsample2(stack[:, s])
        current_sigma = cfg.sigma0
    return octaves


def pyramid_gradients(stack: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference (wrap-around) gradients of [B, L, H, W] -> (dx, dy)."""
    dx = 0.5 * (torch.roll(stack, -1, dims=-1) - torch.roll(stack, 1, dims=-1))
    dy = 0.5 * (torch.roll(stack, -1, dims=-2) - torch.roll(stack, 1, dims=-2))
    return dx, dy
