"""Bilinear sampling from image stacks (port of sfm_tpu/ops/interp.py).

Callers pass stacks flattened to [planes, H, W] (plane = image * levels +
level), so one gather serves every keypoint of a batch of images.
"""

from __future__ import annotations

import torch


def bilinear_sample_stack(stack: torch.Tensor, plane: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample stack [N, H, W] at integer plane index [...] and positions
    xy [..., 2] (x, y). Out-of-bounds positions clamp to the border."""
    N, H, W = stack.shape
    flat = stack.reshape(N * H, W)
    x = xy[..., 0].clamp(0.0, W - 1.000001)
    y = xy[..., 1].clamp(0.0, H - 1.000001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = (x0 + 1).clamp_max(W - 1)
    y1 = (y0 + 1).clamp_max(H - 1)
    fx = x - x0
    fy = y - y0
    base = plane.long() * H
    r0 = base + y0
    r1 = base + y1
    v00 = flat[r0, x0]
    v01 = flat[r0, x1]
    v10 = flat[r1, x0]
    v11 = flat[r1, x1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)
