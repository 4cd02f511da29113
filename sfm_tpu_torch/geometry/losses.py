"""Robust losses for bundle adjustment (port of sfm_tpu/geometry/losses.py).

rho(s) with s the squared residual norm; BA scales residuals and Jacobian
blocks by sqrt(rho'(s)) (IRLS), exact for the Gauss-Newton approximation.
"""

from __future__ import annotations

import torch


def huber(s: torch.Tensor, scale: float) -> torch.Tensor:
    d2 = scale * scale
    return torch.where(s <= d2, s, 2.0 * scale * torch.sqrt(s.clamp_min(1e-20)) - d2)


def cauchy(s: torch.Tensor, scale: float) -> torch.Tensor:
    d2 = scale * scale
    return d2 * torch.log1p(s / d2)


def robust_weight(s: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    """IRLS weight rho'(s)."""
    if loss == "none":
        return torch.ones_like(s)
    if loss == "huber":
        d2 = scale * scale
        return torch.where(s <= d2, torch.ones_like(s), scale / torch.sqrt(s.clamp_min(1e-20)))
    if loss == "cauchy":
        d2 = scale * scale
        return 1.0 / (1.0 + s / d2)
    raise ValueError(f"unknown robust loss: {loss}")


def robust_cost(s: torch.Tensor, loss: str, scale: float) -> torch.Tensor:
    if loss == "none":
        return s
    if loss == "huber":
        return huber(s, scale)
    if loss == "cauchy":
        return cauchy(s, scale)
    raise ValueError(f"unknown robust loss: {loss}")
