"""K1: fused DoG + 26-neighbour extremum scores (csrc/dog_extrema.cu).

Replaces sfm_tpu/kernels/dog_extrema.py dog_extrema_scores_batch. The plain
version below is the reference the kernel is held to bit for bit; it is also
what ops/detect.extrema_score_map runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr

_MARGIN = 5


def scores_from_dog(dog: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Plain score map from DoG volumes [B, Ld, H, W]: |dog| where a voxel is
    the max or min of its 3x3x3 neighbourhood and clears +-pre_thresh, and
    lies in levels [1, Ld-2] at least 5 px from every border; else 0."""
    B, Ld, H, W = dog.shape
    vol = dog[:, None]
    wmax = F.max_pool3d(vol, 3, stride=1, padding=1)[:, 0]
    wmin = -F.max_pool3d(-vol, 3, stride=1, padding=1)[:, 0]
    is_ext = ((dog >= wmax) & (dog > pre_thresh)) | ((dog <= wmin) & (dog < -pre_thresh))
    dev = dog.device
    lev = torch.arange(Ld, device=dev).view(Ld, 1, 1)
    yy = torch.arange(H, device=dev).view(1, H, 1)
    xx = torch.arange(W, device=dev).view(1, 1, W)
    interior = ((lev >= 1) & (lev <= Ld - 2)
                & (yy >= _MARGIN) & (yy < H - _MARGIN)
                & (xx >= _MARGIN) & (xx < W - _MARGIN))
    return torch.where(is_ext & interior, dog.abs(), torch.zeros((), device=dev))


def dog_extrema_scores_plain(gauss: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Gaussian stacks [B, L, H, W] -> score maps [B, L-1, H, W]."""
    return scores_from_dog(gauss[:, 1:] - gauss[:, :-1], pre_thresh)


def dog_extrema_scores(gauss: torch.Tensor, pre_thresh: float) -> torch.Tensor:
    """Gaussian stacks [B, L, H, W] float32 -> score maps [B, L-1, H, W]."""
    if not on_cuda(gauss):
        return dog_extrema_scores_plain(gauss, pre_thresh)
    B, L, H, W = gauss.shape
    check(gauss, "gauss", torch.float32, (B, L, H, W), gauss.device)
    out = torch.empty((B, L - 1, H, W), dtype=torch.float32, device=gauss.device)
    launch("sfm_dog_extrema", "dog_extrema_scores",
           ptr(gauss), ptr(out), B, L, H, W, float(pre_thresh))
    return out
