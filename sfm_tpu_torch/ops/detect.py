"""Scale-space keypoint detection (port of sfm_tpu/ops/detect.py).

Whole octaves are dense tensor ops over a batch of images: 3x3x3 extremum
scores (kernel K1 or its plain version), exact top-k candidate selection,
subpixel refinement as a batch of 3x3 solves, and orientation from a
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
    """Top-k over per-image score maps [B, ...]: (flat indices [B, K], scores [B, K])."""
    vals, idx = top_k_stable(score.reshape(score.shape[0], -1), k_budget)
    return idx, vals


def _gather_dog_cube(gauss_flat: torch.Tensor, L: int, H: int, W: int, b, l, y, x) -> torch.Tensor:
    """3x3x3 DoG neighbourhood around DoG voxel (l, y, x) of image b, gathered
    from the flattened GAUSSIAN stacks (dog[l] = G[l+1] - G[l]). -> [N, 3, 3, 3]."""
    dev = gauss_flat.device
    offs_l = torch.arange(-1, 3, device=dev).view(4, 1, 1)
    offs = torch.arange(-1, 2, device=dev)
    li = l[:, None, None, None] + offs_l
    yi = y[:, None, None, None] + offs.view(1, 3, 1)
    xi = x[:, None, None, None] + offs.view(1, 1, 3)
    flat_idx = ((b[:, None, None, None] * L + li) * H + yi) * W + xi
    g4 = gauss_flat[flat_idx]
    return g4[:, 1:] - g4[:, :-1]


def refine_candidates(gauss: torch.Tensor, idx: torch.Tensor, scores: torch.Tensor,
                      cfg: SiftConfig) -> OctaveKeypoints:
    """Subpixel/sublevel refinement by iterated 3D quadratic fit.

    gauss: Gaussian stacks [B, L, H, W]; idx/scores [B, K]: flat indices into
    the DoG volumes [L-1, H, W] and their scores. Returns [B*K] keypoints.
    """
    B, L, H, W = gauss.shape
    Ld = L - 1
    dev = gauss.device
    gauss_flat = gauss.reshape(-1)
    K = idx.shape[1]
    b = torch.arange(B, device=dev).repeat_interleave(K)
    idx = idx.reshape(-1)
    l = (idx // (H * W)).clamp(1, Ld - 2)
    rem = idx % (H * W)
    y = (rem // W).clamp(2, H - 3)
    x = (rem % W).clamp(2, W - 3)
    alive = scores.reshape(-1) > 0.0

    offset = torch.zeros((idx.shape[0], 3), dtype=torch.float32, device=dev)
    grad = torch.zeros_like(offset)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    for _ in range(cfg.refine_iters):
        cube = _gather_dog_cube(gauss_flat, L, H, W, b, l, y, x)
        dl = 0.5 * (cube[:, 2, 1, 1] - cube[:, 0, 1, 1])
        dy = 0.5 * (cube[:, 1, 2, 1] - cube[:, 1, 0, 1])
        dx = 0.5 * (cube[:, 1, 1, 2] - cube[:, 1, 1, 0])
        c = cube[:, 1, 1, 1]
        dll = cube[:, 2, 1, 1] + cube[:, 0, 1, 1] - 2 * c
        dyy = cube[:, 1, 2, 1] + cube[:, 1, 0, 1] - 2 * c
        dxx = cube[:, 1, 1, 2] + cube[:, 1, 1, 0] - 2 * c
        dly = 0.25 * (cube[:, 2, 2, 1] - cube[:, 2, 0, 1] - cube[:, 0, 2, 1] + cube[:, 0, 0, 1])
        dlx = 0.25 * (cube[:, 2, 1, 2] - cube[:, 2, 1, 0] - cube[:, 0, 1, 2] + cube[:, 0, 1, 0])
        dyx = 0.25 * (cube[:, 1, 2, 2] - cube[:, 1, 2, 0] - cube[:, 1, 0, 2] + cube[:, 1, 0, 0])
        Hm = torch.stack([
            torch.stack([dll, dly, dlx], -1),
            torch.stack([dly, dyy, dyx], -1),
            torch.stack([dlx, dyx, dxx], -1),
        ], -2) + 1e-6 * eye
        g = torch.stack([dl, dy, dx], -1)
        offset = -torch.linalg.solve_ex(Hm, g[..., None])[0][..., 0]
        offset = offset.clamp(-1.5, 1.5)
        grad = g
        step = torch.where(offset.abs() > 0.6, torch.sign(offset), torch.zeros_like(offset)).long()
        l = (l + step[:, 0]).clamp(1, Ld - 2)
        y = (y + step[:, 1]).clamp(2, H - 3)
        x = (x + step[:, 2]).clamp(2, W - 3)

    cube = _gather_dog_cube(gauss_flat, L, H, W, b, l, y, x)
    c = cube[:, 1, 1, 1]
    contrast = c + 0.5 * (grad * offset).sum(-1)
    converged = offset.abs().amax(-1) < 1.0

    dyy = cube[:, 1, 2, 1] + cube[:, 1, 0, 1] - 2 * c
    dxx = cube[:, 1, 1, 2] + cube[:, 1, 1, 0] - 2 * c
    dyx = 0.25 * (cube[:, 1, 2, 2] - cube[:, 1, 2, 0] - cube[:, 1, 0, 2] + cube[:, 1, 0, 0])
    tr = dxx + dyy
    det = dxx * dyy - dyx * dyx
    r = cfg.edge_threshold
    not_edge = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    good_contrast = contrast.abs() >= cfg.contrast_threshold / cfg.scales_per_octave
    valid = alive & converged & good_contrast & not_edge

    level = l.float() + offset[:, 0]
    fy = y.float() + offset[:, 1]
    fx = x.float() + offset[:, 2]
    sigma = cfg.sigma0 * torch.exp2(level / cfg.scales_per_octave)
    return OctaveKeypoints(img=b, x=fx, y=fy, level=level, sigma=sigma,
                           response=contrast.abs(), angle=torch.zeros_like(fx), valid=valid)


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
