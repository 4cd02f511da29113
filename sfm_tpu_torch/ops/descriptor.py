"""SIFT 128-D descriptors (port of sfm_tpu/ops/descriptor.py).

Every keypoint samples the same 16x16 lattice in its rotated, sigma-scaled
frame. The lattice is axis-aligned with the 4x4 cell grid, so the spatial
bilinear weights are constants ([256, 16]) and histogram accumulation is
one contraction; only the 8-bin orientation soft-binning depends on data:

    desc[k, cell, ori] = sum_p W_spatial[p, cell] * (mag * w_gauss)[k, p] * W_ori[k, p, ori]
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.ops.interp import bilinear_sample_stack
from sfm_tpu_torch.utils.logging import span

_NUM_CELLS = 4
_NUM_ORI = 8
_SAMPLES = 16
_CELL_SIGMA = 3.0
_DESC_CLIP = 0.2


def _lattice_and_weights() -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Static sample lattice (cell units), Gaussian window, spatial weights."""
    step = _NUM_CELLS / _SAMPLES
    coords = (np.arange(_SAMPLES) + 0.5) * step - _NUM_CELLS / 2.0
    uu, vv = np.meshgrid(coords, coords, indexing="xy")
    lattice = np.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    w_gauss = np.exp(-np.sum(lattice**2, -1) / (2.0 * (_NUM_CELLS / 2.0) ** 2))
    centers = np.arange(_NUM_CELLS) - (_NUM_CELLS - 1) / 2.0
    wx = np.maximum(0.0, 1.0 - np.abs(lattice[:, 0:1] - centers[None, :]))
    wy = np.maximum(0.0, 1.0 - np.abs(lattice[:, 1:2] - centers[None, :]))
    w_spatial = (wy[:, :, None] * wx[:, None, :]).reshape(-1, _NUM_CELLS * _NUM_CELLS)
    return lattice.astype(np.float32), w_gauss.astype(np.float32), w_spatial.astype(np.float32)


_LATTICE, _W_GAUSS, _W_SPATIAL = _lattice_and_weights()
_TABLE_BYTES = _LATTICE.nbytes + _W_GAUSS.nbytes + _W_SPATIAL.nbytes  # uploaded by every call

_WIN = 64  # sampling window (covers ~8*sigma at sigma <= 3.9)


def sample_gradients_windowed(dx_stack, dy_stack, img, level, x, y, off_x, off_y):
    """Sample both gradient channels at per-keypoint lattice offsets through
    one contiguous [64, 64] window per keypoint and separable bilinear
    weight matrices: sample[k, p] = wy[k, p, :] @ win[k] @ wx[k, p, :].
    Equal to 4-tap bilinear sampling for any patch inside the window.

    dx_stack/dy_stack [B, L, H, W]; img/level/x/y [N]; off_x/off_y [N, P].
    """
    B, L, H, Wd = dx_stack.shape
    dev = dx_stack.device
    half = _WIN // 2
    glev = torch.round(level).long().clamp(0, L - 1)
    x0 = (torch.round(x).long() - half).clamp(0, max(Wd - _WIN, 0))
    y0 = (torch.round(y).long() - half).clamp(0, max(H - _WIN, 0))
    ar = torch.arange(_WIN, device=dev)
    rows = (y0[:, None] + ar)[:, :, None]
    cols = (x0[:, None] + ar)[:, None, :]
    bi = img[:, None, None]
    li = glev[:, None, None]
    win_gx = dx_stack[bi, li, rows, cols]
    win_gy = dy_stack[bi, li, rows, cols]

    px = (x[:, None] + off_x - x0[:, None].float()).clamp(0.0, _WIN - 1.000001)
    py = (y[:, None] + off_y - y0[:, None].float()).clamp(0.0, _WIN - 1.000001)
    grid = ar.float()
    wx = (1.0 - (px[..., None] - grid).abs()).clamp_min(0.0)
    wy = (1.0 - (py[..., None] - grid).abs()).clamp_min(0.0)

    def samp(win):
        return (torch.bmm(wy, win) * wx).sum(-1)

    return samp(win_gx), samp(win_gy)


def sample_gradients(dx_stack, dy_stack, kps, off_x, off_y):
    """Gradients at per-keypoint lattice offsets off_x/off_y [N, P] (pixels)
    from stacks [B, L, H, W]: windowed separable-matmul sampling when the
    octave is at least one window wide, pointwise bilinear gathers otherwise
    (equal wherever a patch fits its window)."""
    B, L, H, W = dx_stack.shape
    if min(H, W) >= _WIN:
        return sample_gradients_windowed(dx_stack, dy_stack, kps.img, kps.level, kps.x, kps.y,
                                         off_x, off_y)
    glev = torch.round(kps.level).long().clamp(0, L - 1)
    pos = torch.stack([kps.x[:, None] + off_x, kps.y[:, None] + off_y], -1)
    plane = (kps.img * L + glev)[:, None].expand(pos.shape[:2])
    gx = bilinear_sample_stack(dx_stack.reshape(B * L, H, W), plane, pos)
    gy = bilinear_sample_stack(dy_stack.reshape(B * L, H, W), plane, pos)
    return gx, gy


def compute_descriptors(kps, dx_stack: torch.Tensor, dy_stack: torch.Tensor,
                        cfg: SiftConfig) -> torch.Tensor:
    """Descriptors [N, 128] for keypoints [N] of one octave; dx/dy_stack
    [B, L, H, W] are the gradients of the octave's Gaussian stacks."""
    dev = dx_stack.device
    with span("sift.descriptors.constants", h2d_bytes=_TABLE_BYTES):
        lattice = torch.from_numpy(_LATTICE).to(dev)
        w_gauss = torch.from_numpy(_W_GAUSS).to(dev)
        w_spatial = torch.from_numpy(_W_SPATIAL).to(dev)

    cos_t = torch.cos(kps.angle)
    sin_t = torch.sin(kps.angle)
    scale = kps.sigma * _CELL_SIGMA
    du = lattice[None, :, 0] * scale[:, None]
    dv = lattice[None, :, 1] * scale[:, None]
    off_x = cos_t[:, None] * du - sin_t[:, None] * dv
    off_y = sin_t[:, None] * du + cos_t[:, None] * dv

    gx, gy = sample_gradients(dx_stack, dy_stack, kps, off_x, off_y)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12) * w_gauss[None, :]
    ang = torch.atan2(gy, gx) - kps.angle[:, None]

    binf = (ang / (2.0 * torch.pi) * _NUM_ORI) % _NUM_ORI
    b0 = torch.floor(binf)
    frac = binf - b0
    bins = torch.arange(_NUM_ORI, dtype=torch.float32, device=dev)
    d0 = (bins[None, None, :] - b0[..., None]) % _NUM_ORI
    zero = torch.zeros((), device=dev)
    w_ori = torch.where(d0 == 0, 1.0 - frac[..., None], torch.where(d0 == 1, frac[..., None], zero))
    contrib = mag[..., None] * w_ori

    desc = torch.einsum("pc,kpo->kco", w_spatial, contrib)
    desc = desc.reshape(desc.shape[0], _NUM_CELLS * _NUM_CELLS * _NUM_ORI)

    def normalize(d):
        return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-8)

    desc = normalize(torch.minimum(normalize(desc), torch.full((), _DESC_CLIP, device=dev)))
    if cfg.root_sift:
        desc = torch.sqrt(desc / desc.sum(-1, keepdim=True).clamp_min(1e-8))
    return desc
