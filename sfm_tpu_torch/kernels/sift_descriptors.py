"""K12: SIFT 128-D descriptors of one octave in one launch
(csrc/sift_descriptors.cu).

Replaces no TPU kernel: sfm_tpu/ops/descriptor.py compute_descriptors is
plain JAX. The plain version below is the port's descriptor code as it ran
before the kernel: every keypoint samples the same 16x16 lattice in its
rotated, sigma-scaled frame. The lattice is axis-aligned with the 4x4 cell
grid, so the spatial bilinear weights are constants ([256, 16]) and
histogram accumulation is one contraction; only the 8-bin orientation
soft-binning depends on data:

    desc[k, cell, ori] = sum_p W_spatial[p, cell] * (mag * w_gauss)[k, p] * W_ori[k, p, ori]

The CPU runs and the tests against sfm_tpu take it; chip_smoke holds the
kernel to it on the card. The launch plan is plain Python, so that the CPU
tests reach it.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr
from sfm_tpu_torch.ops.descriptor import sample_gradients
from sfm_tpu_torch.utils.logging import span

_NUM_CELLS = 4
_NUM_ORI = 8
_SAMPLES = 16
_CELL_SIGMA = 3.0
_DESC_CLIP = 0.2
DESC_DIM = _NUM_CELLS * _NUM_CELLS * _NUM_ORI

# One block a keypoint, one thread per descriptor entry (csrc kThreads).
THREADS = DESC_DIM


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
_TABLE_BYTES = _LATTICE.nbytes + _W_GAUSS.nbytes + _W_SPATIAL.nbytes  # uploaded by every plain call


def sift_descriptors_plain(kps, dx_stack: torch.Tensor, dy_stack: torch.Tensor,
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


def descriptor_launch_plan(n: int) -> tuple[int, int]:
    """(blocks, threads) for n keypoints: one block of THREADS a keypoint;
    no launch for none."""
    if n < 0 or n > 2**31 - 1:
        raise ValueError(f"keypoints: expected 0 <= n < 2**31, got {n}")
    return n, THREADS


def sift_descriptors(kps, dx_stack: torch.Tensor, dy_stack: torch.Tensor,
                     cfg: SiftConfig) -> torch.Tensor:
    """Descriptors [N, 128] float32 for keypoints [N] of one octave (img
    int64; x, y, level, sigma, angle float32); dx/dy_stack [B, L, H, W]
    float32, the gradients of the octave's Gaussian stacks."""
    if not on_cuda(dx_stack):
        return sift_descriptors_plain(kps, dx_stack, dy_stack, cfg)
    B, L, H, W = dx_stack.shape
    dev = dx_stack.device
    check(dx_stack, "dx_stack", torch.float32, (B, L, H, W), dev)
    check(dy_stack, "dy_stack", torch.float32, (B, L, H, W), dev)
    if B < 1 or L < 1 or H < 2 or W < 2:
        raise ValueError(f"dx_stack: expected B, L >= 1 and H, W >= 2, got {tuple(dx_stack.shape)}")
    n = kps.x.shape[0]
    check(kps.img, "img", torch.int64, (n,), dev)
    for name in ("x", "y", "level", "sigma", "angle"):
        check(getattr(kps, name), name, torch.float32, (n,), dev)
    out = torch.empty((n, DESC_DIM), dtype=torch.float32, device=dev)
    blocks, _ = descriptor_launch_plan(n)
    if blocks:
        launch("sfm_sift_descriptors", "sift_descriptors",
               ptr(dx_stack), ptr(dy_stack), ptr(kps.img), ptr(kps.x), ptr(kps.y),
               ptr(kps.level), ptr(kps.sigma), ptr(kps.angle), ptr(out),
               n, B, L, H, W, int(cfg.root_sift))
    return out
