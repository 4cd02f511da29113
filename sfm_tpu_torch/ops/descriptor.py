"""Gradient sampling at per-keypoint lattice offsets (port of the sampling
in sfm_tpu/ops/descriptor.py): orientation assignment samples through it on
every device, and K12's plain version (kernels/sift_descriptors.py) on the
CPU.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ops.interp import bilinear_sample_stack

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
