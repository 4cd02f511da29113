"""K14: sub-pixel refinement of one octave's extremum candidates in one
launch (csrc/subpixel_refine.cu).

Replaces no TPU kernel: sfm_tpu/ops/detect.py refine_candidates is plain
JAX. The plain version below is the port's refinement as it ran before the
kernel, its arithmetic unchanged: an iterated 3-D quadratic fit, each round
a 3x3x3 DoG cube gathered from the Gaussian stacks and a batch of 3x3
solves. The CPU runs and the tests against sfm_tpu take it; chip_smoke
holds the kernel to it on the card. The launch plan is plain Python, so
that the CPU tests reach it.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import check, launch, on_cuda, ptr
from sfm_tpu_torch.ops.detect import OctaveKeypoints

# One thread a candidate (csrc kThreads).
THREADS = 256


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


def subpixel_refine_plain(gauss: torch.Tensor, idx: torch.Tensor, scores: torch.Tensor,
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


def refine_launch_plan(n: int) -> tuple[int, int]:
    """(blocks, threads) for n candidates: one thread a candidate, THREADS a
    block; no launch for none."""
    if n < 0 or n > 2**31 - 1:
        raise ValueError(f"candidates: expected 0 <= n < 2**31, got {n}")
    return -(-n // THREADS), THREADS


def _row_stride(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> int:
    """Raise unless `t` is a `dtype` tensor of `shape` [B, K] on `device`
    whose rows are contiguous (top_k_stable's slices of longer rows are
    taken as they are); its row stride."""
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    return t.stride(0)


def subpixel_refine(gauss: torch.Tensor, idx: torch.Tensor, scores: torch.Tensor,
                    cfg: SiftConfig) -> OctaveKeypoints:
    """Refined keypoints [B * K] of one octave's candidates: gauss [B, L, H,
    W] float32, the Gaussian stacks; idx [B, K] int64, flat indices into the
    DoG volumes [L - 1, H, W], and scores [B, K] float32 (select_candidates',
    whose rows may be slices of longer ones). Every candidate gets a slot;
    rejected ones keep valid=False."""
    if not on_cuda(gauss):
        return subpixel_refine_plain(gauss, idx, scores, cfg)
    B, L, H, W = gauss.shape
    dev = gauss.device
    check(gauss, "gauss", torch.float32, (B, L, H, W), dev)
    if B < 1 or L < 4 or H < 5 or W < 5:
        raise ValueError(f"gauss: expected B >= 1, L >= 4 and H, W >= 5, got {tuple(gauss.shape)}")
    K = idx.shape[-1]
    idx_stride = _row_stride(idx, "idx", torch.int64, (B, K), dev)
    score_stride = _row_stride(scores, "scores", torch.float32, (B, K), dev)
    if cfg.refine_iters < 0:
        raise ValueError(f"refine_iters: expected >= 0, got {cfg.refine_iters}")
    n = B * K
    blocks, _ = refine_launch_plan(n)
    kps = OctaveKeypoints(
        img=torch.empty(n, dtype=torch.int64, device=dev),
        **{f: torch.empty(n, dtype=torch.float32, device=dev)
           for f in ("x", "y", "level", "sigma", "response", "angle")},
        valid=torch.empty(n, dtype=torch.bool, device=dev))
    if blocks:
        r = cfg.edge_threshold
        launch("sfm_subpixel_refine", "subpixel_refine",
               ptr(gauss), ptr(idx), idx_stride, ptr(scores), score_stride, *(ptr(f) for f in kps),
               n, K, L, H, W, cfg.refine_iters, cfg.contrast_threshold / cfg.scales_per_octave,
               r, (r + 1) ** 2, cfg.sigma0, float(cfg.scales_per_octave))
    return kps
