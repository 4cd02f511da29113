"""Plain reference of the SIFT layer: a frozen copy of the port's feature
extraction as it stood when the benchmark was defined (pyramid, DoG
extremum scores, detection, refinement, orientation, descriptors), in
plain torch operations. It imports nothing of the port: K1's place is taken
by the plain score map it is held to bit for bit, and `cfg` is any object
with the SIFT fields of the configuration file.

The pyramid's blurs are fp32 matrix products: with TF32 off they are what
the configuration states; the control turns TF32 on.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


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
    Ts = np.stack([
        np.eye(H, dtype=np.float32) if s <= 0 else _toeplitz_blur(H, int(round(s * 1e4)))
        for s in sigmas
    ])
    T = torch.from_numpy(Ts).to(base.device)
    return torch.matmul(torch.matmul(T[None], base[:, None]), T.transpose(1, 2)[None])


def downsample2(images: torch.Tensor) -> torch.Tensor:
    return images[..., ::2, ::2]


def build_pyramid(images: torch.Tensor, cfg) -> list[torch.Tensor]:
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
                        cfg) -> torch.Tensor:
    """Descriptors [N, 128] for keypoints [N] of one octave; dx/dy_stack
    [B, L, H, W] are the gradients of the octave's Gaussian stacks."""
    dev = dx_stack.device
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


def pre_threshold(cfg) -> float:
    return 0.8 * cfg.contrast_threshold / cfg.scales_per_octave


def extrema_score_map(dog: torch.Tensor, cfg) -> torch.Tensor:
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
                      cfg) -> OctaveKeypoints:
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
                       cfg):
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


class Features(NamedTuple):
    """Per-image feature sets, fixed budget N = cfg.max_keypoints."""

    xy: torch.Tensor        # [B, N, 2] pixel coords in the canvas
    sigma: torch.Tensor     # [B, N]
    angle: torch.Tensor     # [B, N]
    response: torch.Tensor  # [B, N]
    desc: torch.Tensor      # [B, N, 128] L2-normalized
    valid: torch.Tensor     # [B, N] bool


def _octave_scores(stack: torch.Tensor, cfg) -> torch.Tensor:
    return extrema_score_map(stack[:, 1:] - stack[:, :-1], cfg)


def extract_features(images: torch.Tensor, cfg,
                     valid_hw: torch.Tensor | None = None) -> Features:
    """images: [B, H, W] float32 grayscale in [0, 1]; valid_hw: optional
    [B, 2] (height, width) of the un-padded content of each canvas."""
    B = images.shape[0]
    octaves = build_pyramid(images, cfg)
    factor0 = 0.5 if cfg.upsample_first_octave else 1.0   # octave 0 pixels -> canvas pixels
    k_budget = max(cfg.max_candidates // cfg.num_octaves, 32)
    per_oct = []
    for o, stack in enumerate(octaves):
        dx, dy = pyramid_gradients(stack)
        _, L, H, W = stack.shape
        k_this = min(k_budget, (L - 1) * H * W)
        desc_budget = min(cfg.desc_per_octave, k_this)

        idx, scores = select_candidates(_octave_scores(stack, cfg), k_this)
        kps = refine_candidates(stack, idx, scores, cfg)               # [B * k_this]
        # Compact to the survivors before orientation and descriptors.
        sc = torch.where(kps.valid, kps.response, torch.full((), -1.0, device=images.device))
        _, keep = top_k_stable(sc.reshape(B, k_this), desc_budget)
        keep = (keep + torch.arange(B, device=images.device)[:, None] * k_this).reshape(-1)
        kps = take(kps, keep)                                          # [B * desc_budget]
        kps, angle2, valid2 = assign_orientation(kps, dx, dy, cfg)
        if cfg.multi_orientation:
            second = kps._replace(angle=angle2, valid=kps.valid & valid2)
            kps = OctaveKeypoints(*(
                torch.cat([a.reshape(B, -1), b.reshape(B, -1)], 1).reshape(-1)
                for a, b in zip(kps, second)))
        desc = compute_descriptors(kps, dx, dy, cfg)
        scale = factor0 * 2.0**o
        per_oct.append(dict(
            xy=torch.stack([kps.x, kps.y], -1).reshape(B, -1, 2) * scale,
            sigma=(kps.sigma * scale).reshape(B, -1),
            angle=kps.angle.reshape(B, -1),
            response=kps.response.reshape(B, -1),
            desc=desc.reshape(B, -1, desc.shape[-1]),
            valid=kps.valid.reshape(B, -1),
        ))

    cat = {k: torch.cat([p[k] for p in per_oct], dim=1) for k in per_oct[0]}
    if valid_hw is not None:
        margin = 1.0
        hw = valid_hw.to(cat["xy"].dtype)
        inside = ((cat["xy"][..., 0] >= margin) & (cat["xy"][..., 0] < hw[:, None, 1] - margin)
                  & (cat["xy"][..., 1] >= margin) & (cat["xy"][..., 1] < hw[:, None, 0] - margin))
        cat["valid"] = cat["valid"] & inside

    score = torch.where(cat["valid"], cat["response"], torch.full((), -1.0, device=images.device))
    n = min(cfg.max_keypoints, score.shape[1])
    top_scores, top = top_k_stable(score, n)

    def gather(a):
        if a.dim() > 2:
            return torch.gather(a, 1, top[..., None].expand(-1, -1, a.shape[-1]))
        return torch.gather(a, 1, top)

    return Features(
        xy=gather(cat["xy"]),
        sigma=gather(cat["sigma"]),
        angle=gather(cat["angle"]),
        response=gather(cat["response"]),
        desc=gather(cat["desc"]),
        valid=gather(cat["valid"]) & (top_scores > 0),
    )
