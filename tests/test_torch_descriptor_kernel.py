"""K12 (sift_descriptors): the clamp semantics its plain version has and the
CUDA kernel copies, its launch plan, and the arguments the wrapper hands
the kernel.

The kernel samples 4-tap bilinear inside a clamp box: the 64-px window
around round(x), round(y) clamped into the image where min(H, W) >= 64,
else the whole plane. The plain version samples the window through
separable weight matrices; here it is held against a float64 4-tap version
written anew with the same box. Tolerance 1e-5 on the normalised
descriptors: the two differ only by fp32 rounding (positions of views of
at most 128 px round at ~1e-5 px, and the gradient fields vary over 16 px
and more).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import SiftConfig
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import sift_descriptors as k12
from sfm_tpu_torch.ops.detect import OctaveKeypoints

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _smooth_fields(shape, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two fields [B, L, H, W] of sums of plane waves (wavelengths 16-40 px):
    the gradient stacks' stand-ins, with both signs."""
    rng = np.random.default_rng(seed)
    B, L, H, W = shape
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    out = []
    for _ in range(2):
        f = np.zeros(shape)
        for b in range(B):
            for lev in range(L):
                for _ in range(4):
                    k = 2 * np.pi / rng.uniform(16, 40)
                    t = rng.uniform(0, 2 * np.pi)
                    f[b, lev] += rng.uniform(0.01, 0.05) * np.sin(k * (np.cos(t) * xx + np.sin(t) * yy)
                                                                  + rng.uniform(0, 2 * np.pi))
        out.append(f.astype(np.float32))
    return out[0], out[1]


def _keypoints(shape, seed: int, n: int = 24) -> OctaveKeypoints:
    """Random keypoints over the whole plane (levels past both ends, blurs
    up to 5 px: lattices up to ~40 px from the centre), and keypoints within
    4 px of each border and at the centre with the largest blur."""
    rng = np.random.default_rng(seed)
    B, L, H, W = shape
    x = np.concatenate([rng.uniform(2, W - 3, n), [3.3, W - 4.2, W / 2 + 0.3, W / 2 - 0.4, 2.5, W - 3.5]])
    y = np.concatenate([rng.uniform(2, H - 3, n), [H / 2 + 0.2, H / 2 - 0.3, 2.7, H - 3.6, H - 2.5, 3.1]])
    m = x.size
    sigma = np.concatenate([rng.uniform(1.6, 5.0, n), np.full(m - n, 5.0)])
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return OctaveKeypoints(
        img=torch.from_numpy(rng.integers(0, B, m)), x=f32(x), y=f32(y),
        level=f32(rng.uniform(-0.6, L - 0.4, m)), sigma=f32(sigma), response=f32(np.ones(m)),
        angle=f32(rng.uniform(-np.pi, np.pi, m)), valid=torch.ones(m, dtype=torch.bool))


def _descriptors64(kps, dx, dy, window: bool, root_sift: bool = False):
    """Float64 descriptors with 4-tap bilinear sampling inside the clamp
    box: the 64-px window (window=True, needs min(H, W) >= 64) or the whole
    plane. Also returns, per keypoint, whether some lattice point was
    clamped by the box while it lay inside the image."""
    B, L, H, W = dx.shape
    dx, dy = dx.astype(np.float64), dy.astype(np.float64)
    img = kps.img.numpy()
    x, y, level, sigma, angle = (np.float64(getattr(kps, f).numpy()) for f in ("x", "y", "level", "sigma", "angle"))
    coords = (np.arange(16) + 0.5) / 4.0 - 2.0
    u, v = np.tile(coords, 16), np.repeat(coords, 16)        # point p = 16 * row + column
    du, dv = u[None] * 3.0 * sigma[:, None], v[None] * 3.0 * sigma[:, None]
    c, s = np.cos(angle)[:, None], np.sin(angle)[:, None]
    ox, oy = x[:, None] + c * du - s * dv, y[:, None] + s * du + c * dv
    lev = np.clip(np.round(level), 0, L - 1).astype(np.int64)
    if window:
        bx = np.clip(np.round(x).astype(np.int64) - 32, 0, W - 64)
        by = np.clip(np.round(y).astype(np.int64) - 32, 0, H - 64)
        bw = bh = 64
    else:
        bx = by = np.zeros(x.size, np.int64)
        bw, bh = W, H
    px = np.clip(ox - bx[:, None], 0.0, bw - 1.000001)
    py = np.clip(oy - by[:, None], 0.0, bh - 1.000001)
    inside = (ox >= 0) & (ox <= W - 1) & (oy >= 0) & (oy <= H - 1)
    moved = ((px != ox - bx[:, None]) | (py != oy - by[:, None])) & inside
    x0, y0 = np.floor(px).astype(np.int64), np.floor(py).astype(np.int64)
    fx, fy = px - x0, py - y0
    x1, y1 = np.minimum(x0 + 1, bw - 1), np.minimum(y0 + 1, bh - 1)
    b, lv = img[:, None], lev[:, None]
    ax, ay = bx[:, None], by[:, None]

    def sample(g):
        return (g[b, lv, ay + y0, ax + x0] * (1 - fx) * (1 - fy) + g[b, lv, ay + y0, ax + x1] * fx * (1 - fy)
                + g[b, lv, ay + y1, ax + x0] * (1 - fx) * fy + g[b, lv, ay + y1, ax + x1] * fx * fy)

    gx, gy = sample(dx), sample(dy)
    mag = np.sqrt(gx * gx + gy * gy + 1e-12) * np.exp(-(u * u + v * v) / 8.0)[None]
    binf = ((np.arctan2(gy, gx) - angle[:, None]) / (2 * np.pi) * 8) % 8
    b0 = np.floor(binf)
    frac = binf - b0
    lo = b0.astype(np.int64) % 8
    contrib = np.zeros(mag.shape + (8,))
    np.put_along_axis(contrib, lo[..., None], (mag * (1 - frac))[..., None], -1)
    np.put_along_axis(contrib, ((lo + 1) % 8)[..., None], (mag * frac)[..., None], -1)
    centres = np.arange(4) - 1.5
    wx = np.maximum(0.0, 1.0 - np.abs(u[:, None] - centres[None]))
    wy = np.maximum(0.0, 1.0 - np.abs(v[:, None] - centres[None]))
    spatial = (wy[:, :, None] * wx[:, None, :]).reshape(256, 16)
    desc = np.einsum("pc,kpo->kco", spatial, contrib).reshape(-1, 128)
    desc /= np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True), 1e-8)
    desc = np.minimum(desc, 0.2)
    desc /= np.maximum(np.linalg.norm(desc, axis=-1, keepdims=True), 1e-8)
    if root_sift:
        desc = np.sqrt(desc / np.maximum(desc.sum(-1, keepdims=True), 1e-8))
    return desc, moved.any(-1)


@pytest.mark.parametrize("shape, root_sift", [
    ((2, 6, 128, 128), False),   # the window route; lattices cross the 64-px window
    ((2, 5, 64, 96), True),      # min(H, W) == 64: still the window route
    ((2, 4, 48, 48), False),     # under 64 px: the whole plane
    ((1, 4, 40, 72), True),      # the whole plane, not square
])
def test_plain_descriptors_equal_float64_four_taps_in_the_same_clamp_box(shape, root_sift):
    dx, dy = _smooth_fields(shape, seed=sum(shape))
    kps = _keypoints(shape, seed=shape[2])
    window = min(shape[2:]) >= 64
    cfg = SiftConfig(root_sift=root_sift)
    got = k12.sift_descriptors(kps, torch.from_numpy(dx), torch.from_numpy(dy), cfg).double().numpy()
    want, moved = _descriptors64(kps, dx, dy, window, root_sift)
    assert got.shape == (kps.x.shape[0], 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if window:
        # The window, not the image, bounds these lattices: sampled with the
        # whole plane as the box they give other descriptors.
        assert moved.sum() >= 3
        other, _ = _descriptors64(kps, dx, dy, False, root_sift)
        assert np.abs(other - want)[moved].max() > 1e-3
        assert np.abs(other - want)[~moved].max() < 1e-5
    near_border = (kps.x < 32) | (kps.x > shape[3] - 33) | (kps.y < 32) | (kps.y > shape[2] - 33)
    assert int(near_border.sum()) >= 6


@pytest.mark.parametrize("n", [1, 127, 2048, 16384, 2**31 - 1])
def test_launch_plan_gives_a_block_of_128_threads_to_each_keypoint(n):
    assert k12.descriptor_launch_plan(n) == (n, 128)


def test_launch_plan_refuses_what_one_grid_cannot_hold():
    assert k12.descriptor_launch_plan(0) == (0, 128)
    for n in (-1, 2**31):
        with pytest.raises(ValueError):
            k12.descriptor_launch_plan(n)


@pytest.mark.parametrize("root_sift", [False, True])
def test_wrapper_passes_the_plan(monkeypatch, root_sift):
    """The wrapper hands the C entry the stacks, the keypoint fields, a fresh
    [N, 128] output, N, the shape and the root-SIFT flag
    (sfm_sift_descriptors' arguments, plus the stream); none keypoints, no
    launch."""
    passed = []
    monkeypatch.setattr(k12, "on_cuda", lambda t: True)
    monkeypatch.setattr(k12, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    shape = (2, 6, 128, 96)
    dx, dy = torch.zeros(shape), torch.zeros(shape)
    kps = _keypoints(shape, seed=1)
    out = k12.sift_descriptors(kps, dx, dy, SiftConfig(root_sift=root_sift))
    (entry, name, args), = passed
    assert (entry, name) == ("sfm_sift_descriptors", "sift_descriptors")
    assert len(_SIGNATURES[entry]) == len(args) + 1
    n = kps.x.shape[0]
    assert out.shape == (n, 128) and out.dtype == torch.float32
    fields = (dx, dy, kps.img, kps.x, kps.y, kps.level, kps.sigma, kps.angle, out)
    assert args[:9] == tuple(t.data_ptr() for t in fields)
    assert args[9:] == (n, *shape, int(root_sift))
    none = kps._replace(**{f: getattr(kps, f)[:0] for f in kps._fields})
    assert k12.sift_descriptors(none, dx, dy, SiftConfig()).shape == (0, 128)
    assert len(passed) == 1


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    monkeypatch.setattr(k12, "on_cuda", lambda t: True)
    monkeypatch.setattr(k12, "launch", lambda *a: None)
    shape = (1, 4, 32, 32)
    dx = torch.zeros(shape)
    kps = _keypoints(shape, seed=2, n=4)
    cfg = SiftConfig()
    with pytest.raises(ValueError):
        k12.sift_descriptors(kps, dx, dx.double(), cfg)
    with pytest.raises(ValueError):
        k12.sift_descriptors(kps._replace(img=kps.img.int()), dx, dx, cfg)
    with pytest.raises(ValueError):
        k12.sift_descriptors(kps._replace(x=torch.zeros(2 * kps.x.shape[0])[::2]), dx, dx, cfg)
    with pytest.raises(ValueError):
        k12.sift_descriptors(kps, torch.zeros((1, 4, 32, 1)), torch.zeros((1, 4, 32, 1)), cfg)


def test_kernel_source_parses():
    """csrc/sift_descriptors.cu parses with g++ against the CUDA shim
    (tools/cuda_syntax_check.py); compiling and running it takes the card
    (chip_smoke.py's [descriptors] line)."""
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "cuda_syntax_check.py"), "sift_descriptors.cu"],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
