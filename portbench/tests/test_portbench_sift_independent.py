"""The SIFT reference (a frozen copy of the port's SIFT layer) against
independently written versions of its parts, at small sizes on the CPU:
NumPy in float64, written from the layer's definitions with loops over
pixels, samples and bins rather than from the copy's code. A fault in the
copy's pyramid, extremum test, orientation or descriptor shows here even
where the port carries the same fault."""

import math
import types

import numpy as np
import pytest
import torch

from portbench import gen
from portbench.reference import sift as ref

CPU = torch.device("cpu")
CFG = types.SimpleNamespace(num_octaves=2, scales_per_octave=3, sigma0=1.6, assumed_blur=0.5,
                            upsample_first_octave=False, contrast_threshold=0.04,
                            num_orientation_bins=36, orientation_peak_ratio=0.8, root_sift=False)


def _views(n=2, size=64, seed=5):
    spec = dict(views=n, image_size=size, blobs=60, children=5, extent=1.2, radius=4.0,
                arc_fraction=0.5, focal=1.2 * size)
    return gen.blob_views(spec, gen.generator(seed, CPU), CPU)


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian of radius ceil(4 sigma), weights summing to 1,
    mirrored at the borders (index -1 reads 1, index n reads n - 2)."""
    if sigma <= 0:
        return img.copy()
    r = max(1, math.ceil(4 * sigma))
    w = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    w /= w.sum()
    n = img.shape[-1]

    def mirror(j):
        return np.where(j < 0, -j, np.where(j >= n, 2 * (n - 1) - j, j))

    out = np.zeros_like(img)
    for k, o in enumerate(range(-r, r + 1)):      # along rows (x)
        out += w[k] * img[..., mirror(np.arange(n) + o)]
    img, out = out, np.zeros_like(img)
    for k, o in enumerate(range(-r, r + 1)):      # along columns (y)
        out += w[k] * img[..., mirror(np.arange(n) + o), :]
    return out


def _pyramid(image: np.ndarray) -> list:
    """Octave o, level i has blur sigma0 * 2^(i / s) relative to the octave;
    each level is blurred from the octave's base (the image at its assumed
    blur, then level s of the octave before, every second pixel)."""
    s, L = CFG.scales_per_octave, CFG.scales_per_octave + 3
    base, have = image, CFG.assumed_blur
    out = []
    for _ in range(CFG.num_octaves):
        levels = []
        for i in range(L):
            want = CFG.sigma0 * 2 ** (i / s)
            levels.append(_blur(base, math.sqrt(max(want * want - have * have, 0.0))))
        out.append(np.stack(levels))
        base, have = levels[s][::2, ::2], CFG.sigma0
    return out


def test_pyramid():
    img = _views()
    got = ref.build_pyramid(img, CFG)
    for b in range(img.shape[0]):
        want = _pyramid(img[b].double().numpy())
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g[b].shape == w.shape
            # the layer rounds each blur's sigma to 1e-4: up to ~7e-6 on these levels
            np.testing.assert_allclose(g[b].double().numpy(), w, rtol=0, atol=1e-5)


def test_extremum_scores():
    g = torch.Generator().manual_seed(8)
    dog = 0.006 * torch.randn(2, 5, 16, 16, generator=g)   # extrema near the threshold
    got = ref.extrema_score_map(dog, CFG).numpy()
    thr = 0.8 * CFG.contrast_threshold / CFG.scales_per_octave
    d = dog.numpy()
    want = np.zeros_like(d)
    for b, l, y, x in np.ndindex(*d.shape):
        if not (1 <= l <= 3 and 5 <= y < 11 and 5 <= x < 11):
            continue
        cube, v = d[b, l - 1:l + 2, y - 1:y + 2, x - 1:x + 2], d[b, l, y, x]
        if (v >= cube.max() and v > thr) or (v <= cube.min() and v < -thr):
            want[b, l, y, x] = abs(v)
    assert np.count_nonzero(want) > 3
    np.testing.assert_array_equal(got, want)


def _gradients(stack: np.ndarray):
    """Central differences along x and y of each level (interior pixels)."""
    gx, gy = np.zeros_like(stack), np.zeros_like(stack)
    gx[..., 1:-1] = 0.5 * (stack[..., 2:] - stack[..., :-2])
    gy[..., 1:-1, :] = 0.5 * (stack[..., 2:, :] - stack[..., :-2, :])
    return gx, gy


def _bilinear(plane: np.ndarray, x: float, y: float) -> float:
    x0, y0 = int(math.floor(x)), int(math.floor(y))
    assert 1 <= x0 and x0 + 2 < plane.shape[1] and 1 <= y0 and y0 + 2 < plane.shape[0]   # interior
    fx, fy = x - x0, y - y0
    return ((1 - fx) * (1 - fy) * plane[y0, x0] + fx * (1 - fy) * plane[y0, x0 + 1]
            + (1 - fx) * fy * plane[y0 + 1, x0] + fx * fy * plane[y0 + 1, x0 + 1])


def _vote(hist: np.ndarray, angle: float, weight: float) -> None:
    """Linear vote of an angle (radians) into the two nearest of len(hist)
    bins, bin j covering [j, j + 1) * 2 pi / len(hist)."""
    n = len(hist)
    f = (angle / (2 * math.pi) * n) % n
    j = int(math.floor(f))
    hist[j % n] += weight * (1 - (f - j))
    hist[(j + 1) % n] += weight * (f - j)


def _orientation(gx, gy, x, y, sigma):
    """Histogram of 36 bins over a 13 x 13 grid spaced 0.75 sigma, each
    sample's gradient magnitude weighted by a Gaussian of 1.5 grid units
    (times 0.75), smoothed twice by [1, 4, 6, 4, 1] / 16; the peak and the
    highest other local peak, each refined by a parabola through its bin
    and the two beside it."""
    nb = CFG.num_orientation_bins
    hist = np.zeros(nb)
    for v in range(-6, 7):
        for u in range(-6, 7):
            px, py = 0.75 * u, 0.75 * v
            a, b = _bilinear(gx, x + px * sigma, y + py * sigma), _bilinear(gy, x + px * sigma, y + py * sigma)
            _vote(hist, math.atan2(b, a), math.hypot(a, b) * math.exp(-(px * px + py * py) / (2 * 1.5**2)))
    for _ in range(2):
        hist = np.array([(hist[j - 2] + 4 * hist[j - 1] + 6 * hist[j] + 4 * hist[(j + 1) % nb]
                          + hist[(j + 2) % nb]) / 16 for j in range(nb)])

    def refined(p):
        hl, hp, hr = hist[p - 1], hist[p], hist[(p + 1) % nb]
        den = hl - 2 * hp + hr
        ang = (p + (0.5 * (hl - hr) / den if abs(den) > 1e-9 else 0.0)) / nb * 2 * math.pi
        return ang - 2 * math.pi if ang > math.pi else ang

    p1 = int(np.argmax(hist))
    peaks = [j for j in range(nb) if j != p1 and hist[j] >= hist[j - 1] and hist[j] >= hist[(j + 1) % nb]]
    p2 = max(peaks, key=lambda j: hist[j]) if peaks else None
    second = p2 is not None and hist[p2] >= CFG.orientation_peak_ratio * hist[p1]
    return refined(p1), (refined(p2) if second else None)


def _descriptor(gx, gy, x, y, sigma, theta):
    """4 x 4 cells of 3 sigma, 16 x 16 samples rotated by theta; each
    sample's magnitude weighted by a Gaussian of 2 cells, voted linearly
    into 8 bins of its angle relative to theta and bilinearly into the
    cells around it; normalised, clipped at 0.2, normalised again.
    Flattened as (cell row, cell column, bin)."""
    hist = np.zeros((4, 4, 8))
    c, s = math.cos(theta), math.sin(theta)
    centres = np.arange(4) - 1.5
    for i in range(16):
        for j in range(16):
            u, v = (j + 0.5) * 0.25 - 2, (i + 0.5) * 0.25 - 2
            ox, oy = (c * u - s * v) * 3 * sigma, (s * u + c * v) * 3 * sigma
            a, b = _bilinear(gx, x + ox, y + oy), _bilinear(gy, x + ox, y + oy)
            mag = math.hypot(a, b) * math.exp(-(u * u + v * v) / 8)
            ori = np.zeros(8)
            _vote(ori, math.atan2(b, a) - theta, mag)
            wy = np.maximum(0, 1 - abs(v - centres))
            wx = np.maximum(0, 1 - abs(u - centres))
            hist += wy[:, None, None] * wx[None, :, None] * ori[None, None, :]
    d = hist.reshape(-1)
    d = np.minimum(d / np.linalg.norm(d), 0.2)
    return d / np.linalg.norm(d)


def _keypoints():
    """Keypoints of image 0 and 1 of a 64^2 octave whose patches lie inside
    it (the layer's windowed sampling path)."""
    xs = [25.3, 31.7, 38.2, 32.9, 36.4]
    ys = [26.8, 33.1, 37.6, 30.0, 25.5]
    lv = [1.2, 1.7, 2.4, 2.0, 1.5]
    n = len(xs)
    f = lambda a: torch.tensor(a, dtype=torch.float32)
    level = f(lv)
    return ref.OctaveKeypoints(img=torch.tensor([0, 1, 0, 1, 0]), x=f(xs), y=f(ys), level=level,
                               sigma=CFG.sigma0 * torch.exp2(level / CFG.scales_per_octave),
                               response=torch.ones(n), angle=torch.zeros(n),
                               valid=torch.ones(n, dtype=torch.bool))


def _stack_and_gradients():
    stack = ref.build_pyramid(_views(), CFG)[0]            # [2, 6, 64, 64]
    dx, dy = ref.pyramid_gradients(stack)
    gx, gy = _gradients(stack.double().numpy())
    return dx, dy, gx, gy


def _angle_gap(a: float, b: float) -> float:
    return abs((a - b + math.pi) % (2 * math.pi) - math.pi)


def test_orientation():
    dx, dy, gx, gy = _stack_and_gradients()
    kps = _keypoints()
    got, angle2, valid2 = ref.assign_orientation(kps, dx, dy, CFG)
    for k in range(len(kps.x)):
        b, lev = int(kps.img[k]), int(round(float(kps.level[k])))
        first, second = _orientation(gx[b, lev], gy[b, lev], float(kps.x[k]), float(kps.y[k]),
                                     float(kps.sigma[k]))
        assert _angle_gap(float(got.angle[k]), first) < 1e-4
        assert bool(valid2[k]) == (second is not None)
        if second is not None:
            assert _angle_gap(float(angle2[k]), second) < 1e-4


@pytest.mark.parametrize("theta", [0.0, 0.7, -2.3])
def test_descriptor(theta):
    dx, dy, gx, gy = _stack_and_gradients()
    kps = _keypoints()._replace(angle=torch.full((5,), theta))
    got = ref.compute_descriptors(kps, dx, dy, CFG).double().numpy()
    for k in range(len(kps.x)):
        b, lev = int(kps.img[k]), int(round(float(kps.level[k])))
        want = _descriptor(gx[b, lev], gy[b, lev], float(kps.x[k]), float(kps.y[k]),
                           float(kps.sigma[k]), theta)
        np.testing.assert_allclose(got[k], want, rtol=0, atol=2e-5)
