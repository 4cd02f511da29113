"""Synthetic scene generator — ground truth for unit/integration tests.

SURVEY.md §4.1: sample K cameras on an orbit looking at M 3D points, render
exact projections plus controlled noise/outliers. Every geometric component
(triangulation, 8-pt E, PnP, RANSAC, BA) is tested against this known truth
with deterministic PRNG keys.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Pure-numpy math throughout (a copy of sfm_tpu/utils/synthetic.py): the
# fixtures build the same scenes for both packages and need neither JAX nor
# a GPU.


def _np_rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _np_log_so3(R: np.ndarray) -> np.ndarray:
    """SO(3) log via the quaternion route — stable across the full angle
    range INCLUDING theta == pi (orbit cameras at angle 0 look along -z,
    which is exactly a pi rotation; the naive trace formula returns 0 there)."""
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    cands = np.array([
        [1.0 + tr, R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        [R[2, 1] - R[1, 2], 1.0 + m00 - m11 - m22, R[0, 1] + R[1, 0], R[0, 2] + R[2, 0]],
        [R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], 1.0 - m00 + m11 - m22, R[1, 2] + R[2, 1]],
        [R[1, 0] - R[0, 1], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], 1.0 - m00 - m11 + m22],
    ])
    pivots = np.array([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    q = cands[int(np.argmax(pivots))]
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    w, v = q[0], q[1:]
    vnorm = np.linalg.norm(v)
    if vnorm < 1e-12:
        return 2.0 * v / max(w, 1e-12)
    theta = 2.0 * np.arctan2(vnorm, w)
    return v * (theta / vnorm)


def _np_project(points: np.ndarray, rvec: np.ndarray, tvec: np.ndarray, intr: np.ndarray):
    """points [N,3] -> (pixels [N,2], depths [N]); matches geometry.project."""
    R = _np_rodrigues(np.asarray(rvec, np.float64))
    xc = points @ R.T + tvec
    z = np.where(np.abs(xc[:, 2]) < 1e-8, np.where(xc[:, 2] < 0, -1e-8, 1e-8), xc[:, 2])
    xy = xc[:, :2] / z[:, None]
    r2 = (xy ** 2).sum(-1)
    scale = 1.0 + r2 * (intr[4] + r2 * intr[5])
    xy = xy * scale[:, None]
    uv = xy * intr[:2][None, :] + intr[2:4][None, :]
    return uv, xc[:, 2]


@dataclass
class SyntheticScene:
    """Ground-truth scene. All arrays are numpy (host-side test fixture)."""

    points: np.ndarray        # (M, 3) world points
    rvecs: np.ndarray         # (K, 3) world->camera angle-axis
    tvecs: np.ndarray         # (K, 3)
    intrinsics: np.ndarray    # (K, 6) [fx, fy, cx, cy, k1, k2]
    pixels: np.ndarray        # (K, M, 2) exact (or noisy) projections
    visible: np.ndarray       # (K, M) bool visibility mask
    image_size: tuple[int, int]

    @property
    def num_cameras(self) -> int:
        return self.rvecs.shape[0]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]


def look_at(center: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)) -> tuple[np.ndarray, np.ndarray]:
    """World->camera (R, t) for a camera at `center` looking at `target`."""
    z = target - center
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, dtype=np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # rows are camera axes in world frame
    t = -R @ center
    return R, t


def make_orbit_scene(
    num_cameras: int = 8,
    num_points: int = 200,
    radius: float = 4.0,
    point_extent: float = 1.0,
    image_size: tuple[int, int] = (640, 480),
    focal: float = 600.0,
    noise_px: float = 0.0,
    k1: float = 0.0,
    seed: int = 0,
    arc_fraction: float = 1.0,
) -> SyntheticScene:
    """Cameras on a circular orbit in the x-z plane looking at the origin;
    points in a box around the origin. Deterministic in `seed`.
    """
    rng = np.random.default_rng(seed)
    w, h = image_size
    points = rng.uniform(-point_extent, point_extent, size=(num_points, 3))

    rvecs, tvecs = [], []
    for i in range(num_cameras):
        angle = 2.0 * np.pi * arc_fraction * i / num_cameras
        center = np.array([radius * np.sin(angle), 0.3 * np.sin(2 * angle), radius * np.cos(angle)])
        R, t = look_at(center, np.zeros(3))
        rvecs.append(_np_log_so3(R))
        tvecs.append(t)
    rvecs = np.stack(rvecs)
    tvecs = np.stack(tvecs)

    intr = np.tile(
        np.asarray([focal, focal, w / 2.0, h / 2.0, k1, 0.0], dtype=np.float64), (num_cameras, 1)
    )

    pix = np.zeros((num_cameras, num_points, 2))
    depth = np.zeros((num_cameras, num_points))
    for i in range(num_cameras):
        pix[i], depth[i] = _np_project(points, rvecs[i], tvecs[i], intr[i])

    visible = (
        (depth > 0.1)
        & (pix[..., 0] >= 0) & (pix[..., 0] < w)
        & (pix[..., 1] >= 0) & (pix[..., 1] < h)
    )

    if noise_px > 0:
        pix = pix + rng.normal(0.0, noise_px, size=pix.shape)

    return SyntheticScene(
        points=points.astype(np.float32),
        rvecs=rvecs.astype(np.float32),
        tvecs=tvecs.astype(np.float32),
        intrinsics=intr.astype(np.float32),
        pixels=pix.astype(np.float32),
        visible=visible,
        image_size=image_size,
    )


def add_outliers(pixels: np.ndarray, visible: np.ndarray, fraction: float, image_size, seed: int = 1):
    """Replace a fraction of visible observations with uniform-random pixels.

    Returns (pixels, outlier_mask)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    out = pixels.copy()
    is_outlier = np.zeros(visible.shape, dtype=bool)
    flat_visible = np.argwhere(visible)
    n_out = int(fraction * len(flat_visible))
    idx = rng.choice(len(flat_visible), size=n_out, replace=False)
    for k, m in flat_visible[idx]:
        out[k, m] = [rng.uniform(0, w), rng.uniform(0, h)]
        is_outlier[k, m] = True
    return out, is_outlier


def render_blob_scene(
    image_size: tuple[int, int] = (256, 256),
    num_images: int = 2,
    num_blobs: int = 120,
    focal: float = 300.0,
    seed: int = 0,
    arc_fraction: float = 0.04,
    radius: float = 4.0,
) -> tuple[np.ndarray, SyntheticScene]:
    """Render images of a TRUE-3D scene: each feature is a micro-cluster of
    3D Gaussian splats around a parent point at random depth, so two-view
    geometry is non-degenerate (unlike a textured plane, which is
    homography-degenerate for E estimation). Appearance is approximately
    viewpoint-invariant because the substructure is itself 3D. Returns
    (images [N, H, W] float32 in [0, 1], ground-truth scene of the parents).
    """
    rng = np.random.default_rng(seed)
    w, h = image_size

    scene = make_orbit_scene(
        num_cameras=num_images, num_points=num_blobs, radius=radius,
        point_extent=1.2, image_size=image_size, focal=focal, seed=seed,
        arc_fraction=arc_fraction,
    )
    # Micro-structure: children offset around each parent, amplitudes fixed
    # per child so appearance is consistent across views.
    n_child = 5
    child_off = rng.normal(0.0, 0.035, size=(num_blobs, n_child, 3))
    child_off[:, 0] = 0.0  # one child exactly at the parent
    child_amp = rng.uniform(0.35, 1.0, size=(num_blobs, n_child)) * rng.choice(
        [-1.0, 1.0], size=(num_blobs, n_child)
    )
    child_size = rng.uniform(0.02, 0.045, size=(num_blobs, n_child))  # world units

    children = (scene.points[:, None, :] + child_off).reshape(-1, 3)
    amps = child_amp.reshape(-1)
    sizes = child_size.reshape(-1)

    images = []
    ys, xs = np.mgrid[0:h, 0:w]
    grid = np.stack([xs + 0.5, ys + 0.5], -1).reshape(-1, 2).astype(np.float32)
    for i in range(num_images):
        uv, depth = _np_project(
            children.astype(np.float64), scene.rvecs[i], scene.tvecs[i], scene.intrinsics[i].astype(np.float64)
        )
        sigma_px = scene.intrinsics[i, 0] * sizes / np.maximum(depth, 0.5)
        img = np.full((h, w), 0.45, dtype=np.float32)
        # Low-frequency background so the image is not flat.
        img += (0.05 * np.sin((np.arange(w) + 0.5) / 37.0))[None, :] * (
            np.cos((np.arange(h) + 0.5) / 53.0)
        )[:, None]
        # Windowed splatting: each blob only touches its +-4 sigma box
        # (truncation error < 3e-4 of amplitude) — orders of magnitude
        # cheaper than full-image distance fields at ladder scales.
        for c in range(len(children)):
            sp = float(sigma_px[c])
            if not np.isfinite(sp) or sp <= 0 or depth[c] <= 0.5:
                continue
            r = max(2, int(np.ceil(4.0 * sp)))
            cx, cy = uv[c]
            x0, x1 = int(np.floor(cx - r)), int(np.ceil(cx + r)) + 1
            y0, y1 = int(np.floor(cy - r)), int(np.ceil(cy + r)) + 1
            x0, x1 = max(x0, 0), min(x1, w)
            y0, y1 = max(y0, 0), min(y1, h)
            if x0 >= x1 or y0 >= y1:
                continue
            xs = np.arange(x0, x1) + 0.5 - cx
            ys = np.arange(y0, y1) + 0.5 - cy
            d2 = ys[:, None] ** 2 + xs[None, :] ** 2
            img[y0:y1, x0:x1] += amps[c] * 0.35 * np.exp(-d2 / (2 * sp * sp + 1e-6))
        images.append(np.clip(img, 0.0, 1.0))
    return np.stack(images), scene


def render_checkerboard_scene(
    image_size: tuple[int, int] = (256, 256),
    num_images: int = 2,
    focal: float = 300.0,
    seed: int = 0,
) -> tuple[np.ndarray, SyntheticScene]:
    """Render simple textured images of a frontoparallel plane from orbit
    cameras — real pixel data for end-to-end feature/match tests without any
    dataset dependency. Returns (images [N,H,W] float32 in [0,1], scene)."""
    rng = np.random.default_rng(seed)
    w, h = image_size
    # A textured plane z=0 spanning [-1,1]^2: random smooth blobs.
    tex_n = 64
    centers = rng.uniform(-1.0, 1.0, size=(tex_n, 2))
    amps = rng.uniform(0.3, 1.0, size=tex_n) * rng.choice([-1, 1], size=tex_n)
    sigmas = rng.uniform(0.03, 0.15, size=tex_n)

    def texture(xy):  # xy (..., 2) in plane coords
        d2 = ((xy[..., None, :] - centers) ** 2).sum(-1)
        v = (amps * np.exp(-d2 / (2 * sigmas**2))).sum(-1)
        return 0.5 + 0.25 * v

    scene = make_orbit_scene(
        num_cameras=num_images, num_points=64, radius=3.0, image_size=image_size,
        focal=focal, seed=seed, arc_fraction=0.08,
    )
    images = []
    for i in range(num_images):
        # Ray-cast each pixel to the z=0 plane.
        ys, xs = np.mgrid[0:h, 0:w]
        uv = np.stack([xs + 0.5, ys + 0.5], axis=-1).astype(np.float64)
        fx, fy, cx, cy = scene.intrinsics[i, :4]
        xy_cam = np.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], axis=-1)
        R = _np_rodrigues(scene.rvecs[i].astype(np.float64))
        t = scene.tvecs[i].astype(np.float64)
        C = -R.T @ t
        dirs = (R.T @ np.concatenate([xy_cam, np.ones_like(xy_cam[..., :1])], -1).reshape(-1, 3).T).T
        # Intersect z=0: C_z + s*d_z = 0.
        s = -C[2] / np.where(np.abs(dirs[:, 2]) < 1e-9, 1e-9, dirs[:, 2])
        hit = C[None, :] + s[:, None] * dirs
        img = texture(hit[:, :2]).reshape(h, w)
        img = np.where((np.abs(hit[:, 0]) <= 1.5) & (np.abs(hit[:, 1]) <= 1.5), img.reshape(-1), 0.1).reshape(h, w)
        images.append(img.astype(np.float32))
    return np.stack(images), scene
