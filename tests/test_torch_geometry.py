"""sfm_tpu_torch.geometry against sfm_tpu.geometry on the same numpy inputs.

Tolerance: rtol 1e-5 (atol 1e-6 for values near zero). Both sides are fp32
closed-form arithmetic; only the order of a few sums and the transcendental
implementations differ, which costs a few ulps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.geometry import cameras as jcam, losses as jloss, projection as jproj, rotations as jrot
from sfm_tpu_torch.geometry import cameras as tcam, losses as tloss, projection as tproj, rotations as trot

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _rvecs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w *= (rng.uniform(0, 3.0, (n, 1)) / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    w[:4] = [[0, 0, 0], [1e-5, 0, 0], [0, 2e-5, -1e-5], [np.pi - 1e-3, 0, 0]]   # small and near-pi angles
    return w


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if isinstance(b, torch.Tensor) else b,
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("fn", ["so3_exp", "aa_to_quat", "so3_hat"])
def test_rotation_maps(fn):
    w = _rvecs()
    _close(getattr(jrot, fn)(jnp.asarray(w)), getattr(trot, fn)(torch.from_numpy(w)))


def test_so3_log_and_quaternions():
    w = _rvecs(seed=1)
    R = np.array(jrot.so3_exp(jnp.asarray(w)))
    _close(jrot.so3_log(jnp.asarray(R)), trot.so3_log(torch.from_numpy(R)), rtol=1e-4, atol=1e-5)
    q = np.array(jrot.matrix_to_quat(jnp.asarray(R)))
    _close(q, trot.matrix_to_quat(torch.from_numpy(R)))
    _close(jrot.quat_to_matrix(jnp.asarray(q)), trot.quat_to_matrix(torch.from_numpy(q)))
    q2 = np.roll(q, 5, axis=0)
    _close(jrot.quat_mul(jnp.asarray(q), jnp.asarray(q2)), trot.quat_mul(torch.from_numpy(q), torch.from_numpy(q2)))


def test_camera_models():
    rng = np.random.default_rng(2)
    intr = np.tile(np.array([[600.0, 580.0, 320.0, 240.0, -0.05, 0.01]], np.float32), (50, 1))
    uv = rng.uniform(0, 640, (50, 2)).astype(np.float32)
    xyz = np.concatenate([rng.normal(size=(50, 2)), rng.uniform(1, 5, (50, 1))], 1).astype(np.float32)
    xyz[0, 2] = 1e-9   # guarded divide
    _close(jcam.pixel_to_camera(jnp.asarray(uv), jnp.asarray(intr)),
           tcam.pixel_to_camera(torch.from_numpy(uv), torch.from_numpy(intr)))
    _close(jcam.camera_to_pixel(jnp.asarray(xyz), jnp.asarray(intr)),
           tcam.camera_to_pixel(torch.from_numpy(xyz), torch.from_numpy(intr)), rtol=1e-5, atol=1e-3)


def test_projection_and_poses():
    rng = np.random.default_rng(3)
    w, w2 = _rvecs(32, 4), _rvecs(32, 5)
    t, t2 = rng.normal(size=(2, 32, 3)).astype(np.float32)
    X = (rng.normal(size=(32, 3)) + [0, 0, 6]).astype(np.float32)
    intr = np.tile(np.array([[500.0, 500.0, 256.0, 256.0, 0.02, 0.0]], np.float32), (32, 1))
    J = [jnp.asarray(a) for a in (X, w, t, intr, w2, t2)]
    T = [torch.from_numpy(a) for a in (X, w, t, intr, w2, t2)]
    _close(jproj.project(*J[:4]), tproj.project(*T[:4]), rtol=1e-5, atol=1e-2)
    _close(jproj.point_depth(*J[:3]), tproj.point_depth(*T[:3]), atol=1e-5)
    _close(jproj.camera_center(J[1], J[2]), tproj.camera_center(T[1], T[2]), atol=1e-5)
    for a, b in zip(jproj.relative_pose(J[1], J[2], J[4], J[5]), tproj.relative_pose(T[1], T[2], T[4], T[5])):
        _close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("loss", ["none", "huber", "cauchy"])
def test_robust_losses(loss):
    s = np.concatenate([np.zeros(1), np.geomspace(1e-6, 1e4, 63)]).astype(np.float32)
    _close(jloss.robust_cost(jnp.asarray(s), loss, 4.0), tloss.robust_cost(torch.from_numpy(s), loss, 4.0))
    _close(jloss.robust_weight(jnp.asarray(s), loss, 4.0), tloss.robust_weight(torch.from_numpy(s), loss, 4.0))
