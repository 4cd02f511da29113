"""sfm_tpu's public names that the port lacked (ROADMAP queue 1 item 7),
each held against its twin on the same inputs.

- sfm_tpu.geometry's 29 re-exports: each present in sfm_tpu_torch.geometry,
  the object of the port's own module, constants equal;
- aa_to_matrix, camera_to_world, reprojection_residual: 1e-5 (the same
  formulas in fp32, another evaluation order); make_intrinsics: equal;
- ba.ba_cost: rtol 1e-5 (tests/test_torch_ba.py's cost bar);
- ops.solvers.refine_essential_gn from the same 8-point E: the refined E,
  normalized, within 1e-3 of sfm_tpu's and its mean Sampson error within
  1% of sfm_tpu's (five Gauss-Newton steps on fp32 iterates, each projected
  back to the essential manifold through svd3_twoview).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfm_tpu.geometry as jgeom
import sfm_tpu_torch.geometry as tgeom

GEOMETRY_NAMES = {
    "rotations": ("aa_to_matrix", "matrix_to_aa", "quat_to_matrix", "matrix_to_quat", "quat_mul",
                  "so3_exp", "so3_log", "so3_hat"),
    "cameras": ("CAM_FX", "CAM_FY", "CAM_CX", "CAM_CY", "CAM_K1", "CAM_K2", "NUM_INTRINSICS",
                "make_intrinsics", "distort", "undistort", "camera_to_pixel", "pixel_to_camera"),
    "projection": ("world_to_camera", "camera_to_world", "project", "reprojection_residual",
                   "compose_poses", "invert_pose"),
    "losses": ("huber", "cauchy", "robust_weight"),
}


def test_geometry_reexports_are_sfm_tpus_29():
    ours = {n for names in GEOMETRY_NAMES.values() for n in names}
    theirs = {n for n in vars(jgeom) if not n.startswith("_") and not isinstance(getattr(jgeom, n), type(jgeom))}
    assert len(ours) == 29 and ours == theirs


@pytest.mark.parametrize("module,name", [(m, n) for m, names in GEOMETRY_NAMES.items() for n in names])
def test_geometry_reexport(module, name):
    obj = getattr(tgeom, name)
    assert obj is getattr(importlib.import_module(f"sfm_tpu_torch.geometry.{module}"), name)
    if not callable(obj):
        assert obj == getattr(jgeom, name)


def _poses(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.7, (n, 3)).astype(np.float32), rng.normal(0, 2.0, (n, 3)).astype(np.float32),
            rng.normal(0, 3.0, (n, 3)).astype(np.float32) + np.float32([0, 0, 10]))


def test_aa_to_matrix():
    w = _poses()[0]
    np.testing.assert_allclose(tgeom.aa_to_matrix(torch.from_numpy(w)).numpy(),
                               np.asarray(jgeom.aa_to_matrix(jnp.asarray(w))), atol=1e-5)


def test_make_intrinsics():
    for args, kwargs in (((500.0,), {}), ((600.0, 580.0, 320.0, 240.0), {"k1": -0.1, "k2": 0.05})):
        ours = tgeom.make_intrinsics(*args, **kwargs)
        assert ours.dtype == torch.float32
        np.testing.assert_array_equal(ours.numpy(), np.asarray(jgeom.make_intrinsics(*args, **kwargs)))


def test_camera_to_world():
    rv, t, x = _poses()
    ours = tgeom.camera_to_world(torch.from_numpy(x), torch.from_numpy(rv), torch.from_numpy(t))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jgeom.camera_to_world(*map(jnp.asarray, (x, rv, t)))),
                               rtol=1e-5, atol=1e-5)
    back = tgeom.world_to_camera(ours, torch.from_numpy(rv), torch.from_numpy(t))
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-4)


def test_reprojection_residual():
    rv, t, x = _poses()
    intr = np.float32([500.0, 480.0, 320.0, 240.0, -0.1, 0.02])
    uv = np.random.default_rng(1).uniform(0, 640, (16, 2)).astype(np.float32)
    ours = tgeom.reprojection_residual(*(torch.from_numpy(a) for a in (x, rv, t, intr, uv)))
    theirs = jgeom.reprojection_residual(*(jnp.asarray(a) for a in (x, rv, t, intr, uv)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-3)


def test_ba_cost():
    from sfm_tpu.ba import ba_cost as jba_cost, build_problem
    from sfm_tpu.config import BAConfig as JBAConfig
    from sfm_tpu.utils.synthetic import make_orbit_scene
    from sfm_tpu_torch.ba import ba_cost
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.utils.interop import from_numpy_problem
    from tests.unit.test_ba import scene_to_reconstruction

    scene = make_orbit_scene(num_cameras=6, num_points=80, noise_px=0.5, seed=4)
    jprob, _, _ = build_problem(scene_to_reconstruction(scene, pose_noise=0.01, point_noise=0.05, seed=5))
    for loss in ("none", "huber"):
        ours = float(ba_cost(from_numpy_problem(jprob), BAConfig(robust_loss=loss)))
        theirs = float(jba_cost(jprob, JBAConfig(robust_loss=loss)))
        assert ours == pytest.approx(theirs, rel=1e-5)


def test_refine_essential_gn():
    from sfm_tpu.ops import solvers as jsolvers
    from sfm_tpu_torch.ops import solvers
    from tests.unit.test_solvers import two_view_fixture

    _, _, _, x1, x2, _, _, _ = two_view_fixture(noise=1.0, seed=3)
    E0 = jsolvers.essential_8pt(x1, x2)
    w = jnp.ones(x1.shape[0])
    theirs = np.asarray(jsolvers.refine_essential_gn(E0, x1, x2, w, iters=5))
    t = lambda a: torch.from_numpy(np.array(a))
    ours = solvers.refine_essential_gn(t(E0), t(x1), t(x2), t(w), iters=5)

    def normalized(E):
        E = np.asarray(E, np.float64) / np.linalg.norm(E)
        return E * np.sign(E.flat[np.argmax(np.abs(E.flat))])

    np.testing.assert_allclose(normalized(ours.numpy()), normalized(theirs), atol=1e-3)
    e_ours = float(solvers.sampson_error(ours, t(x1), t(x2)).mean())
    e_theirs = float(jnp.mean(jsolvers.sampson_error(jnp.asarray(theirs), x1, x2)))
    e0 = float(jnp.mean(jsolvers.sampson_error(E0, x1, x2)))
    assert e_ours == pytest.approx(e_theirs, rel=1e-2) and e_ours <= e0 * 1.01
