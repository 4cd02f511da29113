"""Bundle adjustment: kernels K3, K5 and K9 (plain versions) and the LM
solve against sfm_tpu.ba.

Tolerances:
- normal-equation blocks vs sfm_tpu build_normal_equations (its plain path)
  and vs the fused_ne_payloads Pallas kernel in interpret mode: 1e-4 of
  each block's max |value| (closed-form vs jacfwd Jacobians and another
  summation order, fp32);
- robust cost vs compute_cost: rtol 1e-5 (summation order);
- K9 plain version vs jax.ops.segment_sum: rtol 1e-6 (on the CPU both add
  each segment's rows in the same, original order);
- bundle_adjust on a noisy two-camera problem: final cost within 1e-3
  relative of sfm_tpu's (same LM schedule; rounding moves the iterates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba import core as jcore
from sfm_tpu.ba.problem import build_problem as jbuild_problem
from sfm_tpu.config import BAConfig as JBAConfig
from sfm_tpu.kernels import schur_spmv
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.kernels.ba_kernels import cam_segment_sum, fused_ne_payloads, segment_bounds
from sfm_tpu_torch.utils.interop import from_numpy_problem, to_numpy

torch.set_num_threads(2)


def scene_problem(num_cameras, num_points, pose_noise, point_noise, seed, free_cams=None):
    scene = make_orbit_scene(num_cameras=num_cameras, num_points=num_points, noise_px=0.5, seed=seed)
    rng = np.random.default_rng(seed + 1)
    obs = np.argwhere(scene.visible)
    K, M = scene.num_cameras, scene.num_points
    rvecs = scene.rvecs + rng.normal(0, pose_noise, (K, 3)).astype(np.float32)
    tvecs = scene.tvecs + rng.normal(0, pose_noise, (K, 3)).astype(np.float32)
    rvecs[0], tvecs[0] = scene.rvecs[0], scene.tvecs[0]
    rec = JReconstruction(
        intrinsics=scene.intrinsics.copy(), rvecs=rvecs, tvecs=tvecs, registered=np.ones(K, bool),
        points=scene.points + rng.normal(0, point_noise, (M, 3)).astype(np.float32),
        point_errors=np.zeros(M, np.float32), point_valid=np.ones(M, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=scene.pixels[obs[:, 0], obs[:, 1]].astype(np.float32),
    )
    prob, _, _ = jbuild_problem(rec, free_cams=free_cams)
    return prob, from_numpy_problem(prob)


def close(a, b, name, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def ne_problem():
    return scene_problem(8, 300, 0.02, 0.05, seed=9, free_cams=np.array([3, 4, 5, 6, 7]))


def test_normal_equations_match_jax(ne_problem):
    jprob, prob = ne_problem
    jcfg = JBAConfig(robust_loss="huber", robust_scale_px=4.0)
    ne_j = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, 1e-3, jcfg)
    inv = core.solve_invariants(prob)
    ne_t = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                       BAConfig(robust_loss="huber", robust_scale_px=4.0), inv)
    O = prob.obs_w.shape[0]
    close(ne_t.W_t.T.reshape(O, 6, 3), ne_j.W, "W")
    close(ne_t.Hcc, ne_j.Hcc, "Hcc")
    close(ne_t.bc, ne_j.bc, "bc")
    close(ne_t.Hpp_inv, ne_j.Hpp_inv, "Hpp_inv")
    close(ne_t.bp, ne_j.bp, "bp")
    # The reduced system the dense solve factors.
    rhs_j = jcore._schur_rhs(ne_j, jprob)
    close(core._schur_rhs(ne_t, prob, inv), rhs_j, "rhs")
    v = np.random.default_rng(0).normal(size=(prob.num_cameras, 6)).astype(np.float32)
    close(core._schur_matvec(ne_t, prob, torch.from_numpy(v)[None], inv)[0],
          jcore._schur_matvec(ne_j, jprob, jnp.asarray(v), use_kernel=False), "S v")


@pytest.mark.parametrize("z_floor", [None, 4.0])
def test_ne_payloads_match_pallas_kernel(ne_problem, z_floor):
    jprob, prob = ne_problem
    C, O = prob.num_cameras, prob.obs_w.shape[0]
    pad = jnp.zeros((C, 2), jnp.float32)
    pts_t = jnp.concatenate([jnp.take(jprob.points.T, jprob.obs_point, axis=1), jnp.zeros((1, O))], 0)
    zf = None if z_floor is None else jnp.asarray(z_floor, jnp.float32)
    W_j, Yp_j, camred_j = schur_spmv.fused_ne_payloads(
        jprob.obs_cam, pts_t, jcore._ne_static_misc(jprob),
        jnp.concatenate([jprob.cam_params, pad], 1), jnp.concatenate([jprob.intrinsics, pad], 1),
        C, "huber", 4.0, z_floor=zf, interpret=True)
    inv = core.solve_invariants(prob, None if z_floor is None else torch.tensor(z_floor))
    w_t, yp_t, cam_t = fused_ne_payloads(prob.obs_cam, core._pts_t(prob, prob.points), inv.static_t,
                                         prob.cam_params, prob.intrinsics, inv.z_floor, "huber", 4.0)
    close(w_t, np.asarray(W_j)[:18], "W_t")
    close(yp_t, np.asarray(Yp_j)[:9], "Yp_t")
    close(cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds), np.asarray(camred_j)[:, :42], "camred")


@pytest.mark.parametrize("z_floor", [None, 4.0])
@pytest.mark.parametrize("loss", ["none", "huber", "cauchy"])
def test_cost_matches_jax(ne_problem, loss, z_floor):
    jprob, prob = ne_problem
    zf = None if z_floor is None else jnp.asarray(z_floor, jnp.float32)
    ref = float(jcore.compute_cost(jprob, jprob.cam_params, jprob.points, JBAConfig(robust_loss=loss), z_floor=zf))
    inv = core.solve_invariants(prob, None if z_floor is None else torch.tensor(z_floor))
    got = float(core.compute_cost(prob, prob.cam_params, prob.points, BAConfig(robust_loss=loss), inv))
    assert got == pytest.approx(ref, rel=1e-5)


def test_segment_sum_plain_matches_jax():
    rng = np.random.default_rng(0)
    O, K, C = 4096, 42, 96
    v = rng.normal(size=(O, K)).astype(np.float32)
    ids = rng.integers(0, C, O).astype(np.int32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(ids), C))
    ids_t = torch.from_numpy(ids)
    perm = torch.argsort(ids_t, stable=True)
    out = cam_segment_sum(torch.from_numpy(v.T.copy()), perm.to(torch.int32),
                          segment_bounds(ids_t[perm], C))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_bundle_adjust_matches_jax():
    jprob, prob = scene_problem(2, 200, 0.01, 0.03, seed=12)
    out_j, st_j = jcore.bundle_adjust(jprob, JBAConfig())
    out_t, st_t = core.bundle_adjust(prob, BAConfig())
    assert float(st_t.initial_cost) == pytest.approx(float(st_j.initial_cost), rel=1e-5)
    assert float(st_t.final_cost) == pytest.approx(float(st_j.final_cost), rel=1e-3)
    assert float(st_t.final_cost) < 0.5 * float(st_t.initial_cost)
    np.testing.assert_allclose(to_numpy(out_t)["cam_params"], np.asarray(out_j.cam_params), atol=1e-3)
    assert not out_t.cam_params[0].ne(prob.cam_params[0]).any()   # gauge camera fixed


def test_pcg_sized_problem_is_refused(ne_problem):
    _, prob = ne_problem
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        core.bundle_adjust(prob, BAConfig(dense_schur_max_cameras=4))


def test_kernel_input_checks():
    """The wrappers' argument checks (run before any CUDA launch)."""
    from sfm_tpu_torch.kernels import check, on_cuda

    t = torch.zeros((3, 4))
    check(t, "t", torch.float32, (3, None), t.device)
    for bad in [(t.double(), (3, 4)), (t, (4, 3)), (t.T, (4, 3))]:
        with pytest.raises(ValueError):
            check(bad[0], "t", torch.float32, bad[1], t.device)
    assert on_cuda(t) is False
    with pytest.raises(ValueError):
        on_cuda(torch.zeros(2, device="meta"))


def test_problem_interop_round_trip(ne_problem):
    jprob, prob = ne_problem
    arrays = to_numpy(prob)
    again = from_numpy_problem(arrays)
    assert again.point_align == jprob.point_align == prob.point_align
    for name in ("cam_params", "obs_cam", "obs_point", "obs_w", "cam_fixed"):
        np.testing.assert_array_equal(to_numpy(getattr(again, name)), np.asarray(getattr(jprob, name)))
