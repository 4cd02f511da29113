"""Bundle adjustment: kernels K3, K5, K7, K9 and K11 (plain versions), the
PCG solver and the LM solve against sfm_tpu.ba.

Tolerances:
- normal-equation blocks vs sfm_tpu build_normal_equations (its plain path)
  and vs the fused_ne_payloads Pallas kernel in interpret mode (its
  payloads summed per point in float64, damped and inverted; its camera
  sums damped): 1e-4 of each block's max |value| (closed-form vs jacfwd
  Jacobians and another summation order, fp32);
- robust cost vs compute_cost: rtol 1e-5 (summation order);
- K9 plain version vs jax.ops.segment_sum: rtol 1e-6 (on the CPU both add
  each segment's rows in the same, original order);
- bundle_adjust on a noisy two-camera problem (dense) and a 12-camera one
  forced onto PCG: final cost within 1e-3 relative of sfm_tpu's (same LM
  schedule; rounding moves the iterates);
- K7 plain version vs sfm_tpu's whw_cam_reduce Pallas kernel in interpret
  mode: 2e-5 of the output's scale; K11 plain version vs
  schur_coupling_matvec in interpret mode: 3e-5 of scale (the kernels split
  fp32 into three bf16 terms for the MXU; tests/unit/test_ba.py's bars);
- the Schur-Jacobi preconditioner vs sfm_tpu's: 1e-4 of scale; _pcg vs
  sfm_tpu's _pcg on the same normal equations (each package builds its
  preconditioner from them): 1e-3 of the solution's scale (64 fp32 CG
  steps; summation order drifts the iterates), and residuals of the same
  size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import schur_matvec_step
from sfm_tpu.ba import core as jcore
from sfm_tpu.ba.problem import build_problem as jbuild_problem
from sfm_tpu.config import BAConfig as JBAConfig
from sfm_tpu.kernels import schur_spmv
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.kernels.ba_kernels import (
    cam_segment_sum, damp, fused_ne_payloads, invert_permutation, schur_coupling_matvec, segment_bounds,
    sym3, sym_solve3, whw_cam_reduce, whw_cam_reduce_plain,
)
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
    lam = torch.tensor(1e-3)
    Hcc, Hpp_inv, w_t, bc, bp, packed = fused_ne_payloads(
        prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params, prob.intrinsics, inv.point_bounds,
        inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, lam, inv.z_floor, "huber", 4.0)
    close(w_t, np.asarray(W_j)[:18], "W_t")
    # The Pallas kernel's per-observation point payload, summed per point in
    # float64, damped and inverted: K3's point blocks.
    yp = torch.from_numpy(np.asarray(Yp_j)[:9].astype(np.float64))
    red = cam_segment_sum(yp, None, segment_bounds(prob.obs_point, prob.num_points))
    close(Hpp_inv, sym_solve3(damp(sym3(red[:, :6]), lam.double())), "Hpp_inv")
    close(bp, red[:, 6:9], "bp")
    camred = torch.from_numpy(np.asarray(camred_j)[:, :42].astype(np.float64))
    close(Hcc, damp(camred[:, :36].reshape(C, 6, 6), lam.double()), "Hcc")
    close(bc, camred[:, 36:42], "bc")
    close(cam_segment_sum(packed.T.contiguous(), None, inv.cam_bounds), camred, "packed rows by camera")


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


def test_bundle_adjust_pcg_matches_jax():
    """A problem past the dense gate (dense_schur_max_cameras=0) takes PCG in
    both packages: the same LM schedule lands on the same cost."""
    jprob, prob = scene_problem(12, 300, 0.02, 0.05, seed=9)
    out_j, st_j = jcore.bundle_adjust(jprob, JBAConfig(dense_schur_max_cameras=0, max_iterations=8))
    cfg = BAConfig(dense_schur_max_cameras=0, max_iterations=8)
    assert not core.uses_dense_solver(prob, cfg) and core.uses_dense_solver(prob, BAConfig())
    out_t, st_t = core.bundle_adjust(prob, cfg)
    assert float(st_t.initial_cost) == pytest.approx(float(st_j.initial_cost), rel=1e-5)
    assert float(st_t.final_cost) == pytest.approx(float(st_j.final_cost), rel=1e-3)
    assert float(st_t.final_cost) < 0.05 * float(st_t.initial_cost)
    assert not out_t.cam_params[0].ne(prob.cam_params[0]).any()   # gauge camera fixed


def _random_whw_inputs(seed=2, O=2048, C=48, P=300):
    rng = np.random.default_rng(seed)
    W = rng.normal(size=(O, 18)).astype(np.float32)
    A = rng.normal(size=(P, 3, 3)).astype(np.float32)
    hinv = (A @ A.transpose(0, 2, 1)).astype(np.float32)          # SPD-ish blocks
    obs_point = np.sort(rng.integers(0, P, O)).astype(np.int32)
    ids = rng.integers(0, C, O).astype(np.int32)
    return W, hinv, obs_point, ids


def test_whw_cam_reduce_plain_matches_pallas_kernel():
    W, hinv, obs_point, ids = _random_whw_inputs()
    C = 48
    ref = np.asarray(schur_spmv.whw_cam_reduce(jnp.asarray(W.T), jnp.asarray(hinv[obs_point].reshape(-1, 9).T),
                                               jnp.asarray(ids), C, interpret=True))
    ids_t = torch.from_numpy(ids)
    perm = torch.argsort(ids_t, stable=True)
    got = whw_cam_reduce(torch.from_numpy(W.T.copy()), torch.from_numpy(hinv), torch.from_numpy(obs_point),
                         perm.to(torch.int32), segment_bounds(ids_t[perm], C),
                         invert_permutation(perm, len(ids))).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)


def test_schur_coupling_matvec_plain_matches_pallas_kernel():
    """tests/unit/test_ba.py's fixture: the port takes Hpp^-1 per point and
    point segments where the TPU kernel took a [9, O] gather and tile-local
    point ids."""
    jprob, prob = scene_problem(12, 300, 0.02, 0.05, seed=23)
    assert prob.point_align > 0
    ne = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, jnp.asarray(1e-3),
                                      JBAConfig(robust_loss="huber"))
    C, O, P = prob.num_cameras, prob.obs_w.shape[0], prob.num_points
    tile = schur_spmv.matvec_tile(C, prob.point_align)
    assert tile > 0 and O % tile == 0
    w_t = ne.W.reshape(O, 18).T
    op = jprob.obs_point.reshape(O // tile, tile)
    lids = (op - op[:, :1]).reshape(O)
    v = np.random.default_rng(3).normal(size=(C, 6)).astype(np.float32)
    ref = np.asarray(schur_spmv.schur_coupling_matvec(
        jprob.obs_cam, lids, w_t, ne.Hpp_inv.reshape(P, 9)[jprob.obs_point].T, jnp.asarray(v),
        tile=tile, interpret=True))
    inv = core.solve_invariants(prob)
    got = schur_coupling_matvec(torch.from_numpy(np.array(w_t)), torch.from_numpy(np.array(ne.Hpp_inv)),
                                prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
                                inv.cam_bounds, torch.from_numpy(v)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=3e-5)


def _jax_pcg_setup(seed=9):
    jprob, prob = scene_problem(12, 300, 0.02, 0.05, seed=seed)
    jcfg = JBAConfig(dense_schur_max_cameras=0)
    ne_j = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, jnp.asarray(1e-3), jcfg)
    return jprob, prob, jcfg, ne_j


def test_preconditioner_matches_jax(monkeypatch):
    jprob, prob, _, ne_j = _jax_pcg_setup()
    inv = core.solve_invariants(prob)
    ne_t = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                       BAConfig(dense_schur_max_cameras=0), inv, schur_jacobi=True)
    M_inv, sdiag = core.pcg_preconditioner(ne_t, prob, inv)
    close(sdiag, ne_j.sdiag, "sdiag")
    close(M_inv * sdiag[:, :, None] * sdiag[:, None, :],
          ne_j.M_inv * ne_j.sdiag[:, :, None] * ne_j.sdiag[:, None, :], "M_inv (equilibrated)")

    def refused(*args):
        raise AssertionError("the dense path built the PCG preconditioner")

    monkeypatch.setattr(core, "pcg_preconditioner", refused)   # the dense path never builds it
    core.bundle_adjust(prob, BAConfig(max_iterations=1))


def test_pcg_matches_jax():
    jprob, prob, jcfg, ne_j = _jax_pcg_setup()
    O = prob.obs_w.shape[0]
    ne_t = core.NormalEq(
        Hcc=torch.from_numpy(np.array(ne_j.Hcc)), Hpp_inv=torch.from_numpy(np.array(ne_j.Hpp_inv)),
        W_t=torch.from_numpy(np.array(ne_j.W.reshape(O, 18).T)), bc=torch.from_numpy(np.array(ne_j.bc)),
        bp=torch.from_numpy(np.array(ne_j.bp)))
    inv = core.solve_invariants(prob)
    ne_t = ne_t._replace(whw=whw_cam_reduce_plain(ne_t.W_t, ne_t.Hpp_inv, prob.obs_point, inv.cam_perm,
                                                  inv.cam_bounds))
    rhs = jcore._schur_rhs(ne_j, jprob)
    x_j = np.asarray(jcore._pcg(ne_j, jprob, rhs, jcfg))
    x_t = core._pcg(ne_t, prob, torch.from_numpy(np.array(rhs)), BAConfig(dense_schur_max_cameras=0), inv)
    close(x_t, x_j, "x", tol=1e-3)
    S_x = schur_matvec_step(ne_t, prob, x_t, inv).numpy()
    S_xj = schur_matvec_step(ne_t, prob, torch.from_numpy(np.array(x_j)), inv).numpy()
    r_t = np.linalg.norm(S_x - np.asarray(rhs))
    r_j = np.linalg.norm(S_xj - np.asarray(rhs))
    assert r_t < 1e-2 * np.linalg.norm(np.asarray(rhs)) and r_t < 2.0 * r_j + 1e-6


def test_build_problem_requires_device():
    from sfm_tpu_torch.ba.problem import build_problem
    from sfm_tpu_torch.utils.interop import from_numpy_reconstruction

    scene = make_orbit_scene(num_cameras=3, num_points=40, noise_px=0.5, seed=1)
    obs = np.argwhere(scene.visible)
    rec = from_numpy_reconstruction(dict(
        intrinsics=scene.intrinsics, rvecs=scene.rvecs, tvecs=scene.tvecs, registered=np.ones(3, bool),
        image_sizes=None, points=scene.points, point_errors=np.zeros(40, np.float32),
        point_valid=np.ones(40, bool), obs_point=obs[:, 1].astype(np.int32),
        obs_image=obs[:, 0].astype(np.int32), obs_kp=obs[:, 1].astype(np.int32),
        obs_uv=scene.pixels[obs[:, 0], obs[:, 1]], image_names=[]))
    with pytest.raises(TypeError):
        build_problem(rec)
    prob, _, _ = build_problem(rec, device="cpu")
    assert prob.obs_w.device.type == "cpu"


def test_intrinsics_refinement_matches_jax(ne_problem):
    """The same problem with 8-wide camera blocks (log focal scale and dk1
    at zero) solves with focal and k1 refined and lands on sfm_tpu's cost
    (its BA runs the 8-wide case as plain XLA)."""
    jprob, prob = ne_problem
    wide = prob._replace(cam_params=torch.cat([prob.cam_params, torch.zeros(prob.num_cameras, 2)], 1))
    jwide = jprob._replace(cam_params=jnp.concatenate(
        [jprob.cam_params, jnp.zeros((jprob.num_cameras, 2), jnp.float32)], 1))
    kw = dict(refine_focal=True, refine_distortion=True, max_iterations=6)
    out_j, st_j = jcore.bundle_adjust(jwide, JBAConfig(**kw))
    out_t, st_t = core.bundle_adjust(wide, BAConfig(**kw))
    assert out_t.cam_params.shape == (prob.num_cameras, 8)
    assert float(st_t.initial_cost) == pytest.approx(float(st_j.initial_cost), rel=1e-5)
    assert float(st_t.final_cost) == pytest.approx(float(st_j.final_cost), rel=1e-3)
    assert float(st_t.final_cost) < 0.5 * float(st_t.initial_cost)
    fixed = wide.cam_fixed.numpy()
    assert not out_t.cam_params[fixed].ne(wide.cam_params[fixed]).any()


def test_segment_tables_leave_out_the_padding_tail(ne_problem):
    """The zero-weight capacity tail (one long segment of the last point slot
    and camera 0) is left out of the segment tables, and the camera tables
    list the weighted observations only (the zero-weight rows in between all
    carry camera 0); the sums are the same as over every row."""
    _, prob = ne_problem
    O = prob.obs_w.shape[0]
    n = int(torch.nonzero(prob.obs_w).max()) + 1
    assert n < O
    inv = core.solve_invariants(prob)
    weighted = torch.nonzero(prob.obs_w).flatten()
    assert inv.cam_inv_perm.numel() == n == int(inv.point_bounds[-1])
    assert inv.cam_perm.numel() == weighted.numel() == int(inv.cam_bounds[-1])
    assert torch.equal(inv.cam_perm.long().sort().values, weighted)
    assert torch.equal(inv.cam_inv_perm[inv.cam_perm.long()].long(), torch.arange(weighted.numel()))
    assert int((inv.cam_inv_perm < 0).sum()) == n - weighted.numel()
    full_perm = torch.argsort(prob.obs_cam, stable=True)
    full = inv._replace(point_bounds=segment_bounds(prob.obs_point, prob.num_points),
                        cam_perm=full_perm.to(torch.int32),
                        cam_bounds=segment_bounds(prob.obs_cam[full_perm], prob.num_cameras))
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3), BAConfig(), inv,
                                     schur_jacobi=True)
    ne_full = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                          BAConfig(), full, schur_jacobi=True)
    for a, b in zip((*ne, *core.pcg_preconditioner(ne, prob, inv)),
                    (*ne_full, *core.pcg_preconditioner(ne_full, prob, full))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    v = torch.from_numpy(np.random.default_rng(4).normal(size=(prob.num_cameras, 6)).astype(np.float32))
    torch.testing.assert_close(schur_matvec_step(ne, prob, v, inv),
                               schur_matvec_step(ne, prob, v, full), rtol=0, atol=0)


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
