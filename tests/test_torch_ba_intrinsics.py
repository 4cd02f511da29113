"""Intrinsics refinement: 8-wide camera blocks (rvec, tvec, log focal scale,
dk1) through the port's bundle adjustment, against sfm_tpu.ba, which runs
the 8-wide case as plain XLA (none of its Pallas kernels takes it). On the
CPU the port's kernels K3, K5, K7, K11 and pcg_solve run their plain
versions at width 8; chip_smoke.py phase 11 holds the CUDA builds against
them on the card.

Tolerances (the 6-wide tests' bars for the same quantities,
tests/test_torch_ba.py and tests/test_torch_ba_fused.py):
- (a) residual_jac_analytic vs sfm_tpu's _residual_jac_analytic: the
  residual within 1e-5 of max |r|; Jc and Jp within 1e-4 of each block's
  max |value| (closed-form vs jacfwd rotation derivative, fp32);
- (b) K3's plain version vs sfm_tpu build_normal_equations: Hcc and Hpp^-1
  within 1e-4 of each block's max |value|, W, bc and bp within 1e-4 of the
  array's max; the Schur-Jacobi preconditioner (inverse blocks and
  equilibration) within 1e-4 of scale;
- (c) K5's plain version with a step vs sfm_tpu's LM body (dp from the
  whole dc, then the frozen intrinsic columns zeroed in the camera update):
  dp within 1e-4 of max |dp|, the candidate cameras bit-identical, the
  cost rel 1e-5, for each freeze setting; the candidate points do not
  depend on the freeze setting;
- (d) pcg_solve's plain version vs sfm_tpu's _pcg: 1e-3 of the solution's
  scale (64 fp32 CG steps), and a residual within 2x sfm_tpu's;
- (e) bundle_adjust on tests/unit/test_ba.py's refinement fixture (8
  cameras, rendered at focal 600 and k1 -0.05, believed 570 and 0), dense
  and through PCG: the final cost within 1e-3 relative of sfm_tpu's, and
  its recovery bars: mean reprojection error < 0.5 px, focal within 1.5%
  of 600, k1 < -0.02;
- (f) with refine_focal=False the focal comes back bit-identical, with
  refine_distortion=False k1 (tests/unit/test_ba.py's freeze test);
- (g) the engine's global BA (_run_ba) with refine_focal on a small engine
  state (6 cameras, the prior 4% under the rendered focal): the refined
  focal within 1e-3 relative of sfm_tpu's and within 1.5% of the truth;
- (h) an 8-wide problem past MAX_CAMS cameras takes the large-camera-count
  route at width 8 (K4, K6, K8 and pcg_solve) and one LM iteration gives
  finite cameras and points, the frozen k1 column unmoved
  (tests/test_torch_ba_bigc_wide.py holds that route against sfm_tpu).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.ba import core as jcore
from sfm_tpu.ba.problem import build_problem as jbuild_problem
from sfm_tpu.config import BAConfig as JBAConfig, EngineConfig, PipelineConfig
from sfm_tpu.pipeline import engine as jengine
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu.scene.tracks import build_tracks as jbuild_tracks
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.problem import BAProblem, writeback
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.kernels import ba_kernels as kb
from sfm_tpu_torch.pipeline import engine
from sfm_tpu_torch.utils.interop import (
    from_numpy_feature_set, from_numpy_problem, from_numpy_reconstruction, from_numpy_tracks,
)
from tests.integration.test_incremental import scene_to_features_and_graph

torch.set_num_threads(2)


def close(a, b, name, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, err_msg=name)


def close_blocks(a, b, name, tol=1e-4):
    """Each block a[i] within tol of the block b[i]'s max |value|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).reshape(len(b), -1).max(1)
    scale = np.maximum(np.abs(b).reshape(len(b), -1).max(1), 1e-30)
    worst = int(np.argmax(err / scale))
    assert err[worst] <= tol * scale[worst], (name, worst, err[worst] / scale[worst])


def scene_to_reconstruction(scene, pose_noise=0.0, point_noise=0.0, seed=0) -> JReconstruction:
    """tests/unit/test_ba.py's fixture: the scene fully observed, poses and
    points perturbed, camera 0 exact."""
    rng = np.random.default_rng(seed)
    K, M = scene.num_cameras, scene.num_points
    obs = np.argwhere(scene.visible)
    rvecs = scene.rvecs + rng.normal(0, pose_noise, (K, 3)).astype(np.float32)
    tvecs = scene.tvecs + rng.normal(0, pose_noise, (K, 3)).astype(np.float32)
    rvecs[0], tvecs[0] = scene.rvecs[0], scene.tvecs[0]
    return JReconstruction(
        intrinsics=scene.intrinsics.copy(), rvecs=rvecs, tvecs=tvecs, registered=np.ones(K, bool),
        points=scene.points + rng.normal(0, point_noise, (M, 3)).astype(np.float32),
        point_errors=np.zeros(M, np.float32), point_valid=np.ones(M, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=scene.pixels[obs[:, 0], obs[:, 1]].astype(np.float32))


def port_reconstruction(rec: JReconstruction):
    return from_numpy_reconstruction({**{k: getattr(rec, k) for k in (
        "intrinsics", "rvecs", "tvecs", "registered", "points", "point_errors", "point_valid",
        "obs_point", "obs_image", "obs_kp", "obs_uv")}, "image_sizes": None, "image_names": []})


@pytest.fixture(scope="module")
def wide_problem():
    """tests/test_torch_ba_fused.py's orbit (8 cameras, 300 points, 5%
    outliers, cameras 0-2 and every seventh point frozen, every eleventh
    observation weightless), built 8-wide with nonzero intrinsic columns."""
    scene = make_orbit_scene(num_cameras=8, num_points=300, noise_px=0.5, seed=4)
    rng = np.random.default_rng(5)
    obs = np.argwhere(scene.visible)
    K, M = scene.num_cameras, scene.num_points
    uv = scene.pixels[obs[:, 0], obs[:, 1]].copy()
    out = rng.random(len(uv)) < 0.05
    uv[out] += rng.normal(0, 20, (int(out.sum()), 2)).astype(np.float32)
    rec = JReconstruction(
        intrinsics=scene.intrinsics.copy(),
        rvecs=scene.rvecs + rng.normal(0, 0.02, (K, 3)).astype(np.float32),
        tvecs=scene.tvecs + rng.normal(0, 0.02, (K, 3)).astype(np.float32),
        registered=np.ones(K, bool),
        points=scene.points + rng.normal(0, 0.05, (M, 3)).astype(np.float32),
        point_errors=np.zeros(M, np.float32), point_valid=np.ones(M, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32), obs_uv=uv.astype(np.float32),
    )
    jprob, _, _ = jbuild_problem(rec, free_cams=np.arange(3, K), refine_intrinsics=True)
    cams = np.array(jprob.cam_params)
    cams[:, 6] = rng.normal(0, 0.02, len(cams))     # focal scales about 2% off
    cams[:, 7] = rng.normal(0, 0.01, len(cams))     # dk1
    point_fixed = np.array(jprob.point_fixed)
    point_fixed[::7] = True
    obs_w = np.array(jprob.obs_w)
    obs_w[5::11] = 0.0
    jprob = jprob._replace(cam_params=jnp.asarray(cams), point_fixed=jnp.asarray(point_fixed),
                           obs_w=jnp.asarray(obs_w))
    return jprob, from_numpy_problem(jprob)


def _jax_ne(jprob, lam=1e-3, loss="huber"):
    jcfg = JBAConfig(robust_loss=loss, robust_scale_px=4.0)
    return jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points,
                                        jnp.asarray(lam, jnp.float32), jcfg)


# ---- (a) the 8-wide residual and Jacobian ------------------------------------


def test_residual_jacobian_match_jax_at_width_8():
    """tests/unit/test_ba.py's random cameras (rng 40), 8 wide."""
    rng = np.random.default_rng(40)
    n = 32
    cams = np.zeros((n, 8), np.float32)
    cams[:, :3] = rng.normal(0, 0.6, (n, 3))
    cams[:, 3:6] = rng.normal(0, 1.0, (n, 3)) + [0, 0, 4]
    cams[:, 6] = rng.normal(0, 0.05, n)
    cams[:, 7] = rng.normal(0, 0.02, n)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    intr = np.tile(np.asarray([600, 590, 320, 240, -0.1, 0.02], np.float32), (n, 1))
    uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    r_j, Jc_j, Jp_j = jax.vmap(jcore._residual_jac_analytic)(*map(jnp.asarray, (cams, pts, intr, uv)))
    r, Jc, Jp, depth = core.residual_jac_analytic(*map(torch.from_numpy, (cams, pts, intr, uv)))
    assert Jc.shape == (n, 2, 8)
    close(r, r_j, "r", tol=1e-5)
    close_blocks(Jc, Jc_j, "Jc")
    close_blocks(Jp, Jp_j, "Jp")
    # The focal column is f x s = uv_hat - c, with the refined focal.
    close(Jc[:, :, 6], np.asarray(r_j) + (uv - intr[:, 2:4]), "dr/dc6 = uv_hat - c")
    assert depth.shape == (n,)


# ---- (b) K3's plain version at width 8 ---------------------------------------


def test_k3_plain_matches_jax_normal_equations_at_width_8(wide_problem):
    jprob, prob = wide_problem
    ne_j = _jax_ne(jprob)
    inv = core.solve_invariants(prob)
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                     BAConfig(robust_loss="huber", robust_scale_px=4.0), inv,
                                     schur_jacobi=True)
    O, C = prob.obs_w.shape[0], prob.num_cameras
    assert ne.Hcc.shape == (C, 8, 8) and ne.W_t.shape == (24, O) and ne.bc.shape == (C, 8)
    close(ne.W_t.T.reshape(O, 8, 3), ne_j.W, "W")
    close_blocks(ne.Hcc, ne_j.Hcc, "Hcc")
    close(ne.bc, ne_j.bc, "bc")
    close_blocks(ne.Hpp_inv, ne_j.Hpp_inv, "Hpp_inv")
    close(ne.bp, ne_j.bp, "bp")
    assert not ne.bc[:3].any()                                   # cameras 0-2 frozen
    assert float(ne.Hcc[3:, 6, 6].min()) > 0 and float(ne.Hcc[3:, 7, 7].min()) > 0
    # The Schur-Jacobi blocks K3 returns, and the preconditioner made of them.
    assert ne.whw.shape == (C, 64)
    assert torch.equal(ne.whw, kb.whw_cam_reduce_plain(ne.W_t, ne.Hpp_inv, prob.obs_point, inv.cam_perm,
                                                       inv.cam_bounds))
    M_inv, sdiag = core.pcg_preconditioner(ne, prob, inv)
    close(sdiag, ne_j.sdiag, "sdiag")
    close(M_inv * sdiag[:, :, None] * sdiag[:, None, :],
          ne_j.M_inv * ne_j.sdiag[:, :, None] * ne_j.sdiag[:, None, :], "M_inv (equilibrated)")


# ---- (c) K5's plain version: the column freeze after dp -----------------------


@pytest.mark.parametrize("refine_focal,refine_distortion", [(True, True), (False, True), (True, False),
                                                            (False, False)])
def test_k5_candidate_freezes_columns_after_back_substitution(wide_problem, refine_focal,
                                                              refine_distortion):
    """sfm_tpu's LM body: dp = Hpp^-1 (bp - W^T dc) from the whole dc, then
    dc[:, 6] / dc[:, 7] zeroed for the camera update. The frozen columns'
    W rows are not zero, so zeroing them before the back-substitution would
    move the points."""
    jprob, prob = wide_problem
    ne_j = _jax_ne(jprob)
    C, O = prob.num_cameras, prob.obs_w.shape[0]
    dc = (1e-3 * np.random.default_rng(6).normal(size=(C, 8))).astype(np.float32)
    dp_j = jcore._back_substitute(ne_j, jprob, jnp.asarray(dc))
    dc_j = jnp.where(jprob.cam_fixed[:, None], 0.0, dc)
    dp_j = jnp.where(jprob.point_fixed[:, None], 0.0, dp_j)
    if not refine_focal:
        dc_j = dc_j.at[:, 6].set(0.0)
    if not refine_distortion:
        dc_j = dc_j.at[:, 7].set(0.0)
    jcfg = JBAConfig(robust_loss="huber", robust_scale_px=4.0)
    cost_j = float(jcore.compute_cost(jprob, jprob.cam_params + dc_j, jprob.points + dp_j, jcfg))
    inv = core.solve_invariants(prob)
    t = lambda a: torch.from_numpy(np.array(a))
    step = kb.LMStep(torch.from_numpy(dc), t(ne_j.W.reshape(O, 24).T), t(ne_j.Hpp_inv), t(ne_j.bp),
                     prob.cam_fixed, prob.point_fixed, freeze_focal=not refine_focal,
                     freeze_distortion=not refine_distortion)
    args = (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params, prob.intrinsics,
            inv.point_bounds, None, "huber", 4.0)
    new_cams, new_points, sums = kb.fused_cost_sums(*args, step=step)
    close(new_points - prob.points, dp_j, "dp")
    assert torch.equal(new_cams, t(jprob.cam_params + dc_j))
    assert float(sums[2]) == pytest.approx(cost_j, rel=1e-5)
    if not refine_focal:
        assert torch.equal(new_cams[:, 6], prob.cam_params[:, 6])
    if not refine_distortion:
        assert torch.equal(new_cams[:, 7], prob.cam_params[:, 7])
    free = kb.fused_cost_sums(*args, step=step._replace(freeze_focal=False, freeze_distortion=False))
    assert torch.equal(new_points, free[1])


# ---- (d) pcg_solve's plain version at width 8 --------------------------------


def test_pcg_matches_jax_at_width_8(wide_problem):
    jprob, prob = wide_problem
    jcfg = JBAConfig(robust_loss="huber", robust_scale_px=4.0, dense_schur_max_cameras=0)
    ne_j = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, jnp.asarray(1e-3), jcfg)
    rhs_j = jcore._schur_rhs(ne_j, jprob)
    x_j = np.asarray(jcore._pcg(ne_j, jprob, rhs_j, jcfg))
    cfg = BAConfig(robust_loss="huber", robust_scale_px=4.0, dense_schur_max_cameras=0)
    inv = core.solve_invariants(prob)
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3), cfg, inv,
                                     schur_jacobi=True)
    rhs = core._schur_rhs(ne, prob, inv)
    close(rhs, rhs_j, "rhs")
    x = core._pcg(ne, prob, rhs, cfg, inv)
    assert x.shape == (prob.num_cameras, 8)
    close(x, x_j, "x", tol=1e-3)
    S = lambda v: (torch.einsum("cij,cj->ci", ne.Hcc, v) - kb.schur_coupling_matvec(
        ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm, inv.cam_bounds, v,
        inv.cam_inv_perm))
    r_t = float((S(x) - rhs).norm())
    r_j = float((S(torch.from_numpy(x_j)) - rhs).norm())
    assert r_t < 1e-2 * float(rhs.norm()) and r_t < 2.0 * r_j + 1e-6


# ---- (e), (f) bundle_adjust with refinement ----------------------------------


@pytest.fixture(scope="module")
def refine_case():
    """tests/unit/test_ba.py test_ba_refines_intrinsics: rendered at focal
    600 and k1 -0.05, believed 570 and 0."""
    scene = make_orbit_scene(num_cameras=8, num_points=120, noise_px=0.2, seed=11, k1=-0.05)
    rec = scene_to_reconstruction(scene, pose_noise=0.002, point_noise=0.01, seed=12)
    rec.intrinsics[:, 0] = 570.0
    rec.intrinsics[:, 1] = 570.0
    rec.intrinsics[:, 4] = 0.0
    return rec


@pytest.mark.parametrize("dense", [True, False])
def test_bundle_adjust_recovers_intrinsics_like_jax(refine_case, dense):
    kw = dict(max_iterations=40, robust_loss="none", refine_focal=True, refine_distortion=True,
              **({} if dense else {"dense_schur_max_cameras": 0}))
    jprob, _, _ = jbuild_problem(refine_case, refine_intrinsics=True)
    _, st_j = jcore.bundle_adjust(jprob, JBAConfig(**kw))
    rec = port_reconstruction(refine_case)
    prob, cams, pts = _build(rec)
    cfg = BAConfig(**kw)
    assert core.uses_dense_solver(prob, cfg) == dense
    out, st = core.bundle_adjust(prob, cfg)
    assert float(st.initial_cost) == pytest.approx(float(st_j.initial_cost), rel=1e-5)
    assert float(st.final_cost) == pytest.approx(float(st_j.final_cost), rel=1e-3)
    writeback(rec, out, cams, pts)
    assert rec.mean_reprojection_error() < 0.5
    np.testing.assert_allclose(rec.intrinsics[1:, 0], 600.0, rtol=0.015)
    assert np.all(rec.intrinsics[1:, 4] < -0.02)


def _build(rec):
    from sfm_tpu_torch.ba.problem import build_problem

    return build_problem(rec, refine_intrinsics=True, device="cpu")


@pytest.mark.parametrize("frozen", ["focal", "distortion"])
def test_freeze_flags_keep_the_column_bit_identical(frozen):
    scene = make_orbit_scene(num_cameras=6, num_points=60, noise_px=0.2, seed=13)
    rec = port_reconstruction(scene_to_reconstruction(scene, pose_noise=0.005, point_noise=0.02, seed=14))
    rec.intrinsics[:, 0] *= 0.98
    rec.intrinsics[:, 1] *= 0.98
    before = rec.intrinsics.copy()
    prob, cams, pts = _build(rec)
    cfg = BAConfig(max_iterations=10, robust_loss="none", refine_focal=frozen != "focal",
                   refine_distortion=frozen != "distortion")
    out, _ = core.bundle_adjust(prob, cfg)
    writeback(rec, out, cams, pts)
    col, other = (0, 4) if frozen == "focal" else (4, 0)
    np.testing.assert_array_equal(rec.intrinsics[:, col], before[:, col])
    assert np.any(rec.intrinsics[1:, other] != before[1:, other])   # the refined column moved


# ---- (g) the engine's global BA with refinement ------------------------------


def _engine_states(focal_scale=0.96):
    """Both packages' engine states on a 6-camera orbit whose features are
    the rendered projections (0.2 px noise): every camera registered at a
    slightly perturbed pose, one point per track, the intrinsics prior at
    focal_scale of the rendered focal."""
    scene = make_orbit_scene(num_cameras=6, num_points=80, noise_px=0.0, seed=21)
    feats, graph = scene_to_features_and_graph(scene, noise=0.2, seed=22)
    B = scene.num_cameras
    tracks = jbuild_tracks(graph, B, feats.xy.shape[1])
    # Keypoint k of image i is the k-th point image i sees.
    vis = [np.where(scene.visible[i])[0] for i in range(B)]
    first = np.searchsorted(tracks.track_id, np.arange(tracks.num_tracks))
    track_point = np.array([vis[tracks.obs_image[r]][tracks.obs_kp[r]] for r in first], np.int32)
    rng = np.random.default_rng(23)
    intr = scene.intrinsics.copy()
    intr[:, :2] *= focal_scale
    fields = dict(
        intrinsics=intr,
        rvecs=(scene.rvecs + rng.normal(0, 0.003, (B, 3))).astype(np.float32),
        tvecs=(scene.tvecs + rng.normal(0, 0.003, (B, 3))).astype(np.float32),
        registered=np.ones(B, bool), failed=np.zeros(B, bool), track_point=track_point,
        points=(scene.points + rng.normal(0, 0.01, scene.points.shape)).astype(np.float32),
        point_valid=np.ones(scene.num_points, bool), num_points=scene.num_points,
        obs_alive=np.ones(len(tracks.obs_image), bool))
    fields["rvecs"][0], fields["tvecs"][0] = scene.rvecs[0], scene.tvecs[0]
    copy = lambda d: {k: v.copy() if isinstance(v, np.ndarray) else v for k, v in d.items()}
    jst = jengine.EngineState(feats=feats, tracks=tracks, **copy(fields))
    tst = engine.EngineState(feats=from_numpy_feature_set(feats), tracks=from_numpy_tracks(tracks),
                             **copy(fields))
    return scene, jst, tst


def test_engine_global_ba_refines_focal_like_jax():
    scene, jst, tst = _engine_states()
    jcfg = PipelineConfig(ba=JBAConfig(max_iterations=30, refine_focal=True), engine=EngineConfig(),
                          verbose=False)
    from sfm_tpu.config import config_to_dict

    tcfg = tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(jcfg))
    jengine._run_ba(jst, jcfg)
    engine._run_ba(tst, tcfg, torch.device("cpu"))
    truth = scene.intrinsics[0, 0]
    assert tst.intrinsics[0, 0] == jst.intrinsics[0, 0] == pytest.approx(0.96 * truth)   # the gauge camera
    np.testing.assert_allclose(tst.intrinsics[1:, 0], jst.intrinsics[1:, 0], rtol=1e-3)
    np.testing.assert_allclose(tst.intrinsics[1:, 0], truth, rtol=0.015)
    np.testing.assert_array_equal(tst.intrinsics[:, 4], jst.intrinsics[:, 4])       # k1 not refined
    np.testing.assert_allclose(tst.rvecs, jst.rvecs, atol=1e-3)


# ---- (h) past MAX_CAMS: the large-camera-count route at width 8 -------------


def test_wide_problem_past_max_cams_takes_big_route(monkeypatch):
    C, P, O = kb.MAX_CAMS + 1, 4, 8
    stub = BAProblem(
        cam_params=torch.zeros(C, 8), intrinsics=torch.tensor([[500.0, 500.0, 0, 0, 0, 0]]).repeat(C, 1),
        points=torch.tensor([[0.0, 0.0, 5.0]]).repeat(P, 1),
        obs_cam=torch.arange(O, dtype=torch.int32), obs_point=(torch.arange(O) // 2).to(torch.int32),
        obs_uv=torch.zeros(O, 2), obs_w=torch.ones(O), cam_fixed=torch.zeros(C, dtype=torch.bool),
        point_fixed=torch.zeros(P, dtype=torch.bool))
    assert core.uses_big_kernels(stub)
    calls = []
    for name in ("fused_ne_payloads_big", "fused_cost_sums_big", "whw_payloads_big", "pcg_solve",
                 "fused_ne_payloads", "fused_cost_sums"):
        fn = getattr(core, name)
        monkeypatch.setattr(core, name, lambda *a, _fn=fn, _name=name, **k: calls.append(_name) or _fn(*a, **k))
    out, stats = core.bundle_adjust(stub, BAConfig(refine_focal=True, refine_distortion=False, max_iterations=1))
    assert stats.iterations == 1 and sorted(set(calls)) == [
        "fused_cost_sums_big", "fused_ne_payloads_big", "pcg_solve", "whw_payloads_big"]
    assert torch.isfinite(out.cam_params).all() and torch.isfinite(out.points).all()
    assert torch.isfinite(stats.final_cost) and out.cam_params.shape == (C, 8)
    assert torch.equal(out.cam_params[:, 7], stub.cam_params[:, 7])
