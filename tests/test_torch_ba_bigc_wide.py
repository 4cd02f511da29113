"""The large-camera-count BA route at width 8 (intrinsics refinement past
4096 cameras: K4, K6, K8 and K10 at D = 8, pcg_solve at D = 8), against
sfm_tpu, which runs an 8-wide BA as plain XLA at any camera count.

Tolerances:
- (i) the plain versions of K4, K6, K8 and K10 at width 8 in fp32, reduced
  by camera or point as the route reduces them, against sfm_tpu's
  build_normal_equations (Hcc, Hpp^-1, W, bc, bp; the Schur-Jacobi
  preconditioner's equilibration), compute_cost and Schur matvec on the
  same 8-wide problem (tests/unit/test_ba_bigc.py's fixture with two
  intrinsic columns added) in float64: 3e-5 of each array's max, rtol
  2e-5 on the cost (tests/test_torch_ba_bigc.py's bars at width 6), except
  Hpp^-1 and S v (which goes through it) at 1e-4 (tests/test_torch_ba.py's
  bar): the fp32 inversion of the point blocks sits 3e-5 from float64 in
  either package. sfm_tpu runs in float64 (jax.enable_x64) because its
  fp32 large-C XLA path sums each camera's rows as differences of one
  prefix sum over all observations (_cam_reduce_sorted): here that puts
  its fp32 Hcc 3.5e-5 of max from float64 and its preconditioner scale
  5e-3, where the port's fp32 sorted segment sums sit at 1.1e-6 and
  1.7e-5;
- (ii) the large-C route against the small-C route (K3, K5, K7, K11) at
  width 8 on one problem, MAX_CAMS raised for the second: normal equations,
  preconditioner, S v, cost and the LM candidate with the focal column
  frozen, 1e-5 of max (the same arithmetic, rows gathered elsewhere);
- (iii) bundle_adjust on the 4,352-camera orbit of tests/test_torch_ba_bigc.py
  built with refine_intrinsics=True, every focal at 0.96 x the rendered
  one, once with focal and k1 refined and once with focal only, 4 LM
  iterations of 16 CG steps, against sfm_tpu's bundle_adjust in float64:
  initial cost rel 1e-5, final cost rel 1e-3, refined focals rtol 1e-3, k1
  unmoved bit-for-bit when not refined; its route: the `_big` set for the
  normal equations, the candidate and the preconditioner, one pcg_solve
  per LM iteration, no small-C kernel. Through the prefix-sum camera
  reduction above, sfm_tpu's fp32 run puts the focals of weakly observed
  cameras up to 18% from its own float64 solve (final cost 1.3e-3 above
  it), where the port's fp32 focals sit within 2.5e-5 of it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import schur_matvec_step
import jax

from sfm_tpu.ba import core as jcore
from sfm_tpu.ba.problem import build_problem as jbuild_problem
from sfm_tpu.config import BAConfig as JBAConfig
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.kernels import ba_kernels
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.interop import from_numpy_problem
from tests.test_torch_ba import close
from tests.test_torch_ba_bigc import _orbit_model
from tests.unit.test_ba_bigc import make_big_problem

torch.set_num_threads(2)


def _float64(jprob):
    """A JAX problem with float64 parameters and observations (under
    jax.enable_x64)."""
    floats = ("cam_params", "intrinsics", "points", "obs_uv", "obs_w")
    return jprob._replace(**{f: jnp.asarray(np.asarray(getattr(jprob, f)), jnp.float64) for f in floats})


def _wide_big(seed, **kw):
    """make_big_problem's problem with 8-wide cameras: a log focal scale and
    a dk1 of a few percent on each camera."""
    jprob = make_big_problem(seed=seed, **kw)
    rng = np.random.default_rng(seed + 100)
    extra = rng.normal(0, 0.02, (jprob.num_cameras, 2)).astype(np.float32)
    jprob = jprob._replace(cam_params=jnp.concatenate([jprob.cam_params, jnp.asarray(extra)], 1))
    return jprob, from_numpy_problem(jprob)


@pytest.fixture(scope="module")
def wide_problem():
    jprob, prob = _wide_big(4)
    assert prob.cam_params.shape[-1] == 8 and core.uses_big_kernels(prob)
    return jprob, prob


def test_wide_big_kernels_reduced_match_jax(wide_problem):
    """(i) K4 (+ K9, the damping and inversion), K8 (+ K9, the
    preconditioner), K6 and K10 (+ K9) at width 8 against sfm_tpu's XLA in
    float64."""
    jprob, prob = wide_problem
    cfg = BAConfig(robust_loss="huber", robust_scale_px=4.0)
    jcfg = JBAConfig(robust_loss="huber", robust_scale_px=4.0)
    lam = 1e-3
    v = np.random.default_rng(6).normal(size=(prob.num_cameras, 8))
    with jax.enable_x64(True):
        j64 = _float64(jprob)
        # sfm_tpu's near-plane floor (bundle_adjust_impl's).
        z0 = jcore._obs_depths(j64, j64.cam_params, j64.points)
        z_floor = 1e-3 * jnp.sqrt(jnp.sum(j64.obs_w * z0 * z0) / jnp.maximum(jnp.sum(j64.obs_w), 1.0))
        jinv = jcore._solve_invariants(j64, j64.cam_params, jcfg, None)._replace(z_floor=z_floor)
        ne_j = jcore.build_normal_equations(j64, j64.cam_params, j64.points, lam, jcfg, inv=jinv)
        ref = {k: np.asarray(getattr(ne_j, k)) for k in ("Hcc", "Hpp_inv", "W", "bc", "bp", "sdiag")}
        ref["cost"] = float(jcore.compute_cost(j64, j64.cam_params, j64.points, jcfg, z_floor=z_floor))
        ref["sv"] = np.asarray(jcore._schur_matvec(ne_j, j64, jnp.asarray(v)))
        ref["z_floor"] = float(z_floor)
    assert ref["Hcc"].dtype == np.float64
    inv = core.solve_invariants(prob, core.near_plane_floor(prob))
    assert float(inv.z_floor) == pytest.approx(ref["z_floor"], rel=1e-6)
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(lam), cfg, inv)
    O = prob.obs_w.shape[0]
    assert ne.W_t.shape == (24, O) and ne.Hcc.shape == (prob.num_cameras, 8, 8)
    close(ne.Hcc, ref["Hcc"], "Hcc", tol=3e-5)
    close(ne.Hpp_inv, ref["Hpp_inv"], "Hpp_inv", tol=1e-4)
    close(ne.W_t, ref["W"].reshape(O, 24).T, "W", tol=3e-5)
    close(ne.bc, ref["bc"], "bc", tol=3e-5)
    close(ne.bp, ref["bp"], "bp", tol=3e-5)
    # K8 + K9: the preconditioner's blocks, through its equilibration.
    _, d = core.pcg_preconditioner(ne, prob, inv)
    close(d, ref["sdiag"], "preconditioner scale", tol=3e-5)
    # K6: the cost at the problem's parameters with the near-plane gate.
    got = float(core.compute_cost(prob, prob.cam_params, prob.points, cfg, inv))
    assert got == pytest.approx(ref["cost"], rel=2e-5)
    # K10 + K9: S v.
    close(schur_matvec_step(ne, prob, torch.from_numpy(v.astype(np.float32)), inv), ref["sv"], "S v",
          tol=1e-4)


def test_wide_large_c_route_matches_small_c_route(monkeypatch):
    """(ii) One 8-wide problem through both kernel sets: normal equations,
    preconditioner, S v, cost and the LM candidate (focal frozen)."""
    _, prob = _wide_big(3, C=4352, O=8192, P=512)
    cfg = BAConfig(robust_loss="huber", refine_focal=False, refine_distortion=True)
    lam = torch.tensor(1e-3)
    rng = np.random.default_rng(9)
    v = torch.from_numpy(rng.normal(size=(prob.num_cameras, 8)).astype(np.float32))
    dc = torch.from_numpy(1e-3 * rng.normal(size=(prob.num_cameras, 8)).astype(np.float32))

    def run():
        inv = core.solve_invariants(prob, core.near_plane_floor(prob))
        ne = core.build_normal_equations(prob, prob.cam_params, prob.points, lam, cfg, inv, schur_jacobi=True)
        cand = core.lm_candidate(ne, prob, dc, prob.cam_params, prob.points, cfg, inv)
        return (*ne[:5], *core.pcg_preconditioner(ne, prob, inv), schur_matvec_step(ne, prob, v, inv),
                core.compute_cost(prob, prob.cam_params, prob.points, cfg, inv), *cand)

    big = run()
    # The frozen focal column: the candidate's column 6 is the problem's.
    assert torch.equal(big[-3][:, 6], prob.cam_params[:, 6])
    assert not torch.equal(big[-3][:, 7], prob.cam_params[:, 7])
    monkeypatch.setattr(core, "MAX_CAMS", 1 << 30)
    assert not core.uses_big_kernels(prob)
    small = run()
    for i, (a, b) in enumerate(zip(big, small)):
        close(a, b, f"output {i}", tol=1e-5)


@pytest.fixture(scope="module")
def orbit_arrays():
    """_orbit_model() with every focal at 0.96 x the rendered 400."""
    arrays = _orbit_model()
    arrays["intrinsics"] = arrays["intrinsics"].copy()
    arrays["intrinsics"][:, :2] *= 0.96
    return arrays


@pytest.mark.parametrize("distortion", [True, False], ids=["focal-k1", "focal-only"])
def test_wide_bundle_adjust_past_max_cams_matches_jax(orbit_arrays, monkeypatch, distortion):
    """(iii) bundle_adjust past 4096 cameras at width 8 against sfm_tpu's
    (in float64)."""
    jprob, _, _ = jbuild_problem(JReconstruction(**orbit_arrays), tight=True, refine_intrinsics=True)
    prob, _, _ = build_problem(Reconstruction(**orbit_arrays), tight=True, refine_intrinsics=True,
                               device="cpu")
    assert prob.num_cameras == 4352 and prob.cam_params.shape[-1] == 8
    kw = dict(max_iterations=4, cg_iterations=16, refine_focal=True, refine_distortion=distortion)
    assert not core.uses_dense_solver(prob, BAConfig(**kw))
    route = ("fused_ne_payloads_big", "fused_cost_sums_big", "whw_payloads_big", "pcg_solve")
    # The small-C set, and the entries a CG loop over the coupling would call.
    never = {core: ("fused_ne_payloads", "fused_cost_sums"),
             ba_kernels: ("schur_coupling_payloads_big", "whw_cam_reduce", "schur_coupling_matvec")}
    calls = {name: 0 for name in route + sum(never.values(), ())}

    def counted(module, name):
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for module, names in ((core, route), *never.items()):
        for name in names:
            monkeypatch.setattr(module, name, counted(module, name))
    out_t, st_t = core.bundle_adjust(prob, BAConfig(**kw))
    assert all(calls[n] > 0 for n in route), calls
    assert not any(calls[n] for n in calls if n not in route), calls
    assert calls["pcg_solve"] == st_t.iterations

    with jax.enable_x64(True):
        out_j, st_j = jcore.bundle_adjust(_float64(jprob), JBAConfig(**kw))
        cams_j = np.asarray(out_j.cam_params)
        costs_j = float(st_j.initial_cost), float(st_j.final_cost)
    assert cams_j.dtype == np.float64
    assert float(st_t.initial_cost) == pytest.approx(costs_j[0], rel=1e-5)
    assert float(st_t.final_cost) == pytest.approx(costs_j[1], rel=1e-3)
    assert float(st_t.final_cost) < 0.5 * float(st_t.initial_cost)
    assert torch.isfinite(out_t.cam_params).all()
    focal_t = prob.intrinsics[:, 0].numpy() * np.exp(out_t.cam_params[:, 6].numpy())
    focal_j = prob.intrinsics[:, 0].numpy() * np.exp(cams_j[:, 6])
    np.testing.assert_allclose(focal_t, focal_j, rtol=1e-3)
    assert not np.array_equal(out_t.cam_params[:, 6].numpy(), prob.cam_params[:, 6].numpy())
    if not distortion:
        assert torch.equal(out_t.cam_params[:, 7], prob.cam_params[:, 7])
