"""The large-camera-count BA kernel set (K4, K6, K8, K10) and the route that
takes it past 4096 cameras, against sfm_tpu.

The JAX kernels run in interpret mode on tests/unit/test_ba_bigc.py's
fixture (make_big_problem, C=4224, O=8192, P=512). Tolerances:
- K4 plain vs fused_ne_payloads_big: 3e-5 of each block's max |value| (the
  JAX test's own bar against its XLA path: another order of fp32 operations);
- K6 plain vs fused_cost_sums_big: rtol 2e-5 on the mean cost, with and
  without the near-plane gate (summation order);
- K8 plain vs whw_payloads_big: 3e-5 of the payload's max;
- K10 plain vs schur_coupling_payloads_big on the point-aligned orbit
  problem the JAX test uses: 3e-5 of max (the TPU kernel sums the point
  segments through a bf16-split indicator matmul);
- the large-C normal equations, preconditioner and S v against the same
  functions with the threshold raised (the K3/K5/K7/K11 route): 1e-5 of max
  (same arithmetic, the rows gathered elsewhere);
- build_problem (tight capacities, reused capacities, a camera window with
  anchored cameras) vs sfm_tpu's: every array equal;
- bundle_adjust past 4096 cameras (4224 cameras around 4096 points, 16
  views each) vs sfm_tpu's XLA path: same initial cost to 1e-5,
  same final cost to 1e-3 relative (same LM schedule); its route: K4, K6
  and K8 for the normal equations, the candidate and the preconditioner,
  one pcg_solve per CG solve (no Python CG loop over K10 and K9).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import arc_ring_reconstruction, schur_matvec_step
from sfm_tpu.ba import core as jcore
from sfm_tpu.ba.problem import build_problem as jbuild_problem
from sfm_tpu.config import BAConfig as JBAConfig
from sfm_tpu.kernels import schur_spmv
from sfm_tpu.scene.state import Reconstruction as JReconstruction
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.geometry.projection import project
from sfm_tpu_torch.geometry.rotations import matrix_to_aa
from sfm_tpu_torch.kernels import ba_kernels
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.interop import from_numpy_problem
from sfm_tpu_torch.utils.synthetic import look_at
from tests.test_torch_ba import close, scene_problem
from tests.unit.test_ba_bigc import make_big_problem

torch.set_num_threads(2)


def _big(seed, **kw):
    jprob = make_big_problem(seed=seed, **kw)
    return jprob, from_numpy_problem(jprob)


def _jax_rows(jprob):
    O = jprob.obs_w.shape[0]
    pad = jnp.zeros((jprob.num_cameras, 2), jnp.float32)
    pts_t = jnp.concatenate([jnp.take(jprob.points.T, jprob.obs_point, axis=1),
                             jnp.zeros((1, O), jnp.float32)], 0)
    cams_t = jnp.concatenate([jprob.cam_params, pad], 1).T[:, jprob.obs_cam]
    intr_t = jnp.concatenate([jprob.intrinsics, pad], 1).T[:, jprob.obs_cam]
    return pts_t, jcore._ne_static_misc(jprob), cams_t, intr_t


@pytest.mark.parametrize("z_floor", [None, 5.0])
def test_fused_ne_payloads_big_plain_matches_pallas_kernel(z_floor):
    jprob, prob = _big(0)
    assert core.uses_big_kernels(prob)
    zf = None if z_floor is None else jnp.asarray(z_floor, jnp.float32)
    W_j, Yp_j, cam_j = schur_spmv.fused_ne_payloads_big(
        *_jax_rows(jprob), "huber", 4.0, z_floor=zf, interpret=True)
    inv = core.solve_invariants(prob, None if z_floor is None else torch.tensor(z_floor))
    assert inv.intr_t is not None
    w_t, yp_t, cam_t = ba_kernels.fused_ne_payloads_big(
        core._pts_t(prob, prob.points), inv.static_t, core._rows_t(prob.cam_params, prob.obs_cam),
        inv.intr_t, inv.z_floor, "huber", 4.0)
    close(w_t, np.asarray(W_j)[:18], "W_t", tol=3e-5)
    close(yp_t, np.asarray(Yp_j)[:9], "Yp_t", tol=3e-5)
    close(cam_t, np.asarray(cam_j)[:42], "cam_t", tol=3e-5)


@pytest.mark.parametrize("z_floor", [None, 5.0])
def test_fused_cost_sums_big_plain_matches_pallas_kernel(z_floor):
    jprob, prob = _big(21)
    zf = None if z_floor is None else jnp.asarray(z_floor, jnp.float32)
    num, den = schur_spmv.fused_cost_sums_big(*_jax_rows(jprob), "huber", 4.0, z_floor=zf,
                                              interpret=True)
    inv = core.solve_invariants(prob, None if z_floor is None else torch.tensor(z_floor))
    sums = ba_kernels.fused_cost_sums_big(
        core._pts_t(prob, prob.points), inv.static_t, core._rows_t(prob.cam_params, prob.obs_cam),
        inv.intr_t, inv.z_floor, "huber", 4.0)
    assert float(sums[1]) == float(den)
    assert float(sums[0]) == pytest.approx(float(num), rel=2e-5)
    got = float(core.compute_cost(prob, prob.cam_params, prob.points,
                                  BAConfig(robust_loss="huber", robust_scale_px=4.0), inv))
    assert got == pytest.approx(float(num) / max(float(den), 1.0), rel=2e-5)


def test_whw_payloads_big_plain_matches_pallas_kernel():
    jprob, prob = _big(2)
    rng = np.random.default_rng(2)
    O, P = prob.obs_w.shape[0], prob.num_points
    W_t = rng.normal(size=(18, O)).astype(np.float32)
    A = rng.normal(size=(P, 3, 3)).astype(np.float32)
    hinv = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    hinv_t = hinv.reshape(P, 9)[np.asarray(jprob.obs_point)].T
    ref = np.asarray(schur_spmv.whw_payloads_big(jnp.asarray(W_t), jnp.asarray(hinv_t), interpret=True))
    got = ba_kernels.whw_payloads_big(torch.from_numpy(W_t), torch.from_numpy(hinv), prob.obs_point)
    close(got, ref, "whw payload", tol=3e-5)


def test_schur_coupling_payloads_big_plain_matches_pallas_kernel():
    jprob, prob = scene_problem(12, 300, 0.02, 0.05, seed=30)
    assert prob.point_align > 0
    ne = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, jnp.asarray(1e-3),
                                      JBAConfig(robust_loss="huber"))
    C, O, P = prob.num_cameras, prob.obs_w.shape[0], prob.num_points
    tile = schur_spmv.matvec_tile_big(prob.point_align)
    assert tile > 0 and O % tile == 0
    w_t = ne.W.reshape(O, 18).T
    hinv_t = ne.Hpp_inv.reshape(P, 9)[jprob.obs_point].T
    op = jprob.obs_point.reshape(O // tile, tile)
    lids = (op - op[:, :1]).reshape(O)
    v = np.random.default_rng(5).normal(size=(C, 6)).astype(np.float32)
    v8 = jnp.zeros((8, C), jnp.float32).at[:6].set(jnp.asarray(v).T)
    ref = np.asarray(schur_spmv.schur_coupling_payloads_big(
        lids, w_t, hinv_t, v8[:, jprob.obs_cam], tile=tile, interpret=True))[:6]
    inv = core.solve_invariants(prob)
    n = inv.cam_inv_perm.shape[0]
    got = ba_kernels.schur_coupling_payloads_big(
        torch.from_numpy(np.array(w_t)), torch.from_numpy(np.array(ne.Hpp_inv)), prob.obs_point,
        inv.point_bounds, n, core._rows_t(torch.from_numpy(v), prob.obs_cam)).numpy()
    assert not got[:, n:].any()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got[:, :n] / scale, ref[:, :n] / scale, atol=3e-5)
    # Reduced by camera it is K11's coupling term.
    k11 = ba_kernels.schur_coupling_matvec(
        torch.from_numpy(np.array(w_t)), torch.from_numpy(np.array(ne.Hpp_inv)), prob.obs_cam,
        prob.obs_point, inv.point_bounds, inv.cam_perm, inv.cam_bounds, torch.from_numpy(v))
    close(ba_kernels.cam_segment_sum(torch.from_numpy(got), inv.cam_perm, inv.cam_bounds), k11,
          "coupling by camera", tol=1e-5)


def test_large_c_route_matches_small_c_route(monkeypatch):
    """Normal equations, preconditioner and S v of one problem through both
    kernel sets."""
    _, prob = _big(3, C=4352, O=8192, P=512)
    cfg = BAConfig(robust_loss="huber")
    lam = torch.tensor(1e-3)
    v = torch.from_numpy(np.random.default_rng(9).normal(size=(prob.num_cameras, 6)).astype(np.float32))

    def run():
        inv = core.solve_invariants(prob, core.near_plane_floor(prob))
        ne = core.build_normal_equations(prob, prob.cam_params, prob.points, lam, cfg, inv, schur_jacobi=True)
        return (*ne[:5], *core.pcg_preconditioner(ne, prob, inv), schur_matvec_step(ne, prob, v, inv),
                core.compute_cost(prob, prob.cam_params, prob.points, cfg, inv))

    assert core.uses_big_kernels(prob)
    big = run()
    monkeypatch.setattr(core, "MAX_CAMS", 1 << 30)
    assert not core.uses_big_kernels(prob)
    small = run()
    for i, (a, b) in enumerate(zip(big, small)):
        close(a, b, f"output {i}", tol=1e-5)


@pytest.mark.parametrize("lam", [1e-3, 1e2])
def test_large_c_block_forms_match_the_reference_helpers(lam):
    """The large-C route's damping and inversion (core._sym3_big, _damp_big,
    _sym_solve3_big) against kernels.ba_kernels' sym3, damp and sym_solve3,
    which K3's plain version uses: on point blocks spanning 18 decades of
    scale, with all-zero (padding) blocks, and on camera blocks. The same
    roundings in the same order: every output bit-identical."""
    rng = np.random.default_rng(11)
    J = rng.normal(size=(512, 4, 3))
    red = np.einsum("bki,bkj->bij", J, J) * 10.0 ** rng.uniform(-9, 9, (512, 1, 1))
    red6 = torch.from_numpy(red[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32))
    red6[::17] = 0.0
    lam_t = torch.tensor(lam)
    assert torch.equal(core._sym3_big(red6), ba_kernels.sym3(red6))
    H = ba_kernels.sym3(red6)
    assert torch.equal(core._damp_big(H, lam_t), ba_kernels.damp(H, lam_t))
    Jc = torch.from_numpy(rng.normal(size=(64, 8, 6)).astype(np.float32))
    Hc = Jc.transpose(1, 2) @ Jc
    assert torch.equal(core._damp_big(Hc, lam_t), ba_kernels.damp(Hc, lam_t))
    A = ba_kernels.damp(H, lam_t)
    assert torch.equal(core._sym_solve3_big(A), ba_kernels.sym_solve3(A))


_REC_FIELDS = ("intrinsics", "rvecs", "tvecs", "registered", "points", "point_errors", "point_valid",
               "obs_point", "obs_image", "obs_kp", "obs_uv")


@pytest.fixture(scope="module")
def arc_model():
    """A merged model of 4224 cameras (chip_smoke's full-width polish scene,
    small): each of 1024 points in a contiguous arc of 12-20 cameras."""
    rec, _ = arc_ring_reconstruction(4224, 1024, (12, 20), seed=7)
    return rec, JReconstruction(**{f: np.copy(getattr(rec, f)) for f in _REC_FIELDS})


def _orbit_model(C=4224, P=4096, V=16, seed=7):
    """4224 cameras on a ring of radius 6 looking at 4096 points in the unit
    ball, each point seen by 16 cameras drawn at random (16 observations per
    camera on average), 0.5 px noise, perturbed poses and points: a problem
    both packages solve in fp32 without trouble, with the world origin inside
    the scene."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, C, endpoint=False)
    centres = np.stack([6 * np.cos(ang), 0.3 * np.sin(3 * ang), 6 * np.sin(ang)], 1)
    poses = [look_at(c, np.zeros(3)) for c in centres]
    rv = matrix_to_aa(torch.from_numpy(np.stack([p[0] for p in poses]).astype(np.float32))).numpy()
    tv = np.stack([p[1] for p in poses]).astype(np.float32)
    pts = rng.uniform(-1, 1, (P, 3)).astype(np.float32)
    intr = np.tile(np.asarray([400, 400, 256, 256, 0, 0], np.float32), (C, 1))
    obs_point = np.repeat(np.arange(P, dtype=np.int32), V)
    obs_image = rng.integers(0, C, P * V).astype(np.int32)
    uv = project(*(torch.from_numpy(a) for a in (pts[obs_point], rv[obs_image], tv[obs_image],
                                                 intr[obs_image]))).numpy()
    uv = uv + rng.normal(0, 0.5, uv.shape).astype(np.float32)
    return dict(
        intrinsics=intr, rvecs=rv + rng.normal(0, 0.005, (C, 3)).astype(np.float32),
        tvecs=tv + rng.normal(0, 0.01, (C, 3)).astype(np.float32), registered=np.ones(C, bool),
        points=pts + rng.normal(0, 0.02, (P, 3)).astype(np.float32),
        point_errors=np.zeros(P, np.float32), point_valid=np.ones(P, bool), obs_point=obs_point,
        obs_image=obs_image, obs_kp=np.arange(P * V, dtype=np.int32), obs_uv=uv.astype(np.float32))


@pytest.mark.parametrize("kw", [
    dict(tight=True),
    dict(tight=True, obs_capacity=20480, point_capacity=1280),
    dict(cam_indices=np.arange(100, 400), free_cams=np.arange(200, 400)),
    dict(tight=True, refine_intrinsics=True),
], ids=["tight", "tight-caps", "window", "tight-refined"])
def test_build_problem_matches_jax(arc_model, kw):
    """The polish's problems (tight one-shot capacities, reused capacities,
    an anchored camera window, 8-wide cameras for intrinsics refinement):
    every array equal."""
    rec, jrec = arc_model
    jprob, jcams, jpids = jbuild_problem(jrec, **kw)
    prob, cams, pids = build_problem(rec, device="cpu", **kw)
    np.testing.assert_array_equal(cams, jcams)
    np.testing.assert_array_equal(pids, jpids)
    assert prob.point_align == jprob.point_align
    for name in ("cam_params", "intrinsics", "points", "obs_cam", "obs_point", "obs_uv", "obs_w",
                 "cam_fixed", "point_fixed"):
        np.testing.assert_array_equal(getattr(prob, name).numpy(), np.asarray(getattr(jprob, name)), name)


def test_bundle_adjust_past_max_cams_matches_jax(monkeypatch):
    arrays = _orbit_model()
    jprob, _, _ = jbuild_problem(JReconstruction(**arrays), tight=True)
    prob, _, _ = build_problem(Reconstruction(**arrays), tight=True, device="cpu")
    assert prob.num_cameras == 4352
    kw = dict(max_iterations=4, cg_iterations=16)
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
    # The route record: the large-C set for the normal equations, the
    # candidate and the preconditioner, one fused solve per LM iteration, and
    # neither the small-C set nor a CG loop over the coupling matvec.
    assert all(calls[n] > 0 for n in route), calls
    assert not any(calls[n] for n in calls if n not in route), calls
    assert calls["pcg_solve"] == st_t.iterations

    out_j, st_j = jcore.bundle_adjust(jprob, JBAConfig(**kw))
    assert float(st_t.initial_cost) == pytest.approx(float(st_j.initial_cost), rel=1e-5)
    assert float(st_t.final_cost) == pytest.approx(float(st_j.final_cost), rel=1e-3)
    assert float(st_t.final_cost) < 0.5 * float(st_t.initial_cost)
    assert torch.isfinite(out_t.cam_params).all()
