"""K3 (the damped normal equations over point segments) and K5 (the LM
candidate and its cost) as their plain versions run them on the CPU,
against sfm_tpu.ba.core.

Tolerances:
- K3's outputs vs sfm_tpu build_normal_equations (its plain path), with and
  without the near-plane gate, at lam 1e-3 and 1e2, with frozen cameras and
  points (closed-form vs jacfwd Jacobians and another summation order,
  fp32): Hcc and Hpp_inv within 1e-4 of each camera's and each point's
  block max |value| (an array-wide scale would be the frozen points' 1e6 I
  blocks); bc, bp and W within 1e-4 of the array's max |value| (near
  convergence bc and bp are sums that cancel, so a block's own max is no
  scale for fp32 rounding);
- the packed camera rows: exactly each weighted observation's camera row at
  its camera-sorted place, and summed per camera (K9's sorted pass) exactly
  what K9 gives on the per-observation rows through the permutation (both
  add in camera-sorted order on the CPU);
- K3 with the Schur-Jacobi blocks (a PCG solve's build): the normal
  equations bit-identical to K3 without them, the blocks exactly
  whw_cam_reduce_plain's, their packed entries summed per camera the
  blocks' upper triangle to 1e-6 of max (the same values in the same
  order), and the blocks against sfm_tpu's whw_cam_reduce (Pallas,
  interpret mode) on the same W and Hpp^-1 to 2e-5 of max (K7's bar in
  tests/test_torch_ba.py); the dense solves' builds leave the blocks out,
  the PCG solves' take them from K3 and never call K7 alone;
- K5's candidate vs sfm_tpu's _back_substitute, freeze masks and
  compute_cost on the same normal equations and step: dp within 1e-4 of
  max |dp| (summation order of the point sums), the cost rel 1e-5, for each
  robust loss, with and without the gate; without a step, K5 is the cost at
  the given parameters and hands them back unchanged.
"""

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
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import ba_kernels as kb
from sfm_tpu_torch.utils.interop import from_numpy_problem

torch.set_num_threads(2)

Z_FLOOR = 4.0   # gates the nearest observations of the fixture (depths ~3-5)


@pytest.fixture(scope="module")
def problem():
    """An orbit of 8 cameras around 300 points, perturbed, 5% outliers;
    cameras 0-2 and every seventh point frozen, every eleventh observation
    given zero weight (rows of no camera segment inside [0, N))."""
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
    jprob, _, _ = jbuild_problem(rec, free_cams=np.arange(3, K))
    point_fixed = np.array(jprob.point_fixed)
    point_fixed[::7] = True
    obs_w = np.array(jprob.obs_w)
    obs_w[5::11] = 0.0
    jprob = jprob._replace(point_fixed=jnp.asarray(point_fixed), obs_w=jnp.asarray(obs_w))
    return jprob, from_numpy_problem(jprob)


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


def _jax_ne(jprob, lam, zf, loss="huber"):
    jcfg = JBAConfig(robust_loss=loss, robust_scale_px=4.0)
    jinv = jcore._solve_invariants(jprob, jprob.cam_params, jcfg, None)
    if zf is not None:
        jinv = jinv._replace(z_floor=jnp.asarray(zf, jnp.float32))
    return jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, jnp.asarray(lam, jnp.float32),
                                        jcfg, inv=jinv)


def _k3(prob, inv, lam, loss="huber", **kw):
    return kb.fused_ne_payloads(prob.obs_cam, prob.obs_point, prob.points, inv.static_t,
                                prob.cam_params, prob.intrinsics, inv.point_bounds, inv.cam_perm,
                                inv.cam_bounds, inv.cam_inv_perm, torch.tensor(lam), inv.z_floor,
                                loss, 4.0, **kw)


@pytest.mark.parametrize("lam", [1e-3, 1e2])
@pytest.mark.parametrize("zf", [None, Z_FLOOR])
def test_k3_plain_matches_jax_normal_equations(problem, zf, lam):
    jprob, prob = problem
    ne_j = _jax_ne(jprob, lam, zf)
    inv = core.solve_invariants(prob, None if zf is None else torch.tensor(zf))
    if zf is not None:   # the gate removes observations at these parameters
        z = kb.projection(prob.cam_params[prob.obs_cam.long()], prob.intrinsics[prob.obs_cam.long()],
                          prob.points[prob.obs_point.long()], prob.obs_uv)["xc2"]
        assert int(((z <= zf) & (prob.obs_w > 0)).sum()) > 0
    Hcc, Hpp_inv, W_t, bc, bp, _ = _k3(prob, inv, lam)
    O = prob.obs_w.shape[0]
    close(W_t.T.reshape(O, 6, 3), ne_j.W, "W")
    close_blocks(Hcc, ne_j.Hcc, "Hcc")
    close(bc, ne_j.bc, "bc")
    close_blocks(Hpp_inv, ne_j.Hpp_inv, "Hpp_inv")
    close(bp, ne_j.bp, "bp")
    # Frozen cameras and points: zero rows and steps-free blocks.
    assert not Hcc[:3].sub(torch.eye(6) * 1e-6).any() and not bc[:3].any()
    pf = prob.point_fixed
    assert not bp[pf].any() and torch.allclose(Hpp_inv[pf], torch.eye(3).expand(int(pf.sum()), 3, 3) * 1e6)


def test_k3_packed_camera_rows(problem):
    jprob, prob = problem
    inv = core.solve_invariants(prob, torch.tensor(Z_FLOOR))
    Hcc, _, W_t, bc, _, packed = _k3(prob, inv, 1e-3)
    N, M = inv.cam_inv_perm.numel(), inv.cam_perm.numel()
    assert packed.shape == (M, kb.NE_CAM_ROWS) and M < N < prob.obs_w.shape[0]
    assert not W_t[:, N:].any()
    # Every weighted observation's row at its camera-sorted place, and no other.
    w_t, _, cam_t = kb._ne_payloads_obs_plain(
        prob.obs_cam, prob.points[prob.obs_point.long()].T, inv.static_t, prob.cam_params,
        prob.intrinsics, inv.z_floor, "huber", 4.0)
    place = inv.cam_inv_perm.long()
    rows = torch.nonzero(place >= 0).flatten()
    assert rows.numel() == M and torch.equal(place[rows].sort().values, torch.arange(M))
    assert torch.equal(packed[place[rows]], cam_t[:, rows].T)
    assert torch.equal(W_t[:, :N], w_t[:, :N])
    # Summed per camera: today's layout through K9's permuted side.
    by_cam = kb.cam_segment_sum(packed.T.contiguous(), None, inv.cam_bounds)
    torch.testing.assert_close(by_cam, kb.cam_segment_sum(cam_t, inv.cam_perm, inv.cam_bounds),
                               rtol=0, atol=0)
    torch.testing.assert_close(Hcc, kb.damp(by_cam[:, :36].reshape(-1, 6, 6), torch.tensor(1e-3)),
                               rtol=0, atol=0)
    torch.testing.assert_close(bc, by_cam[:, 36:], rtol=0, atol=0)


@pytest.mark.parametrize("zf", [None, Z_FLOOR])
@pytest.mark.parametrize("loss", ["none", "huber", "cauchy"])
def test_k5_candidate_matches_jax(problem, loss, zf):
    jprob, prob = problem
    ne_j = _jax_ne(jprob, 1e-3, zf, loss)
    C, O = prob.num_cameras, prob.obs_w.shape[0]
    dc = (1e-3 * np.random.default_rng(6).normal(size=(C, 6))).astype(np.float32)
    dp_j = jcore._back_substitute(ne_j, jprob, jnp.asarray(dc))
    dc_j = jnp.where(jprob.cam_fixed[:, None], 0.0, dc)
    dp_j = np.asarray(jnp.where(jprob.point_fixed[:, None], 0.0, dp_j))
    cost_j = float(jcore.compute_cost(jprob, jprob.cam_params + dc_j, jprob.points + dp_j,
                                      JBAConfig(robust_loss=loss, robust_scale_px=4.0),
                                      z_floor=None if zf is None else jnp.asarray(zf, jnp.float32)))
    inv = core.solve_invariants(prob, None if zf is None else torch.tensor(zf))
    t = lambda a: torch.from_numpy(np.array(a))
    step = kb.LMStep(torch.from_numpy(dc), t(ne_j.W.reshape(O, 18).T), t(ne_j.Hpp_inv), t(ne_j.bp),
                     prob.cam_fixed, prob.point_fixed)
    new_cams, new_points, sums = kb.fused_cost_sums(
        prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params, prob.intrinsics, inv.point_bounds,
        inv.z_floor, loss, 4.0, step=step)
    close(new_points - prob.points, dp_j, "dp")
    assert not (new_points - prob.points)[prob.point_fixed].any()
    assert torch.equal(new_cams, prob.cam_params + torch.where(prob.cam_fixed[:, None], 0.0, step.dc))
    assert float(sums[2]) == pytest.approx(cost_j, rel=1e-5)
    assert float(sums[2]) == pytest.approx(float(sums[0] / sums[1]), rel=1e-6)
    # Without a step: the cost at the given parameters, which come back as they were.
    cams0, points0, sums0 = kb.fused_cost_sums(
        prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params, prob.intrinsics, inv.point_bounds,
        inv.z_floor, loss, 4.0)
    assert cams0 is prob.cam_params and points0 is prob.points
    cost0_j = float(jcore.compute_cost(jprob, jprob.cam_params, jprob.points,
                                       JBAConfig(robust_loss=loss, robust_scale_px=4.0),
                                       z_floor=None if zf is None else jnp.asarray(zf, jnp.float32)))
    assert float(sums0[2]) == pytest.approx(cost0_j, rel=1e-5)


# ---- K3 with the Schur-Jacobi blocks (K7's device code) -----------------------


@pytest.mark.parametrize("zf", [None, Z_FLOOR])
def test_k3_schur_jacobi_blocks_match_k7_and_jax(problem, zf):
    jprob, prob = problem
    inv = core.solve_invariants(prob, None if zf is None else torch.tensor(zf))
    plain = _k3(prob, inv, 1e-3)
    out = _k3(prob, inv, 1e-3, schur_jacobi=True)
    assert len(plain) == 6 and len(out) == 7
    for name, a, b in zip(("Hcc", "Hpp_inv", "W_t", "bc", "bp"), out[:5], plain[:5]):
        assert torch.equal(a, b), name
    M, C, P = inv.cam_perm.numel(), prob.num_cameras, prob.num_points
    packed, blocks = out[5], out[6]
    assert packed.shape == (M, kb.NE_PCG_ROWS) and torch.equal(packed[:, :kb.NE_CAM_ROWS], plain[5])
    assert not packed[:, -1].any()
    _, Hpp_inv, W_t = out[:3]
    k7 = (W_t, Hpp_inv, prob.obs_point, inv.cam_perm, inv.cam_bounds)
    assert blocks.shape == (C, 36)
    assert torch.equal(blocks, kb.whw_cam_reduce_plain(*k7))
    assert torch.equal(blocks, kb.whw_cam_reduce(*k7, inv.cam_inv_perm))
    upper = kb.cam_segment_sum_plain(packed[:, kb.NE_CAM_ROWS:kb.NE_CAM_ROWS + 21].T.contiguous(), None,
                                     inv.cam_bounds)
    close(upper, blocks[:, kb._UPPER6], "packed entries by camera", tol=1e-6)
    assert float(blocks[3:].abs().max()) > 0 and not blocks[:3].any()   # cameras 0-2 frozen
    hinv_t = Hpp_inv.reshape(P, 9)[prob.obs_point.long()].T
    ref = schur_spmv.whw_cam_reduce(jnp.asarray(W_t.numpy()), jnp.asarray(hinv_t.numpy()),
                                    jnp.asarray(prob.obs_cam.numpy()), C, interpret=True)
    close(blocks, np.asarray(ref), "blocks vs sfm_tpu whw_cam_reduce", tol=2e-5)


def test_dense_solves_build_no_schur_jacobi_blocks(problem, monkeypatch):
    """bundle_adjust asks K3 for the blocks on its PCG branch only, and that
    branch's preconditioner takes them from K3 (K7 alone never runs)."""
    _, prob = problem
    flags = []
    inner = core.fused_ne_payloads

    def spy(*a, schur_jacobi=False, **k):
        flags.append(schur_jacobi)
        out = inner(*a, schur_jacobi=schur_jacobi, **k)
        assert len(out) == 6 + schur_jacobi
        return out

    def refused(*a, **k):
        raise AssertionError("K7 launched on its own")

    monkeypatch.setattr(core, "fused_ne_payloads", spy)
    monkeypatch.setattr(kb, "whw_cam_reduce", refused)
    dense = BAConfig(max_iterations=2)
    assert core.uses_dense_solver(prob, dense)
    core.bundle_adjust(prob, dense)
    assert flags and not any(flags)
    flags.clear()
    pcg = BAConfig(dense_schur_max_cameras=0, max_iterations=2)
    assert not core.uses_dense_solver(prob, pcg)
    _, stats = core.bundle_adjust(prob, pcg)
    assert len(flags) == stats.iterations and all(flags)


@pytest.mark.parametrize("schur_jacobi", [False, True])
def test_k3_signature_takes_what_the_wrapper_passes(problem, monkeypatch, schur_jacobi):
    """The C entry's argument count is what fused_ne_payloads passes plus
    the stream (a mismatch would be silent memory corruption): 12 pointers
    in, O, P, C, loss, scale, grid, camera warps, 7 pointers out (the blocks
    last, null without them), stream."""
    _, prob = problem
    inv = core.solve_invariants(prob)
    passed = []
    monkeypatch.setattr(kb, "on_cuda", lambda t: True)
    monkeypatch.setattr(kb, "check", lambda *a: None)
    monkeypatch.setattr(kb, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    out = _k3(prob, inv, 1e-3, plan=kb.pcg_plan(inv.point_bounds, 4), schur_jacobi=schur_jacobi)
    (entry, name, a), = passed
    assert entry == "sfm_fused_ne_payloads" and name == "fused_ne_payloads"
    assert len(_SIGNATURES[entry]) == len(a) + 1 == 27
    assert (a[-1] is None) == (not schur_jacobi)
    assert len(out) == 6 + schur_jacobi
    assert out[5].shape[1] == (kb.NE_PCG_ROWS if schur_jacobi else kb.NE_CAM_ROWS)
