"""The camera-sharded BA (dist/sharded_ba.py, ba/core.py's `group`) on gloo
processes on the CPU, against the single-process port and sfm_tpu.

The problem is tests/distributed/test_sharding.py's: an orbit of 8 cameras
and 64 points, 0.3 px of noise, poses moved 0.01 and points 0.03, LM for 10
iterations with no robust loss. Bars (test_sharding.py's): final cost within
rtol 1e-3 and cameras within 5e-3 of the single-process port (whose PCG
branch the sharded route mirrors; the dense branch takes this problem) and
of sfm_tpu's bundle_adjust_sharded at D = 2; two runs bit-identical; every
process returns the same bits. The 8-wide problem (intrinsics refinement)
and the large-camera-count route (MAX_CAMS set to 4 in the processes: K4,
K6, K8 and K9 in place of K3, K5 and K7), at both widths, are held to the
same bars.

The plain versions of K3's sharded mode and of K11's two halves, summed
over the shards of shard_problem_by_camera (each shard's rows sorted by
point, as each process sorts them), are held to sfm_tpu's unsharded normal
equations at 1e-4 of each block's max (tests/test_torch_ba.py's bar), and
the undamped Hpp blocks damped and inverted to its Hpp^-1.

Processes are spawned (torch.multiprocessing's spawn) and never import JAX:
this module imports sfm_tpu only inside the tests, in the parent; each run
has its own time limit, so a deadlock fails instead of hanging.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sfm_tpu_torch.ba import core
from sfm_tpu_torch.config import BAConfig
from sfm_tpu_torch.dist.launch import run_ranks
from sfm_tpu_torch.dist.sharded_ba import bundle_adjust_sharded, local_rows, shard_problem_by_camera
from sfm_tpu_torch.kernels import ba_kernels as kb
from sfm_tpu_torch.utils.interop import from_numpy_problem

TIMEOUT = 120.0
CFG = dict(max_iterations=10, robust_loss="none")


def _solve(mesh, arrays, cfg_kwargs, max_cams):
    """One process of the sharded solve: its result, as numpy."""
    saved = core.MAX_CAMS
    core.MAX_CAMS = saved if max_cams is None else max_cams
    try:
        prob = from_numpy_problem(arrays)
        out, stats = bundle_adjust_sharded(shard_problem_by_camera(prob, mesh.size), BAConfig(**cfg_kwargs), mesh)
    finally:
        core.MAX_CAMS = saved
    return out.cam_params.numpy(), out.points.numpy(), float(stats.final_cost), int(stats.iterations)


def lm_step(C, D, seed=5):
    """A fixed camera step [C, D] for the candidate checks."""
    return torch.from_numpy(1e-3 * np.random.default_rng(seed).normal(size=(C, D)).astype(np.float32))


def pieces(prob, cfg, group=None) -> dict:
    """The LM's pieces at the first iteration of prob (one process's rows
    with a group): the normal equations (with the Schur-Jacobi blocks), the
    rhs, S v and the candidate of lm_step, as numpy."""
    lam = torch.tensor(cfg.initial_lambda)
    inv = core.solve_invariants(prob, core.near_plane_floor(prob, group))
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, lam, cfg, inv, schur_jacobi=True,
                                     group=group)
    if ne.whw is None:     # the single-device large-camera route builds them in the preconditioner
        ne = ne._replace(whw=kb.cam_segment_sum(kb.whw_payloads_big(ne.W_t, ne.Hpp_inv, prob.obs_point),
                                                inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm))
    dc = lm_step(*prob.cam_params.shape)
    sv = (core._sharded_matvec(ne, prob, dc, inv, group) if group is not None
          else core._schur_matvec(ne, prob, dc, inv))
    cams, points, cost = core.lm_candidate(ne, prob, dc, prob.cam_params, prob.points, cfg, inv, group)
    out = {k: getattr(ne, k) for k in ("Hcc", "Hpp_inv", "bc", "bp", "whw")}
    out.update(rhs=core._schur_rhs(ne, prob, inv, group), sv=sv, cams=cams, points=points, cost=cost)
    return {k: v.numpy() for k, v in out.items()}


def _pieces(mesh, arrays, cfg_kwargs, max_cams):
    saved = core.MAX_CAMS
    core.MAX_CAMS = saved if max_cams is None else max_cams
    try:
        prob = shard_problem_by_camera(from_numpy_problem(arrays), mesh.size)
        return pieces(local_rows(prob, mesh.rank, mesh.size), BAConfig(**cfg_kwargs), mesh.group)
    finally:
        core.MAX_CAMS = saved


CFG8 = dict(CFG, refine_focal=True, refine_distortion=True)
CFG8_FROZEN = dict(CFG, refine_focal=False, refine_distortion=True)   # column 6 frozen


def _runs(mesh, arrays, refined):
    """Every case of one group size in one spawn: 6 wide twice (the
    determinism check), 8 wide, the large-camera-count route at both
    widths, and the LM's pieces on each route (8 wide with the focal column
    frozen)."""
    return {"six": _solve(mesh, arrays, CFG, None), "again": _solve(mesh, arrays, CFG, None),
            "eight": _solve(mesh, refined, CFG8, None), "big": _solve(mesh, arrays, CFG, 4),
            "big8": _solve(mesh, refined, CFG8, 4),
            "pieces": {"six": _pieces(mesh, arrays, CFG, None), "eight": _pieces(mesh, refined, CFG8_FROZEN, None),
                       "big": _pieces(mesh, arrays, CFG, 4)}}


def jax_problem(seed=7, refine=False):
    from sfm_tpu.ba import build_problem
    from sfm_tpu.utils.synthetic import make_orbit_scene
    from tests.unit.test_ba import scene_to_reconstruction

    scene = make_orbit_scene(num_cameras=8, num_points=64, noise_px=0.3, seed=seed)
    prob, _, _ = build_problem(scene_to_reconstruction(scene, pose_noise=0.01, point_noise=0.03, seed=seed + 1),
                               refine_intrinsics=refine)
    return prob


def numpy_problem(jprob) -> dict:
    return {f.name: (int if f.name == "point_align" else np.asarray)(getattr(jprob, f.name))
            for f in dataclasses.fields(jprob)}


@pytest.fixture(scope="module")
def problems():
    return numpy_problem(jax_problem()), numpy_problem(jax_problem(refine=True))


@pytest.fixture(scope="module")
def sharded(problems, tmp_path_factory):
    """Each group size's runs, rank by rank (computed once per size)."""
    cache = {}

    def get(D):
        if D not in cache:
            init = tmp_path_factory.mktemp(f"ba{D}") / "init"
            cache[D] = run_ranks(_runs, D, problems, init_file=str(init), timeout=TIMEOUT)
        return cache[D]

    return get


def single(arrays, cfg_kwargs, max_cams=None):
    saved = core.MAX_CAMS
    core.MAX_CAMS = saved if max_cams is None else max_cams
    try:
        out, stats = core.bundle_adjust(from_numpy_problem(arrays), BAConfig(**cfg_kwargs))
    finally:
        core.MAX_CAMS = saved
    return out.cam_params.numpy(), float(stats.final_cost)


def assert_agrees(run, ref_cams, ref_cost):
    cams, _, cost, _ = run
    np.testing.assert_allclose(cost, ref_cost, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(cams, ref_cams, atol=5e-3)


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ba_matches_single_process(sharded, problems, D):
    runs = sharded(D)
    arrays, refined = problems
    assert_agrees(runs[0]["six"], *single(arrays, CFG))
    assert_agrees(runs[0]["eight"], *single(refined, CFG8))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ba_large_camera_route(sharded, problems, D):
    """MAX_CAMS = 4 in the processes: K4 + K9, K6 and K8 + K9 with their
    all_reduces, against the single-process large-camera route."""
    assert_agrees(sharded(D)[0]["big"], *single(problems[0], CFG, max_cams=4))


def test_sharded_ba_large_camera_route_8_wide(sharded, problems):
    """The same at width 8 (focal and k1 refined) on two processes: K4, K6
    and K8 at D = 8 with their all_reduces, against the single-process
    large-camera route at width 8."""
    assert_agrees(sharded(2)[0]["big8"], *single(problems[1], CFG8, max_cams=4))


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_ba_deterministic_and_replicated(sharded, D):
    runs = sharded(D)
    for case in ("six", "eight", "big", "big8"):
        for r in runs[1:]:
            np.testing.assert_array_equal(r[case][0], runs[0][case][0])
            np.testing.assert_array_equal(r[case][1], runs[0][case][1])
            assert r[case][2:] == runs[0][case][2:]
    np.testing.assert_array_equal(runs[0]["again"][0], runs[0]["six"][0])
    np.testing.assert_array_equal(runs[0]["again"][1], runs[0]["six"][1])


def test_sharded_ba_matches_sfm_tpu(sharded):
    from sfm_tpu.config import BAConfig as JBAConfig
    from sfm_tpu.dist.mesh import make_mesh
    from sfm_tpu.dist.sharded_ba import bundle_adjust_sharded as jsharded
    from sfm_tpu.dist.sharded_ba import shard_problem_by_camera as jshard

    out, stats = jsharded(jshard(jax_problem(), 2), JBAConfig(**CFG), make_mesh(2))
    assert_agrees(sharded(2)[0]["six"], np.asarray(out.cam_params), float(stats.final_cost))


@pytest.mark.parametrize("D", [2, 3])
def test_shard_problem_by_camera_matches_sfm_tpu(D):
    from sfm_tpu.dist.sharded_ba import shard_problem_by_camera as jshard

    jprob = jax_problem()
    ours = shard_problem_by_camera(from_numpy_problem(numpy_problem(jprob)), D)
    theirs = jshard(jprob, D)
    for f in ("obs_cam", "obs_point", "obs_uv", "obs_w"):
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)))
    assert ours.point_align == theirs.point_align == 0


@pytest.mark.parametrize("D", [2, 4])
def test_sharded_plain_sums_match_sfm_tpu(D):
    """K3's sharded mode and K11's halves (plain), summed over D shards,
    against sfm_tpu's unsharded normal equations, Schur product and
    back-substitution at lam 1e-3."""
    import jax.numpy as jnp

    from sfm_tpu.ba import core as jcore
    from sfm_tpu.config import BAConfig as JBAConfig

    jprob = jax_problem()
    lam = 1e-3
    jcfg = JBAConfig(robust_loss="huber", robust_scale_px=2.0)
    ne_j = jcore.build_normal_equations(jprob, jprob.cam_params, jprob.points, lam, jcfg)
    prob = shard_problem_by_camera(from_numpy_problem(numpy_problem(jprob)), D)
    C, P, Dc = prob.num_cameras, prob.num_points, 6
    v = torch.from_numpy(np.random.default_rng(3).normal(size=(C, Dc)).astype(np.float32))
    shards = []
    for r in range(D):
        loc = local_rows(prob, r, D)
        inv = core.solve_invariants(loc)
        out = kb.fused_ne_sums(loc.obs_cam, loc.obs_point, loc.points, inv.static_t, loc.cam_params, loc.intrinsics,
                               inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, None, "huber", 2.0)
        shards.append((loc, inv, out))
    Hcc = sum(s[2][0] for s in shards)
    bc = sum(s[2][2] for s in shards)
    psums = sum(s[2][3] for s in shards)
    lam_t = torch.tensor(lam)
    Hpp_inv = kb.sym_solve3(kb.damp(kb.sym3(psums[:, :6]), lam_t))

    def close(a, b, name):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        np.testing.assert_allclose(a / max(np.abs(b).max(), 1.0), b / max(np.abs(b).max(), 1.0), atol=1e-4,
                                   err_msg=name)

    close(kb.damp(Hcc, lam_t), ne_j.Hcc, "Hcc")
    close(bc, ne_j.bc, "bc")
    close(psums[:, 6:9], ne_j.bp, "bp")
    close(Hpp_inv, ne_j.Hpp_inv, "Hpp_inv")
    g = sum(kb.coupling_point_half(s[2][1], s[0].obs_cam, s[1].point_bounds, v) for s in shards)
    h = torch.einsum("pij,pj->pi", Hpp_inv, g)
    coupling = sum(kb.coupling_camera_half(s[2][1], s[0].obs_point, s[1].point_bounds, s[1].cam_perm,
                                           s[1].cam_bounds, s[1].cam_inv_perm, h) for s in shards)
    sv = torch.einsum("cij,cj->ci", kb.damp(Hcc, lam_t), v) - coupling
    close(sv, jcore._schur_matvec(ne_j, jprob, jnp.asarray(v.numpy())), "S v")
    dp = torch.einsum("pij,pj->pi", Hpp_inv, psums[:, 6:9] - g)
    close(dp, jcore._back_substitute(ne_j, jprob, jnp.asarray(v.numpy())), "dp")


@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("route", ["six", "eight", "big"])
def test_sharded_lm_pieces_match_single_process(sharded, problems, D, route):
    """The traps of the sharded LM, each against the single-process route on
    the same problem (1e-5 of each array's max):
    - the damping after the all-reduce: the padding points' blocks (no
      observation on any process) come out as the single route's 1e6 I
      exactly (damped on each process first they would be 1e6 / D I);
    - the Schur-Jacobi blocks from the summed Hpp^-1, the rhs and S v
      (K11's halves with an all-reduce between them);
    - the candidate: the point step from the all-reduced point half of the
      whole step, then the frozen focal column zeroed (8 wide) and the
      cost of K5's cost mode summed over the processes;
    - past MAX_CAMS (MAX_CAMS = 4): K4 + K9, K8 + K9, K6 in their place."""
    arrays, refined = problems
    cfg, arr = {"six": (CFG, arrays), "eight": (CFG8_FROZEN, refined), "big": (CFG, arrays)}[route]
    saved = core.MAX_CAMS
    core.MAX_CAMS = 4 if route == "big" else saved
    try:
        prob = from_numpy_problem(arr)
        ref = pieces(prob, BAConfig(**cfg))
    finally:
        core.MAX_CAMS = saved
    unseen = np.bincount(arr["obs_point"][arr["obs_w"] > 0], minlength=arr["points"].shape[0]) == 0
    assert unseen.any()
    for r in sharded(D):
        got = r["pieces"][route]
        np.testing.assert_array_equal(got["Hpp_inv"][unseen], ref["Hpp_inv"][unseen])
        for k, b in ref.items():
            a = got[k]
            scale = max(float(np.abs(b).max()), 1e-30)
            np.testing.assert_allclose(a / scale, b / scale, atol=1e-5, err_msg=k)
        if route == "eight":
            np.testing.assert_array_equal(got["cams"][:, 6], arr["cam_params"][:, 6])


@pytest.mark.parametrize("D", [2, 3])
def test_local_rows_sorted_by_point(D):
    """Each shard's rows, as its process solves them: the same weighted
    observations as the shard's, sorted by point (stable), the padding rows
    (weight 0) after them."""
    prob = shard_problem_by_camera(from_numpy_problem(numpy_problem(jax_problem())), D)
    cap = prob.obs_w.shape[0] // D
    for r in range(D):
        loc = local_rows(prob, r, D)
        w = loc.obs_w.numpy()
        n = int((w > 0).sum())
        assert (w[:n] > 0).all() and (w[n:] == 0).all()
        op = loc.obs_point.numpy()[:n]
        assert (np.diff(op) >= 0).all()
        rows = slice(r * cap, (r + 1) * cap)
        keep = prob.obs_w[rows].numpy() > 0
        key = lambda t: sorted(zip(t[0].tolist(), t[1].tolist(), map(tuple, t[2].tolist())))
        assert key((loc.obs_point.numpy()[:n], loc.obs_cam.numpy()[:n], loc.obs_uv.numpy()[:n])) == key(
            (prob.obs_point[rows].numpy()[keep], prob.obs_cam[rows].numpy()[keep], prob.obs_uv[rows].numpy()[keep]))
