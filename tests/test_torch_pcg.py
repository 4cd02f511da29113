"""The fused PCG solve (pcg_solve, csrc/schur_kernels.cu): its plain version
against sfm_tpu.ba.core._pcg, the plan that cuts its work into co-resident
blocks, and the C signature its wrapper calls.

Tolerances:
- pcg_solve_plain vs sfm_tpu's _pcg on the same normal equations and the
  same Schur-Jacobi preconditioner: 1e-3 of the solution's scale after 64
  steps (or until the tolerance freezes the solve: fp32 summation order
  drifts the iterates), 1e-5 after one step (one matvec and a few dot
  products apart).
- A zero right-hand side gives exactly x = 0, no NaN, in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import schur_matvec_step
from sfm_tpu.ba import core as jcore
from sfm_tpu.config import BAConfig as JBAConfig
from sfm_tpu_torch.ba import core
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels import ba_kernels as kb
from tests.test_torch_ba import _jax_pcg_setup, close

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def pcg_case():
    """sfm_tpu's normal equations of the 12-camera orbit problem, handed to
    the port as they are (W, Hpp^-1, Hcc, the preconditioner, the rhs)."""
    jprob, prob, _, ne_j = _jax_pcg_setup()
    O = prob.obs_w.shape[0]
    inv = core.solve_invariants(prob)
    t = lambda a: torch.from_numpy(np.array(a))
    args = dict(W_t=t(ne_j.W.reshape(O, 18).T), Hpp_inv=t(ne_j.Hpp_inv), obs_cam=prob.obs_cam,
                obs_point=prob.obs_point, point_bounds=inv.point_bounds, cam_perm=inv.cam_perm,
                cam_bounds=inv.cam_bounds, Hcc=t(ne_j.Hcc), M_inv=t(ne_j.M_inv), d=t(ne_j.sdiag))
    return jprob, ne_j, jcore._schur_rhs(ne_j, jprob), args


@pytest.mark.parametrize("iterations, tolerance, tol", [
    (64, 1e-6, 1e-3),     # the default config
    (64, 1e-2, 1e-3),     # the freeze fires after a few steps
    (1, 1e-6, 1e-5),      # one step
])
def test_pcg_solve_plain_matches_jax(pcg_case, iterations, tolerance, tol):
    jprob, ne_j, rhs, args = pcg_case
    jcfg = JBAConfig(dense_schur_max_cameras=0, cg_iterations=iterations, cg_tolerance=tolerance)
    x_j = np.asarray(jcore._pcg(ne_j, jprob, rhs, jcfg))
    x_t = kb.pcg_solve_plain(**args, rhs=torch.from_numpy(np.array(rhs)), iterations=iterations,
                             tolerance=tolerance)
    close(x_t, x_j, f"x after {iterations} steps", tol=tol)
    # The wrapper on CPU tensors is the plain version.
    inv_perm = kb.invert_permutation(args["cam_perm"], int(args["point_bounds"][-1]))
    x_w = kb.pcg_solve(**args, cam_inv_perm=inv_perm, rhs=torch.from_numpy(np.array(rhs)),
                       iterations=iterations, tolerance=tolerance)
    assert torch.equal(x_w, x_t)


def test_zero_rhs_gives_zero(pcg_case):
    jprob, ne_j, rhs, args = pcg_case
    zero = np.zeros(np.asarray(rhs).shape, np.float32)
    x_j = np.asarray(jcore._pcg(ne_j, jprob, jnp.asarray(zero), JBAConfig(dense_schur_max_cameras=0)))
    x_t = kb.pcg_solve_plain(**args, rhs=torch.from_numpy(zero), iterations=64, tolerance=1e-6)
    assert np.isfinite(x_j).all() and not np.any(x_j)
    assert bool(torch.isfinite(x_t).all()) and not bool(x_t.any())


def test_core_pcg_takes_the_fused_solve_up_to_max_cams(pcg_case, monkeypatch):
    """ba/core._pcg hands the whole solve to pcg_solve (one call, the
    preconditioner built as before): on the CPU the same bits as pcg_loop over
    the coupling matvec (tests/test_torch_ba_bigc.py holds the large-C
    route, which runs that loop over K10 and K9)."""
    _, prob, _, ne_j = _jax_pcg_setup()
    inv = core.solve_invariants(prob)
    ne_t = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                       core.BAConfig(dense_schur_max_cameras=0), inv, schur_jacobi=True)
    rhs = core._schur_rhs(ne_t, prob, inv)
    calls = []
    inner = core.pcg_solve

    def counted(*a, **k):
        calls.append(a)
        return inner(*a, **k)

    monkeypatch.setattr(core, "pcg_solve", counted)
    x = core._pcg(ne_t, prob, rhs, core.BAConfig(dense_schur_max_cameras=0), inv)
    assert len(calls) == 1
    M_inv, d = core.pcg_preconditioner(ne_t, prob, inv)
    ref = kb.pcg_loop(lambda v: schur_matvec_step(ne_t, prob, v, inv), M_inv, d, rhs, 64, 1e-6)
    assert torch.equal(x, ref)


def test_bundle_adjust_makes_the_launch_plan_once(monkeypatch):
    """The launch plan reads point_bounds back to the host: solve_invariants
    makes it once per bundle_adjust and every LM iteration's pcg_solve takes
    that plan (here the card's plan is stood in for by pcg_plan on 4 blocks)."""
    _, prob, _, _ = _jax_pcg_setup()
    plans, used = [], []

    def launch_plan(point_bounds, cam_dim=6):
        plans.append(kb.pcg_plan(point_bounds, 4, cam_dim=cam_dim))
        return plans[-1]

    inner = core.pcg_solve

    def counted(*a, plan=None, **k):
        used.append(plan)
        return inner(*a, plan=plan, **k)

    monkeypatch.setattr(core, "on_cuda", lambda t: True)
    monkeypatch.setattr(core, "pcg_launch_plan", launch_plan)
    monkeypatch.setattr(core, "pcg_solve", counted)
    _, stats = core.bundle_adjust(prob, core.BAConfig(dense_schur_max_cameras=0, max_iterations=3))
    assert len(plans) == 1 and len(used) == stats.iterations >= 2
    assert all(p is plans[0] for p in used)


def test_solve_invariants_plans_only_the_fused_route(monkeypatch):
    """solve_invariants makes pcg_solve's launch plan on the card only (none
    on the CPU, where pcg_solve is its plain version), at any camera count:
    past MAX_CAMS every CG solve is one pcg_solve launch too."""
    _, prob, _, _ = _jax_pcg_setup()
    assert core.solve_invariants(prob).pcg_plan is None
    monkeypatch.setattr(core, "on_cuda", lambda t: True)
    monkeypatch.setattr(core, "pcg_launch_plan",
                        lambda point_bounds, cam_dim=6: kb.pcg_plan(point_bounds, 4, cam_dim=cam_dim))
    assert core.solve_invariants(prob).pcg_plan.grid == 4
    monkeypatch.setattr(core, "MAX_CAMS", prob.num_cameras - 1)
    assert core.uses_big_kernels(prob)
    assert core.solve_invariants(prob).pcg_plan.grid == 4


# ---- the plan ---------------------------------------------------------------


def _bounds(lengths) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32))


def slice_bounds():
    """The incremental slice's final global BA: 10,867 points in tracks of
    2-5 views (38,052 weighted observations) among 16,384 padded slots."""
    rng = np.random.default_rng(0)
    lengths = rng.integers(2, 5, 10867)
    lengths[: 38052 - int(lengths.sum())] += 1
    lengths = np.concatenate([lengths, np.zeros(16384 - 10867, np.int64)])
    assert lengths.sum() == 38052
    return _bounds(lengths)


def orbit_bounds():
    """The orbit problem (chip_smoke.schur_problem): 500 points in ~100 views."""
    lengths = np.random.default_rng(1).integers(60, 141, 500)
    return _bounds(np.concatenate([lengths, np.zeros(12, np.int64)]))


def big_bounds():
    """C = 4,096, O = 1 M: 10,000 points in tracks of 100."""
    return _bounds(np.full(10000, 100))


def polish_bounds(points=16000, slots=16128):
    """The merged polish's layout (chip_smoke.arc_ring_reconstruction at
    POLISH_*): 16,000 points in tracks of 40-150 views (~1.52 M
    observations), the capacity padding's empty slots after them."""
    lengths = np.random.default_rng(3).integers(40, 151, points)
    return _bounds(np.concatenate([lengths, np.zeros(slots - points, np.int64)]))


def small_polish_bounds():
    """The same long tracks, 600 points (~57,000 observations)."""
    return polish_bounds(600, 640)


@pytest.mark.parametrize("make, sms, per_sm, streaming, lanes", [
    (slice_bounds, 132, 1, False, 4),     # tracks of 3.5: groups of 4 lanes
    (slice_bounds, 132, 2, False, 4),
    (orbit_bounds, 132, 1, False, 32),    # tracks of ~100: a warp per point
    (big_bounds, 132, 1, True, 32),
    (big_bounds, 132, 2, True, 32),
    (polish_bounds, 132, 1, True, 32),      # ~11,500 observations a block: 920 KB staged
    (small_polish_bounds, 8, 1, True, 32),  # ~7,100 a block
    (small_polish_bounds, 132, 1, False, 32),
])
def test_plan_cuts_balanced_point_ranges(make, sms, per_sm, streaming, lanes):
    pb = make()
    P, N = pb.numel() - 1, int(pb[-1])
    plan = kb.pcg_plan(pb, sms, per_sm)
    G = sms * per_sm
    assert plan.grid == G and plan.streaming == streaming and plan.lanes == lanes
    bp = plan.block_points.long()
    assert bp.shape == (G + 1,) and plan.block_points.dtype == torch.int32
    # Every point in exactly one block: contiguous, non-decreasing ranges
    # from 0 to P (so cut only at point boundaries).
    assert int(bp[0]) == 0 and int(bp[-1]) == P and bool((bp[1:] >= bp[:-1]).all())
    counts = pb.long()[bp[1:]] - pb.long()[bp[:-1]]
    assert int(counts.sum()) == N and int(counts.max()) == plan.max_slice
    longest = int((pb[1:] - pb[:-1]).max())
    assert float((counts - N / G).abs().max()) <= longest + 1
    # Streaming exactly where the largest slice's staged rows pass the budget.
    words = -(-(plan.max_slice + 3) // 4) * 4
    assert streaming == (kb.PCG_STAGED_ROWS * 4 * words > kb.PCG_SMEM_BUDGET)
    if streaming:
        assert plan.smem_bytes == 0 and plan.stride == 0
    else:
        assert plan.smem_bytes <= kb.PCG_SMEM_BUDGET
        assert plan.stride % 4 == 0 and plan.stride >= plan.max_slice + 3
        assert plan.smem_bytes == kb.PCG_STAGED_ROWS * 4 * plan.stride


def test_plan_streams_on_request_and_past_the_budget():
    pb = slice_bounds()
    assert kb.pcg_plan(pb, 132, streaming=True).streaming
    assert not kb.pcg_plan(pb, 132).streaming
    assert kb.pcg_plan(pb, 1).streaming          # 38,052 observations on one block
    # About 330,000 observations on 132 blocks fill the budget.
    assert not kb.pcg_plan(_bounds(np.full(3000, 100)), 132).streaming
    assert kb.pcg_plan(_bounds(np.full(3500, 100)), 132).streaming


def test_plan_of_an_empty_problem():
    plan = kb.pcg_plan(torch.zeros(1, dtype=torch.int32), 4)
    assert plan.max_slice == 0 and not plan.streaming
    assert plan.block_points.tolist() == [0, 0, 0, 0, 0]


def test_pcg_signature_takes_what_the_wrapper_passes(pcg_case, monkeypatch):
    """The C entry's argument count is what pcg_solve passes plus the stream
    (a mismatch would be silent memory corruption): 11 pointers in, O, C,
    iterations, tolerance, streaming, grid, lanes, stride, smem bytes, 3
    pointers out, stream."""
    _, _, rhs, args = pcg_case
    passed = []
    monkeypatch.setattr(kb, "on_cuda", lambda t: True)
    monkeypatch.setattr(kb, "check", lambda *a: None)
    monkeypatch.setattr(kb, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    plan = kb.pcg_plan(args["point_bounds"], 4)
    inv_perm = kb.invert_permutation(args["cam_perm"], int(args["point_bounds"][-1]))
    kb.pcg_solve(**args, cam_inv_perm=inv_perm, rhs=torch.from_numpy(np.array(rhs)), iterations=64,
                 tolerance=1e-6, plan=plan)
    (entry, name, a), = passed
    assert entry == "sfm_pcg_solve" and name == "pcg_solve"
    assert len(_SIGNATURES[entry]) == len(a) + 1 == 24
    assert len(_SIGNATURES["sfm_pcg_blocks_per_sm"]) == 3
