"""What the hand-written K2 and K9 kernels take from Python: launch widths,
the inverse camera permutation, scratch sizes; and the plain versions on the
cases their designs make interesting, against sfm_tpu.

Tolerances:
- cam_segment_sum plain version vs jax.ops.segment_sum: 1e-6 of the output's
  max (both add in fp32, in different orders, up to a few thousand terms).
- match_topk2 plain version vs sfm_tpu match_topk2 (Pallas, interpret mode):
  argmin equal on every row whose two nearest distances are more than 1e-3
  apart (or exactly tied: the lower column), d1/d2 rtol 1e-5 + atol 1e-6
  (the bf16 Gram is summed in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.kernels.match_topk import match_topk2 as jtopk2
from sfm_tpu_torch.ba import build_problem, core
from sfm_tpu_torch.kernels import _SIGNATURES
from sfm_tpu_torch.kernels.ba_kernels import (
    cam_segment_sum, invert_permutation, segment_bounds, segment_lanes, segment_warps,
)
from sfm_tpu_torch.kernels.match_topk import BIG, TILE_COLS, match_topk2, padded_cols
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.synthetic import make_orbit_scene

torch.set_num_threads(2)


# ---- K9: launch widths ------------------------------------------------------


@pytest.mark.parametrize("num_obs, num_segments, lanes", [
    (38464, 16384, 4),      # tracks of ~2.3 views (two-view and incremental slices)
    (65536, 512, 32),       # ~128 views per point: a whole warp
    (1914880, 16128, 32),   # the merged model's long tracks: capped at a warp
    (1000, 1000, 1),
    (1001, 1000, 2),
    (17, 2, 16),
    (0, 5, 1),
    (5, 0, 8),              # no segment: any valid width (nothing is launched)
])
def test_segment_lanes_hold_the_mean_segment(num_obs, num_segments, lanes):
    got = segment_lanes(num_obs, num_segments)
    assert got == lanes
    assert 1 <= got <= 32 and got & (got - 1) == 0


@pytest.mark.parametrize("num_obs, num_segments, warps", [
    (38464, 128, 8),         # the incremental slice's final BA: few long segments
    (50000, 128, 8),
    (1516323, 10240, 1),     # the merged model: the segments alone fill the card
    (2_000_000, 16, 32),     # a few huge segments: the cap
    (4000, 128, 1),          # short segments: one warp holds them
    (12800, 100, 4),         # 128 per segment: 32 for each of four warps
    (0, 16, 1),
])
def test_segment_warps_fill_the_card_without_starving_a_warp(num_obs, num_segments, warps):
    got = segment_warps(num_obs, num_segments)
    assert got == warps
    assert 1 <= got <= 32 and got & (got - 1) == 0


def test_invert_permutation_marks_what_the_permutation_leaves_out():
    perm = torch.tensor([4, 0, 6, 2], dtype=torch.int32)
    inv = invert_permutation(perm, 8)
    assert inv.dtype == torch.int32
    assert inv.tolist() == [1, -1, 3, -1, 0, -1, 2, -1]
    full = torch.from_numpy(np.random.default_rng(0).permutation(100).astype(np.int32))
    inv = invert_permutation(full, 100)
    assert torch.equal(inv[full.long()], torch.arange(100, dtype=torch.int32))
    assert torch.equal(full[inv.long()], torch.arange(100, dtype=torch.int32))


def _orbit_problem(num_cameras=12, num_points=60):
    """An orbit problem whose tracks (~num_cameras views) leave alignment
    gaps between the point segments: zero-weight rows inside [0, N)."""
    scene = make_orbit_scene(num_cameras=num_cameras, num_points=num_points, image_size=(512, 512),
                             focal=600.0, noise_px=0.5, seed=5)
    obs = np.argwhere(scene.visible)
    rec = Reconstruction(
        intrinsics=scene.intrinsics.copy(), rvecs=scene.rvecs.copy(), tvecs=scene.tvecs.copy(),
        registered=np.ones(num_cameras, bool), points=scene.points.copy(),
        point_errors=np.zeros(num_points, np.float32), point_valid=np.ones(num_points, bool),
        obs_point=obs[:, 1].astype(np.int32), obs_image=obs[:, 0].astype(np.int32),
        obs_kp=obs[:, 1].astype(np.int32),
        obs_uv=scene.pixels[obs[:, 0], obs[:, 1]].astype(np.float32))
    return build_problem(rec, device="cpu")[0]


def test_camera_tables_list_the_weighted_observations():
    """cam_inv_perm inverts cam_perm on the weighted observations of [0, N);
    the zero-weight rows between point segments (all of camera 0) and the
    padding tail are in no camera segment, so no segment is longer than a
    camera's own observations."""
    prob = _orbit_problem()
    inv = core.solve_invariants(prob)
    weighted = torch.nonzero(prob.obs_w).flatten()
    n = int(weighted[-1]) + 1
    assert n < prob.obs_w.shape[0]                       # a padding tail
    assert weighted.numel() < n                          # and gaps inside [0, N)
    assert inv.cam_inv_perm.shape == (n,) and inv.cam_inv_perm.dtype == torch.int32
    assert inv.cam_perm.shape == (weighted.numel(),)
    assert torch.equal(inv.cam_inv_perm[inv.cam_perm.long()],
                       torch.arange(weighted.numel(), dtype=torch.int32))
    assert torch.equal(inv.cam_inv_perm >= 0, prob.obs_w[:n] != 0)
    cams = prob.obs_cam[inv.cam_perm.long()]
    assert bool((cams[1:] >= cams[:-1]).all())           # sorted by camera
    same = cams[1:] == cams[:-1]
    assert bool((inv.cam_perm[1:][same] > inv.cam_perm[:-1][same]).all())   # stable
    lengths = inv.cam_bounds[1:] - inv.cam_bounds[:-1]
    counts = torch.bincount(prob.obs_cam[weighted].long(), minlength=prob.num_cameras)
    assert torch.equal(lengths.long(), counts)
    assert int(inv.cam_bounds[-1]) == weighted.numel()


def test_k7_k10_signatures_take_what_the_wrappers_pass(monkeypatch):
    """The C entries of the standalone K7 (W, Hpp^-1, point ids, inverse
    camera permutation, camera bounds, O, N, C, warps, packed, out) and K10
    (W, Hpp^-1, point bounds, v per observation, O, P, N, lanes, y) take
    what their wrappers pass, plus the stream."""
    from sfm_tpu_torch.kernels import ba_kernels as kb

    O, P, C = 64, 8, 4
    obs_point = (torch.arange(O) // 8).to(torch.int32)
    obs_cam = (torch.arange(O) % C).to(torch.int32)
    perm = torch.argsort(obs_cam, stable=True).to(torch.int32)
    passed = []
    monkeypatch.setattr(kb, "on_cuda", lambda t: True)
    monkeypatch.setattr(kb, "check", lambda *a: None)
    monkeypatch.setattr(kb, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    kb.whw_cam_reduce(torch.zeros(18, O), torch.zeros(P, 3, 3), obs_point, perm,
                      segment_bounds(obs_cam[perm.long()], C), kb.invert_permutation(perm, O))
    kb.schur_coupling_payloads_big(torch.zeros(18, O), torch.zeros(P, 3, 3), obs_point,
                                   segment_bounds(obs_point, P), O, torch.zeros(6, O))
    assert [(e, n) for e, n, _ in passed] == [("sfm_whw_cam_reduce", "whw_cam_reduce"),
                                              ("sfm_schur_coupling_payloads_big",
                                               "schur_coupling_payloads_big")]
    for entry, _, a in passed:
        assert len(_SIGNATURES[entry]) == len(a) + 1, entry
    assert len(_SIGNATURES["sfm_whw_cam_reduce"]) == 12
    assert len(_SIGNATURES["sfm_schur_coupling_payloads_big"]) == 10


def test_segment_sum_signatures_carry_the_scratch():
    """The C entry points take what the wrappers pass (a mismatch would be
    silent memory corruption): K9 values, inv_perm, bounds, O, K, S, N,
    width, packed, out, stream; K2 da, db, vb, P, N1, N2, N2pad, na, nb,
    d1, d2, idx, stream."""
    assert len(_SIGNATURES["sfm_segment_sum"]) == 11
    assert len(_SIGNATURES["sfm_match_topk2"]) == 13


# ---- K9: the plain version against jax.ops.segment_sum ----------------------


def _segment_case(name, rng, O):
    """(segment ids [N] of the first N <= O observations, number of segments)."""
    if name == "empty_segments":          # 100 of 128 segments used, as C = 128 for 100 cameras
        return rng.integers(0, 100, O).astype(np.int32), 128
    if name == "one_segment_holds_everything":
        return np.full(O, 3, np.int32), 8
    if name == "tail_outside_every_segment":   # N < O
        return rng.integers(0, 40, O - 300).astype(np.int32), 40
    if name == "short_segments":          # tracks of two or three views
        return np.sort(rng.integers(0, O // 2, O)).astype(np.int32), O // 2
    raise ValueError(name)


@pytest.mark.parametrize("K", [3, 6, 9, 36, 42])
@pytest.mark.parametrize("case", ["empty_segments", "one_segment_holds_everything",
                                  "tail_outside_every_segment", "short_segments"])
def test_segment_sum_plain_matches_jax_on(case, K):
    rng = np.random.default_rng(K)
    O = 2048
    ids, S = _segment_case(case, rng, O)
    N = len(ids)
    v = rng.normal(size=(O, K)).astype(np.float32)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(v[:N]), jnp.asarray(ids), S))
    ids_t = torch.from_numpy(ids)
    values_t = torch.from_numpy(v.T.copy())
    if bool((ids_t[1:] >= ids_t[:-1]).all()):
        perm, bounds = None, segment_bounds(ids_t, S)
    else:
        order = torch.argsort(ids_t, stable=True)
        perm, bounds = order.to(torch.int32), segment_bounds(ids_t[order], S)
    out = cam_segment_sum(values_t, perm, bounds).numpy()
    assert out.shape == (S, K)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(np.abs(ref).max(), 1.0))
    empty = np.bincount(ids, minlength=S) == 0
    assert not out[empty].any()
    if perm is not None:      # the same sums with the inverse table handed in
        again = cam_segment_sum(values_t, perm, bounds, invert_permutation(perm, N)).numpy()
        np.testing.assert_array_equal(again, out)


# ---- K2 ---------------------------------------------------------------------


@pytest.mark.parametrize("n2, padded", [(1, 128), (50, 128), (128, 128), (129, 256), (999, 1024),
                                        (4096, 4096)])
def test_padded_cols_is_whole_tiles(n2, padded):
    assert padded_cols(n2) == padded
    assert padded % TILE_COLS == 0 and 0 <= padded - n2 < TILE_COLS


def _unit(rng, *shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _pallas(da, db, vb):
    return tuple(np.stack(x) for x in zip(*(
        [np.asarray(a) for a in jtopk2(jnp.asarray(da[p]), jnp.asarray(db[p]), jnp.asarray(vb[p]),
                                       interpret=True)] for p in range(len(da)))))


def test_topk2_plain_matches_pallas_on_a_batch_of_differing_validity():
    """Three pairs: the usual invalid tail, every column invalid (d1 = d2 =
    1e9 and idx = 0), half the columns invalid; invalid rows hold NaN."""
    rng = np.random.default_rng(0)
    P, N = 3, 512
    db = _unit(rng, P, N, 128)
    src = rng.integers(0, N // 2, (P, N))
    da = np.take_along_axis(db, src[:, :, None], 1) + 0.05 * rng.normal(size=(P, N, 128)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    vb = np.arange(N)[None] < np.asarray([480, 0, 256])[:, None]
    db[~vb] = np.nan
    j1, j2, jidx = _pallas(da, db, vb)
    t1, t2, tidx = (t.numpy() for t in match_topk2(*(torch.from_numpy(a) for a in (da, db, vb))))
    assert tidx.dtype == np.int32 and t1.shape == t2.shape == tidx.shape == (P, N)
    clear = (j2 - j1) > 1e-3
    assert clear[0].sum() > 400 and clear[2].sum() > 400
    np.testing.assert_array_equal(tidx[clear], jidx[clear])
    np.testing.assert_allclose(t1, j1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=1e-5, atol=1e-6)
    assert (t1[1] == BIG).all() and (t2[1] == BIG).all() and (tidx[1] == 0).all()
    assert (j1[1] == BIG).all() and (jidx[1] == 0).all()
    assert (tidx[0] < 480).all() and (tidx[2] < 256).all()


def test_topk2_exact_ties_go_to_the_lower_column():
    """Columns 40 and 7 of db are the same row, and so are 300 and 411: a row
    of da that is nearest to one of them is exactly as near to its twin, d1
    equals d2, and argmin names the lower column."""
    rng = np.random.default_rng(1)
    N = 512
    db = _unit(rng, 1, N, 128)
    db[0, 40] = db[0, 7]
    db[0, 411] = db[0, 300]
    da = _unit(rng, 1, N, 128)
    da[0, :64] = db[0, 7] + 0.01 * rng.normal(size=(64, 128)).astype(np.float32)
    da[0, 64:128] = db[0, 411] + 0.01 * rng.normal(size=(64, 128)).astype(np.float32)
    vb = np.ones((1, N), bool)
    j1, j2, jidx = _pallas(da, db, vb)
    t1, t2, tidx = (t.numpy() for t in match_topk2(*(torch.from_numpy(a) for a in (da, db, vb))))
    assert (tidx[0, :64] == 7).all() and (tidx[0, 64:128] == 300).all()
    np.testing.assert_array_equal(t1[0, :128], t2[0, :128])
    np.testing.assert_array_equal(tidx[0, :128], jidx[0, :128])
    np.testing.assert_allclose(t1, j1, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(t2, j2, rtol=1e-5, atol=1e-6)


def test_topk2_takes_fewer_columns_than_a_tile():
    """N2 = 50 (less than one 128-column tile) and a ragged N1."""
    rng = np.random.default_rng(2)
    db = _unit(rng, 1, 50, 128)
    da = _unit(rng, 1, 70, 128)
    da[0, :50] = db[0] + 0.02 * rng.normal(size=(50, 128)).astype(np.float32)
    vb = np.ones((1, 50), bool)
    t1, t2, tidx = (t.numpy() for t in match_topk2(*(torch.from_numpy(a) for a in (da, db, vb))))
    np.testing.assert_array_equal(tidx[0, :50], np.arange(50))
    a = torch.from_numpy(da).to(torch.bfloat16).double()[0]
    b = torch.from_numpy(db).to(torch.bfloat16).double()[0]
    d = torch.cdist(a, b) ** 2
    ref = d.sort(dim=1).values.numpy()
    np.testing.assert_allclose(t1[0], ref[:, 0], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t2[0], ref[:, 1], rtol=1e-4, atol=1e-5)


# ---- K1: the tile plan --------------------------------------------------------


# Shared memory of one SM of an H100 (228 KB; a block may take 227 KB) and
# the 1 KB the card reserves for each resident block.
_SM_SMEM = 233472
_BLOCK_SMEM = 232448
_SMEM_RESERVED = 1024
_SMS = 132


def _k1_shapes():
    """(B, H, W) of every octave of a chunk of 8 and a last chunk of 4 on
    1024^2 and 2048^2 canvases, and the ragged shapes K1 is checked on."""
    shapes = [(b, s >> o, s >> o) for s in (1024, 2048) for o in range(4) for b in (8, 4)]
    return shapes + [(3, 200, 328), (2, 136, 200), (2, 136, 203), (1, 8, 8), (1, 1024, 1024)]


@pytest.mark.parametrize("B, H, W", _k1_shapes())
def test_dog_tiles_cover_every_pixel_once(B, H, W):
    """Block (bx, by)'s thread (tx, ty) owns rows by*TH + 2*ty + {0, 1} and
    columns bx*TW + 4*tx + {0..3} (csrc/dog_extrema.cu): every pixel of the
    image is owned exactly once, and the plan fills the card."""
    from sfm_tpu_torch.kernels import dog_extrema as k1

    tile = k1.dog_launch_plan(B, H, W)
    th, tw = tile
    assert tile in k1.TILES
    gx, gy = k1.tile_grid(tile, H, W)
    tx = np.arange(tw // 4)
    ty = np.arange(th // k1.ROWS_PER_THREAD)
    assert len(tx) * len(ty) == k1.tile_threads(tile)
    rows = (np.arange(gy)[:, None, None] * th + k1.ROWS_PER_THREAD * ty[None, :, None]
            + np.arange(k1.ROWS_PER_THREAD)[None, None, :]).reshape(-1)
    cols = (np.arange(gx)[:, None, None] * tw + 4 * tx[None, :, None]
            + np.arange(4)[None, None, :]).reshape(-1)
    count = np.zeros((H, W), np.int64)
    np.add.at(count, np.ix_(rows[rows < H], cols[cols < W]), 1)
    assert (count == 1).all()
    blocks = B * gx * gy
    if blocks < k1.FILL_BLOCKS:           # only the smallest tile may leave SMs short
        assert tile == k1.TILES[-1]
    if B == 8:                             # a full chunk spreads over every SM
        assert blocks >= _SMS


@pytest.mark.parametrize("tile", [(16, 64), (16, 32)])
def test_dog_tiles_fit_two_blocks_an_sm(tile):
    from sfm_tpu_torch.kernels import dog_extrema as k1

    assert tile in k1.TILES
    smem = k1.tile_smem_bytes(tile)
    assert smem == (k1.STAGES + 1) * (tile[0] + 2) * (tile[1] + 8) * 4
    assert smem <= 48 * 1024 <= _BLOCK_SMEM          # no opt-in needed
    assert 2 * (smem + _SMEM_RESERVED) <= _SM_SMEM
    assert k1.tile_threads(tile) % 32 == 0 and k1.tile_threads(tile) <= 1024


# ---- the 8-wide builds: pcg_solve's plan, K3's packed rows, the C entries ----


def test_pcg_plan_stages_26_rows_at_width_8():
    """An 8-wide resident slice stages W's 24 rows, the camera and the place
    (104 bytes an observation): the final global BA's problem (C = 128,
    O = 65,536, 38,052 weighted observations) stays resident on 132
    blocks, and the shared-memory test streams a problem the 6-wide plan
    still stages."""
    from sfm_tpu_torch.kernels import ba_kernels as kb
    from tests.test_torch_pcg import _bounds, slice_bounds

    assert kb.pcg_staged_rows(8) == 26 and kb.pcg_staged_rows(6) == kb.PCG_STAGED_ROWS == 20
    pb = slice_bounds()
    for D in (6, 8):
        plan = kb.pcg_plan(pb, 132, cam_dim=D)
        assert plan.cam_dim == D and not plan.streaming
        assert plan.smem_bytes == kb.pcg_staged_rows(D) * 4 * plan.stride <= kb.PCG_SMEM_BUDGET
    wide, narrow = kb.pcg_plan(pb, 132, cam_dim=8), kb.pcg_plan(pb, 132)
    assert torch.equal(wide.block_points, narrow.block_points) and wide.stride == narrow.stride
    # Every weighted row staged: 65,536 x 104 bytes = 6.8 MB over the SMs' ~30 MB.
    assert 65536 * 4 * kb.pcg_staged_rows(8) < 132 * _BLOCK_SMEM
    # ~270,000 observations: 2,046 a block fit 20 rows (164 KB) but not 26 (213 KB).
    pb = _bounds(np.full(2700, 100))
    assert not kb.pcg_plan(pb, 132).streaming
    plan = kb.pcg_plan(pb, 132, cam_dim=8)
    assert plan.streaming and plan.smem_bytes == 0 and plan.stride == 0
    with pytest.raises(ValueError):
        kb.pcg_plan(pb, 132, cam_dim=7)


def test_k3_packed_rows_at_both_widths():
    """K3's camera row is D^2 + D floats (42, 72); with the Schur-Jacobi
    blocks it carries the D (D + 1) / 2 upper entries of W Hpp^-1 W^T padded
    to a multiple of 16 floats (64, 112); K7's standalone rows hold the
    entries in 16-byte rows (24, 36)."""
    from sfm_tpu_torch.kernels import ba_kernels as kb

    assert [kb.ne_cam_rows(D) for D in (6, 8)] == [kb.NE_CAM_ROWS, 72] == [42, 72]
    assert [kb.ne_pcg_rows(D) for D in (6, 8)] == [kb.NE_PCG_ROWS, 112] == [64, 112]
    assert [kb.whw_entries(D) for D in (6, 8)] == [21, 36]
    assert [kb.whw_row(D) for D in (6, 8)] == [24, 36]
    assert kb.upper(6) == kb._UPPER6 and len(kb.upper(8)) == 36
    for D in (6, 8):
        assert kb.ne_cam_rows(D) + kb.whw_entries(D) <= kb.ne_pcg_rows(D) and kb.ne_pcg_rows(D) % 16 == 0


@pytest.mark.parametrize("D", [6, 8])
def test_wide_entries_take_what_the_wrappers_pass(D, monkeypatch):
    """K3, K5 (with a step and its column mask), K7, K11 and pcg_solve at
    width D launch the entry built for it (`_w8` at D = 8, the same
    arguments as the 6-wide entry) and count under its name; the outputs
    have the width's shapes."""
    from sfm_tpu_torch.kernels import ba_kernels as kb

    scene = make_orbit_scene(num_cameras=4, num_points=30, noise_px=0.5, seed=3)
    obs = np.argwhere(scene.visible)
    rec = Reconstruction(
        intrinsics=scene.intrinsics.copy(), rvecs=scene.rvecs, tvecs=scene.tvecs,
        registered=np.ones(4, bool), points=scene.points, point_errors=np.zeros(30, np.float32),
        point_valid=np.ones(30, bool), obs_point=obs[:, 1].astype(np.int32),
        obs_image=obs[:, 0].astype(np.int32), obs_kp=obs[:, 1].astype(np.int32),
        obs_uv=scene.pixels[obs[:, 0], obs[:, 1]].astype(np.float32))
    prob, _, _ = build_problem(rec, refine_intrinsics=D == 8, device="cpu")
    assert prob.cam_params.shape[1] == D
    inv = core.solve_invariants(prob)
    plan = kb.pcg_plan(inv.point_bounds, 4, cam_dim=D)
    ne = core.build_normal_equations(prob, prob.cam_params, prob.points, torch.tensor(1e-3),
                                     core.BAConfig(), inv, schur_jacobi=True)
    passed = []
    monkeypatch.setattr(kb, "on_cuda", lambda t: True)
    monkeypatch.setattr(kb, "check", lambda *a: None)
    monkeypatch.setattr(kb, "launch", lambda entry, name, *a: passed.append((entry, name, a)))
    tables = (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params, prob.intrinsics)
    out = kb.fused_ne_payloads(*tables, inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm,
                               torch.tensor(1e-3), None, "huber", 4.0, plan=plan, schur_jacobi=True)
    assert out[0].shape == (prob.num_cameras, D, D) and out[2].shape == (3 * D, prob.obs_w.shape[0])
    assert out[5].shape[1] == kb.ne_pcg_rows(D) and out[6].shape == (prob.num_cameras, D * D)
    step = kb.LMStep(ne.bc.contiguous(), ne.W_t, ne.Hpp_inv, ne.bp, prob.cam_fixed, prob.point_fixed,
                     freeze_focal=D == 8)
    new_cams, _, _ = kb.fused_cost_sums(*tables, inv.point_bounds, None, "huber", 4.0, step=step, plan=plan)
    assert new_cams.shape == (prob.num_cameras, D)
    kb.whw_cam_reduce(ne.W_t, ne.Hpp_inv, prob.obs_point, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm)
    kb.schur_coupling_matvec(ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds,
                             inv.cam_perm, inv.cam_bounds, ne.bc.contiguous(), inv.cam_inv_perm)
    M_inv, d = core.pcg_preconditioner(ne, prob, inv)
    x = kb.pcg_solve(ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
                     inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d, ne.bc.contiguous(), 8, 1e-6,
                     plan=plan)
    assert x.shape == (prob.num_cameras, D)
    suffix = "" if D == 6 else "_w8"
    names = ["fused_ne_payloads", "fused_cost_sums", "whw_cam_reduce", "schur_coupling_matvec", "pcg_solve"]
    assert [(e, n) for e, n, _ in passed] == [(f"sfm_{n}{suffix}", f"{n}{suffix}") for n in names]
    for entry, _, a in passed:
        assert len(_SIGNATURES[entry]) == len(a) + 1, entry
        assert _SIGNATURES[entry] == _SIGNATURES[entry.removesuffix("_w8")]
    assert passed[1][2][21] == (1 if D == 8 else 0)     # K5's column mask: the focal frozen at D = 8
    with pytest.raises(ValueError, match="plan"):
        kb.pcg_solve(ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
                     inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d, ne.bc.contiguous(), 8, 1e-6,
                     plan=plan._replace(cam_dim=14 - D))
