"""The incremental engine of sfm_tpu_torch against sfm_tpu's (CPU).

Bars:
- on tests/integration/test_incremental.py's ring fixture (12 cameras,
  150 points, features and verified graph synthesized from the ground
  truth), both engines fed the same features and graph: all 12 registered,
  the port's mean reprojection error within 5% of sfm_tpu's (fp32 rounding
  and the frameworks' RANSAC draws differ), camera-centre RMSE after Sim(3)
  alignment < 0.04 (1% of the orbit radius);
- the host bookkeeping (init-pair ranking, local-BA camera sets) equals
  sfm_tpu's; the bootstrap pose search triangulates the same count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import BAConfig, EngineConfig, PipelineConfig, RansacConfig, config_to_dict
from sfm_tpu.pipeline import engine as jengine
from sfm_tpu.scene.tracks import build_tracks as jbuild_tracks
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.geometry.similarity import umeyama_np
from sfm_tpu_torch.pipeline import engine
from sfm_tpu_torch.scene.tracks import build_tracks
from sfm_tpu_torch.utils.interop import (
    from_numpy_feature_set, from_numpy_graph, from_numpy_reconstruction, from_numpy_tracks,
)
from tests.integration.test_incremental import scene_to_features_and_graph
from tests.unit.test_init_pair import _make_case

torch.set_num_threads(2)


def _tcfg(cfg):
    return tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))


def camera_rmse(rec, scene) -> float:
    from sfm_tpu.geometry.projection import camera_center

    est = np.stack([np.asarray(camera_center(jnp.asarray(rec.rvecs[i]), jnp.asarray(rec.tvecs[i])))
                    for i in range(scene.num_cameras)])
    gt = np.stack([np.asarray(camera_center(jnp.asarray(scene.rvecs[i]), jnp.asarray(scene.tvecs[i])))
                   for i in range(scene.num_cameras)])
    s, R, t = umeyama_np(est, gt)
    return float(np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(-1).mean()))


@pytest.fixture(scope="module")
def ring():
    scene = make_orbit_scene(num_cameras=12, num_points=150, noise_px=0.0, seed=10, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, noise=0.3, seed=11)
    cfg = PipelineConfig(
        engine=EngineConfig(local_ba_window=5, global_ba_every=6, checkpoint_every=4),
        ransac=RansacConfig(num_hypotheses=512),
        ba=BAConfig(max_iterations=20),
        verbose=False,
    )
    ref = jengine.incremental_reconstruct(feats, graph, scene.intrinsics.copy(), cfg)
    snaps = []
    rec = engine.incremental_reconstruct(
        from_numpy_feature_set(feats), from_numpy_graph(graph), scene.intrinsics.copy(), _tcfg(cfg),
        "cpu", checkpoint_cb=lambda step, snap: snaps.append((step, snap.num_registered)))
    return scene, feats, graph, cfg, ref, rec, snaps


def test_ring_registers_all(ring):
    scene, _, _, _, ref, rec, _ = ring
    assert ref.num_registered == rec.num_registered == scene.num_cameras


def test_ring_reprojection_matches_sfm_tpu(ring):
    _, _, _, _, ref, rec, _ = ring
    assert rec.mean_reprojection_error() < 0.6
    assert rec.mean_reprojection_error() == pytest.approx(ref.mean_reprojection_error(), rel=0.05)
    assert rec.num_points == pytest.approx(ref.num_points, rel=0.05)


def test_ring_geometry_vs_ground_truth(ring):
    scene, _, _, _, _, rec, _ = ring
    assert camera_rmse(rec, scene) < 0.04


def test_ring_checkpoints_and_engine_seconds(ring):
    _, _, _, _, _, rec, snaps = ring
    steps = [s for s, _ in snaps]
    assert len(snaps) >= 2 and steps == sorted(steps)
    assert all(n >= 4 for _, n in snaps)
    assert {"engine.pnp", "engine.triangulate", "engine.local_ba", "engine.global_ba",
            "engine.filter"} <= set(rec.stage_seconds)
    assert all(v >= 0.0 for v in rec.stage_seconds.values())


def test_tracks_interop_feeds_both_engines_the_same_tracks(ring):
    _, feats, graph, _, _, _, _ = ring
    B, N = feats.valid.shape
    ref = jbuild_tracks(graph, B, N)
    via = from_numpy_tracks(ref)
    own = build_tracks(from_numpy_graph(graph), B, N)
    assert via.num_tracks == own.num_tracks == ref.num_tracks
    for name in ("obs_image", "obs_kp", "track_id"):
        np.testing.assert_array_equal(getattr(via, name), getattr(own, name))


def test_rank_init_pairs_matches_sfm_tpu(ring):
    _, feats, graph, cfg, _, _, _ = ring
    scene_intr = np.tile(np.asarray([600.0, 600.0, 320.0, 240.0, 0.0, 0.0], np.float32), (12, 1))
    ref = jengine.rank_init_pairs(graph, feats, scene_intr, cfg)
    got = engine.rank_init_pairs(from_numpy_graph(graph), from_numpy_feature_set(feats), scene_intr,
                                 _tcfg(cfg))
    np.testing.assert_array_equal(got, ref)
    # The parallax gate case of tests/unit/test_init_pair.py: the wide pair first.
    f2, g2, intr2 = _make_case()
    c2 = PipelineConfig(engine=EngineConfig(init_min_inliers=10))
    np.testing.assert_array_equal(
        engine.rank_init_pairs(from_numpy_graph(g2), from_numpy_feature_set(f2), intr2, _tcfg(c2)),
        jengine.rank_init_pairs(g2, f2, intr2, c2))


def test_local_ba_cameras_matches_sfm_tpu(ring):
    _, _, _, _, ref, _, _ = ring
    rec = from_numpy_reconstruction(ref)
    for window, cap in ((np.array([10, 11]), 6), (np.array([0, 5, 6]), 4), (np.arange(12), 64)):
        np.testing.assert_array_equal(engine._local_ba_cameras(rec, window, cap),
                                      jengine._local_ba_cameras(ref, window, cap))


def test_pose_search_matches_sfm_tpu():
    """The bootstrap's all-candidate pose search on test_init_pair's case:
    the same triangulation count as sfm_tpu from a wrong stored pose (edge 1)
    and on a pure rotation (edge 0). Several candidates tie on the count, and
    the E refit's rounding decides which comes first, so the pose is held to
    the ground truth (no rotation, translation along -x) instead."""
    feats, graph, _ = _make_case()
    f, c = 300.0, 128.0
    thr = (2.0 / 300.0) ** 2
    for e, rv0, tv0 in ((1, [0.3, 0.0, 0.0], [0.0, 0.0, 1.0]), (0, graph.rvec[0], [1.0, 1.0, 1.0])):
        x1 = ((feats.xy[graph.pairs[e, 0], graph.idx_i[e]] - c) / f).astype(np.float32)
        x2 = ((feats.xy[graph.pairs[e, 1], graph.idx_j[e]] - c) / f).astype(np.float32)
        rv0 = np.asarray(rv0, np.float32)
        tv0 = np.asarray(tv0, np.float32)
        rj, tj, nj = jengine._two_view_pose_search(jnp.asarray(x1), jnp.asarray(x2),
                                                   jnp.asarray(graph.inlier[e]), jnp.asarray(rv0),
                                                   jnp.asarray(tv0), 1.5, thr)
        rt, tt, nt = engine._two_view_pose_search(torch.from_numpy(x1), torch.from_numpy(x2),
                                                  torch.from_numpy(graph.inlier[e]),
                                                  torch.from_numpy(rv0), torch.from_numpy(tv0), 1.5, thr)
        assert int(nt) == int(nj)
        if e == 1:
            assert int(nt) >= 36
            for rv, tv in ((rt.numpy(), tt.numpy()), (np.asarray(rj), np.asarray(tj))):
                assert np.degrees(np.linalg.norm(rv)) < 1.5
                assert abs(tv[0] / np.linalg.norm(tv)) > 0.95
        else:
            assert int(nt) < 10
