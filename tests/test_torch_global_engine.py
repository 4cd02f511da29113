"""pipeline/global_engine.py of sfm_tpu_torch against sfm_tpu (CPU).

Both packages get the same features and verified graph, synthesized from the
ground truth of the ring24 fixture of tests/integration/test_partition.py
(24 cameras on a full orbit of radius 4, 200 points, 0.3 px keypoint noise).
Bars, the port's result against sfm_tpu's: registered count equal +-1, mean
reprojection error within 5% (two frameworks' fp32 rounding; the global
engine draws no random numbers), camera-centre RMSE after Sim(3) under 0.08
(2% of the orbit radius) for both. The port alone is also held to the bars
of tests/integration/test_global_engine.py: every image registered, < 0.6 px
at the 0.3 px noise floor, > 100 points, RMSE < 1% of the radius, and a ring
with 10% gross-outlier relative poses still recovered below 0.8 px.
"""

import numpy as np
import pytest
import torch

from sfm_tpu.config import BAConfig, PipelineConfig
from sfm_tpu.pipeline import global_engine as jglobal
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch.pipeline import global_engine
from sfm_tpu_torch.pipeline.stages import MatchGraph
from sfm_tpu_torch.utils.interop import from_numpy_feature_set, from_numpy_graph
from tests.integration.test_incremental import scene_to_features_and_graph
from tests.test_torch_engine import camera_rmse
from tests.test_torch_partition import assert_slice_matches, ring24_config, ring24_inputs, tcfg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ring24_global():
    scene, feats, graph = ring24_inputs()
    cfg = ring24_config("global")
    ref = jglobal.global_reconstruct(feats, graph, scene.intrinsics.copy(), cfg)
    rec = global_engine.global_reconstruct(from_numpy_feature_set(feats), from_numpy_graph(graph),
                                           scene.intrinsics.copy(), tcfg(cfg), "cpu")
    return scene, ref, rec


def test_global_reconstruct_matches_jax(ring24_global):
    scene, ref, rec = ring24_global
    assert_slice_matches(rec, ref, scene)
    assert rec.num_points == pytest.approx(ref.num_points, rel=0.05)


def test_global_reconstruct_meets_the_jax_tests_bars(ring24_global):
    scene, _, rec = ring24_global
    assert rec.num_registered == scene.num_cameras
    assert rec.mean_reprojection_error() < 0.6
    assert rec.num_points > 100
    assert camera_rmse(rec, scene) < 0.04


def test_global_reconstruct_reports_its_phases(ring24_global):
    _, _, rec = ring24_global
    assert {"global.pose_graph", "global.positioning", "global.polish"} <= set(rec.stage_seconds)
    assert all(v >= 0 for v in rec.stage_seconds.values())


def test_global_reconstruct_tolerates_outlier_edges():
    scene = make_orbit_scene(num_cameras=12, num_points=150, noise_px=0.0, seed=10, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, noise=0.3, seed=11)
    rng = np.random.default_rng(12)
    bad = rng.random(len(graph.pairs)) < 0.10
    rvec, tvec = np.asarray(graph.rvec).copy(), np.asarray(graph.tvec).copy()
    rvec[bad] = rng.normal(0, 1.5, (int(bad.sum()), 3)).astype(np.float32)
    tvec[bad] = rng.normal(0, 1.0, (int(bad.sum()), 3)).astype(np.float32)
    tvec[bad] /= np.linalg.norm(tvec[bad], axis=1, keepdims=True)
    g = from_numpy_graph(graph)
    g = MatchGraph(pairs=g.pairs, idx_i=g.idx_i, idx_j=g.idx_j, inlier=g.inlier,
                   num_inliers=g.num_inliers, num_h_inliers=g.num_h_inliers, rvec=rvec, tvec=tvec,
                   ok=g.ok, pose_ok=g.pose_ok)
    cfg = tcfg(PipelineConfig(ba=BAConfig(max_iterations=20), verbose=False))
    rec = global_engine.global_reconstruct(from_numpy_feature_set(feats), g, scene.intrinsics.copy(),
                                           cfg, "cpu")
    assert rec.num_registered == scene.num_cameras
    assert rec.mean_reprojection_error() < 0.8
