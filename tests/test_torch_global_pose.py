"""pipeline/global_pose.py of sfm_tpu_torch against sfm_tpu's (CPU).

The numpy solvers (rotation and translation averaging, edge-scale centres,
global positioning, observation rays, repositioning) are compared through
tests/test_torch_merge.py's harness: equal index sets and masks, floats to
1e-5 of the array's max. The functions that reach the device (two-view
refinement inside pose_graph_poses, re-triangulation inside
straighten_reconstruction and retriangulate_reconstruction) run fp32
Gauss-Newton and DLT in two frameworks: poses and points to 1e-3 of max,
masks equal.
"""

import numpy as np
import pytest
import torch

from sfm_tpu.pipeline import global_pose as jgp
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch.pipeline import global_pose as gp
from tests.integration.test_incremental import scene_to_features_and_graph
from tests.test_torch_merge import assert_same, run_both
from tests.unit.test_ba import scene_to_reconstruction
from tests.unit.test_global_pose import _graph_from_scene, _positioning_problem

torch.set_num_threads(2)


def both(name, build, tol=1e-5, **tkw):
    return run_both(name, build, jmod=jgp, tmod=gp, tol=tol, **tkw)


@pytest.mark.parametrize("kw", [dict(), dict(noise_deg=0.5, outlier_frac=0.10, seed=5)],
                         ids=["exact", "outliers"])
def test_rotation_averaging_matches_jax(kw):
    scene = make_orbit_scene(num_cameras=40, num_points=10, seed=3)
    g = _graph_from_scene(scene, **kw)
    R, valid, _ = both("rotation_averaging",
                       lambda: ((g.pairs, g.rvec, 40), dict(weights=g.num_inliers.astype(float))))
    assert valid.sum() == 40


def _directions(scene, g):
    R = jgp._so3_exp_np(scene.rvecs)
    c = -np.einsum("nji,nj->ni", R, scene.tvecs.astype(np.float64))
    d = c[g.pairs[:, 1]] - c[g.pairs[:, 0]]
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def test_translation_averaging_matches_jax():
    scene = make_orbit_scene(num_cameras=40, num_points=10, seed=6)
    g = _graph_from_scene(scene)
    d = _directions(scene, g) + np.random.default_rng(1).normal(0, 0.01, (len(g.pairs), 3))
    valid = np.ones(42, bool)
    valid[40:] = False                                   # two cameras without edges
    c, solved = both("translation_averaging", lambda: ((g.pairs, d, 42, valid), {}))
    assert solved.sum() == 40 and not solved[40:].any()


@pytest.mark.parametrize("gross", [0.0, 0.08])
def test_global_positioning_matches_jax(gross):
    oc, op, v, c_gt, c0, N, P = _positioning_problem(N=32, P=80, gross_frac=gross)
    c, X, sc, sp = both("global_positioning",
                        lambda: ((oc, op, v, N, P, np.ones(N, bool)), dict(centers0=c0.copy())))
    assert sc.all()


@pytest.fixture(scope="module")
def ring():
    scene = make_orbit_scene(num_cameras=12, num_points=150, noise_px=0.0, seed=10, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, noise=0.3, seed=11)
    return scene, feats, graph


def test_edge_scale_centers_matches_jax(ring):
    scene, feats, graph = ring
    use = graph.ok
    pairs = graph.pairs[use]
    R = jgp._so3_exp_np(scene.rvecs)
    d = -np.einsum("eji,ekj,ek->ei", R[pairs[:, 0]], jgp._so3_exp_np(graph.rvec[use]), graph.tvec[use])
    intr = scene.intrinsics.astype(np.float64)
    xn = (feats.xy - intr[:, None, 2:4]) / intr[:, None, 0:2]
    args = (pairs, d, graph.rvec[use], graph.tvec[use], graph.idx_i[use], graph.idx_j[use],
            graph.inlier[use], xn, 12, np.ones(12, bool))
    centers, solved = both("edge_scale_centers",
                           lambda: (args, dict(weights=graph.num_inliers[use].astype(np.float64))))
    assert solved.all()


def test_observation_rays_and_reposition_match_jax():
    scene = make_orbit_scene(num_cameras=16, num_points=120, seed=9)

    def build():
        rec = scene_to_reconstruction(scene, pose_noise=0.02, point_noise=0.05, seed=2)
        rec.intrinsics[:, 4] = 0.02
        return (rec,), {}

    rays = both("observation_rays", build)
    np.testing.assert_allclose(np.linalg.norm(rays, axis=1), 1.0, atol=1e-9)
    assert both("reposition_reconstruction", build) in (True, False)


def test_pose_graph_poses_matches_jax(ring):
    """The whole front end on real keypoint correspondences: two-view
    refinement on the device, rotation averaging, edge-scale centres."""
    scene, feats, graph = ring
    ref = jgp.pose_graph_poses(graph, 12, feats=feats, intrinsics=scene.intrinsics)
    got = gp.pose_graph_poses(graph, 12, feats=feats, intrinsics=scene.intrinsics, device="cpu")
    assert_same(ref, got, "pose_graph_poses", tol=1e-3)
    assert got[2].all()
    # Without features: RANSAC poses as they are, direction-only translation averaging.
    assert_same(jgp.pose_graph_poses(graph, 12), gp.pose_graph_poses(graph, 12, device="cpu"),
                "pose_graph_poses (no features)", tol=1e-5)


def _bent(scene):
    rec = scene_to_reconstruction(scene)
    N = scene.num_cameras
    Rgt = jgp._so3_exp_np(scene.rvecs)
    c_gt = -np.einsum("nji,nj->ni", Rgt, scene.tvecs.astype(np.float64))
    for i in range(N):
        phase = 2 * np.pi * i / N
        bend = jgp._so3_exp_np(np.asarray([[0.0, 0.25 * np.sin(phase), 0.0]]))[0]
        R_b = Rgt[i] @ bend.T
        c_b = bend @ c_gt[i] + 0.3 * np.sin(phase) * np.asarray([1.0, 0, 0])
        rec.rvecs[i] = jgp._so3_log_np(R_b[None])[0].astype(np.float32)
        rec.tvecs[i] = (-R_b @ c_b).astype(np.float32)
    return rec


def test_straighten_reconstruction_matches_jax():
    """tests/unit/test_global_pose.py's bent ring: both packages straighten
    it to the same poses and re-triangulate the same points."""
    scene = make_orbit_scene(num_cameras=48, num_points=120, seed=9)
    g = _graph_from_scene(scene)
    assert both("straighten_reconstruction", lambda: ((_bent(scene), g), {}), tol=1e-3, device="cpu")


@pytest.mark.parametrize("kw", [dict(), dict(max_error_px=16.0, min_angle_deg=0.5),
                                dict(only_points=np.arange(20, 60))], ids=["all", "loose", "subset"])
def test_retriangulate_reconstruction_matches_jax(kw):
    scene = make_orbit_scene(num_cameras=20, num_points=120, seed=12)

    def build():
        return (scene_to_reconstruction(scene, pose_noise=0.002, point_noise=0.2, seed=5),), dict(kw)

    n = both("retriangulate_reconstruction", build, tol=1e-3, device="cpu")
    assert n > 30
