"""sfm_tpu_torch.reconstruct(..., device="cpu") end to end on
tests/integration/test_incremental_images.py's 6-image fixture (raw pixels
through SIFT, matching, verification and the incremental engine), held to
that file's bars: >= 5 of 6 registered, mean reprojection < 1.2 px, camera
RMSE after Sim(3) alignment < 0.15, >= 40 points, > 90% of them inside the
scene volume.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sfm_tpu.config import (
    BAConfig, EngineConfig, MatchConfig, PipelineConfig, RansacConfig, SiftConfig, config_to_dict,
)
from sfm_tpu.geometry.projection import camera_center
from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.geometry.similarity import umeyama_np

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def images_result():
    """tests/integration/test_incremental_images.py's fixture, through the port."""
    import sfm_tpu_torch

    imgs, scene = render_blob_scene(image_size=(256, 256), num_images=6, num_blobs=140,
                                    arc_fraction=0.10, seed=5)
    cfg = PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        engine=EngineConfig(init_min_inliers=20, abs_pose_min_inliers=8, local_ba_window=4,
                            global_ba_every=3),
        ba=BAConfig(max_iterations=15),
        verbose=False,
    )
    tcfg = tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))
    return sfm_tpu_torch.reconstruct(list(imgs), tcfg, device="cpu"), scene


def test_images_register_and_reproject(images_result):
    rec, _ = images_result
    assert rec.num_registered >= 5
    assert rec.mean_reprojection_error() < 1.2
    assert "incremental" in rec.stage_seconds and "engine.global_ba" in rec.stage_seconds


def test_images_geometry_vs_ground_truth(images_result):
    rec, scene = images_result
    reg = np.where(rec.registered)[0]
    est = np.stack([np.asarray(camera_center(jnp.asarray(rec.rvecs[i]), jnp.asarray(rec.tvecs[i])))
                    for i in reg])
    gt = np.stack([np.asarray(camera_center(jnp.asarray(scene.rvecs[i]), jnp.asarray(scene.tvecs[i])))
                   for i in reg])
    s, R, t = umeyama_np(est, gt)
    assert np.sqrt((((s * est @ R.T + t) - gt) ** 2).sum(-1).mean()) < 0.15
    assert rec.num_points >= 40
    pts = s * rec.points[rec.point_valid] @ R.T + t
    assert (np.abs(pts) < 2.5).all(axis=1).mean() > 0.9


def test_render_blob_scene_equals_sfm_tpu():
    """The port's copy of the renderer gives sfm_tpu's bits, and its views
    rendered one by one (as a process pool renders them) give the same."""
    from sfm_tpu_torch.utils import synthetic

    kw = dict(image_size=(96, 80), num_images=3, num_blobs=40, focal=90.0, seed=2,
              arc_fraction=0.2, radius=5.0)
    ref, ref_scene = render_blob_scene(**kw)
    got, scene = synthetic.render_blob_scene(**kw)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(scene.points, ref_scene.points)
    views, _ = synthetic.blob_scene_views(**kw)
    np.testing.assert_array_equal(np.stack(list(map(synthetic.render_blob_view, views))), ref)
