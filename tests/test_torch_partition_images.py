"""sfm_tpu_torch.reconstruct(..., device="cpu") from raw pixels through the
global engine and through the divide-and-conquer pipeline (either engine in
the clusters), on tests/integration/test_incremental_images.py's 6-image
fixture split into two clusters of 5 (3 core images + 2 of overlap).

Bars, that file's: >= 5 of 6 registered, mean reprojection < 1.2 px, camera
RMSE after Sim(3) alignment < 0.15, >= 40 points; and each mode's phases on
Reconstruction.stage_seconds. The three runs share one feature extraction
(the same images and SIFT config: the stage's result is remembered).
"""

import types

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import (
    BAConfig, EngineConfig, MatchConfig, PartitionConfig, PipelineConfig, RansacConfig, SiftConfig,
)
from sfm_tpu_torch.pipeline import stages
from sfm_tpu_torch.utils.synthetic import render_blob_scene
from tests.test_torch_engine import camera_rmse

torch.set_num_threads(2)

MODES = {
    "global": dict(engine_mode="global", partition=False,
                   phases={"global_sfm", "global.pose_graph", "global.polish"}),
    "partition": dict(engine_mode="incremental", partition=True,
                      phases={"incremental", "partition.clusters", "partition.merge", "partition.polish"}),
    "partition-global": dict(engine_mode="global", partition=True,
                             phases={"global_sfm", "partition.clusters", "partition.merge",
                                     "partition.polish"}),
}


@pytest.fixture(scope="module")
def scene_images():
    imgs, scene = render_blob_scene(image_size=(256, 256), num_images=6, num_blobs=140,
                                    arc_fraction=0.10, seed=5)
    return list(imgs), scene


@pytest.fixture(scope="module")
def shared_features():
    """stages.extract_stage, computed once for the module's runs."""
    inner, memo = stages.extract_stage, []

    def once(batch, cfg, device, mesh=None):
        if not memo:
            memo.append(inner(batch, cfg, device, mesh))
        return memo[0]

    stages.extract_stage = once
    yield
    stages.extract_stage = inner


@pytest.mark.parametrize("mode", list(MODES))
def test_reconstruct_from_images(scene_images, shared_features, mode):
    import sfm_tpu_torch

    imgs, scene = scene_images
    m = MODES[mode]
    cfg = PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        engine=EngineConfig(init_min_inliers=20, abs_pose_min_inliers=8, local_ba_window=4,
                            global_ba_every=3),
        ba=BAConfig(max_iterations=15),
        partition=PartitionConfig(enabled=m["partition"], target_cluster_size=3, overlap_cameras=2),
        engine_mode=m["engine_mode"], verbose=False,
    )
    rec = sfm_tpu_torch.reconstruct(imgs, cfg, device="cpu")
    assert rec.num_registered >= 5
    assert rec.mean_reprojection_error() < 1.2
    assert rec.num_points >= 40
    assert m["phases"] <= set(rec.stage_seconds)
    reg = np.where(rec.registered)[0]
    assert camera_rmse(types.SimpleNamespace(rvecs=rec.rvecs[reg], tvecs=rec.tvecs[reg]),
                       types.SimpleNamespace(rvecs=scene.rvecs[reg], tvecs=scene.tvecs[reg],
                                             num_cameras=len(reg))) < 0.15
