"""The slice end to end: sfm_tpu_torch.reconstruct against sfm_tpu.reconstruct
on the two-view fixture of tests/integration/test_two_view.py (CPU).

Bars:
- both packages register 2 images;
- the port passes that file's bars: >= 15 points, mean reprojection
  < 1.5 px, rotation error < 2 deg, translation direction error < 8 deg;
- with its own RANSAC draws (torch.Generator), the port's relative rotation
  is within 0.5 deg of sfm_tpu's and its mean reprojection error within 10%;
- with draw_minimal_sets replaced by sfm_tpu's own draws (jax.random under
  the same per-pair keys), mean reprojection error within 1% and the point
  count within 2%: what remains is fp32 rounding, not sampling.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sfm_tpu
import sfm_tpu_torch
from sfm_tpu.config import MatchConfig, PipelineConfig, RansacConfig, SiftConfig, config_to_dict
from sfm_tpu.ops.ransac import sample_minimal_sets
from sfm_tpu.utils.synthetic import render_blob_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.geometry.projection import relative_pose
from sfm_tpu_torch.geometry.rotations import so3_exp
from sfm_tpu_torch.ops import ransac as transac

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture():
    imgs, scene = render_blob_scene(image_size=(256, 256), num_images=2, arc_fraction=0.04)
    cfg = PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        verbose=False,
    )
    ref = sfm_tpu.reconstruct(list(imgs), cfg)
    return imgs, scene, cfg, ref


def _port(imgs, cfg):
    return sfm_tpu_torch.reconstruct(list(imgs), tconfig.config_from_dict(
        tconfig.PipelineConfig, config_to_dict(cfg)), device="cpu")


def _rot_deg(ra, rb):
    R = (so3_exp(torch.as_tensor(ra)).T @ so3_exp(torch.as_tensor(rb))).numpy()
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def test_slice_own_draws(fixture):
    imgs, scene, cfg, ref = fixture
    rec = _port(imgs, cfg)
    assert ref.num_registered == 2 and rec.num_registered == 2
    assert rec.num_points >= 15
    assert (rec.points[rec.point_valid][:, 2] > 0).all()
    err = rec.mean_reprojection_error()
    assert err < 1.5

    rv_gt, t_gt = relative_pose(*(torch.from_numpy(a) for a in (scene.rvecs[0], scene.tvecs[0],
                                                                  scene.rvecs[1], scene.tvecs[1])))
    assert _rot_deg(rec.rvecs[1], rv_gt) < 2.0
    t_est = rec.tvecs[1] / np.linalg.norm(rec.tvecs[1])
    t_gtn = (t_gt / t_gt.norm()).numpy()
    assert np.degrees(np.arccos(np.clip(abs(t_est @ t_gtn), -1, 1))) < 8.0

    assert _rot_deg(rec.rvecs[1], ref.rvecs[1]) < 0.5
    assert err == pytest.approx(ref.mean_reprojection_error(), rel=0.10)
    assert rec.summary().keys() == ref.summary().keys()


def test_slice_shared_draws(fixture, monkeypatch):
    imgs, _, cfg, ref = fixture

    def jax_draws(seed, pair_index, mask, num_hypotheses, k, tag):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), pair_index)    # pipeline/stages.py
        k_e, k_h = jax.random.split(key)                                   # ops/verify.py
        idx = sample_minimal_sets(k_e if tag == "e" else k_h, jnp.asarray(mask.cpu().numpy()),
                                  num_hypotheses, k)
        return torch.from_numpy(np.array(idx)).to(mask.device)

    monkeypatch.setattr(transac, "draw_minimal_sets", jax_draws)
    rec = _port(imgs, cfg)
    assert rec.num_registered == 2
    assert rec.num_points == pytest.approx(ref.num_points, rel=0.02)
    assert rec.mean_reprojection_error() == pytest.approx(ref.mean_reprojection_error(), rel=0.01)


def test_cuda_request_without_card_raises(fixture):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    imgs = fixture[0]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sfm_tpu_torch.reconstruct(list(imgs), device="cuda")


def test_bootstrap_from_jax_stage_outputs(fixture):
    """The two-view stage alone, fed sfm_tpu's own features and match graph
    through the numpy interop: triangulation + BA land within 1% of sfm_tpu's
    mean reprojection error with the same point count."""
    from sfm_tpu.pipeline import ingest as jingest, stages as jstages
    from sfm_tpu.pipeline.two_view import bootstrap_two_view as jbootstrap
    from sfm_tpu_torch.pipeline.two_view import bootstrap_two_view
    from sfm_tpu_torch.utils.interop import from_numpy_feature_set, from_numpy_graph

    imgs, _, cfg, _ = fixture
    batch = jingest.load_images(list(imgs), cfg.sift)
    feats = jstages.extract_stage(batch, cfg)
    graph = jstages.match_and_verify_stage(feats, jstages.exhaustive_pairs(2), batch.intrinsics, cfg)
    ref = jbootstrap(feats, graph, 0, batch.intrinsics, cfg)
    tcfg = tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))
    rec = bootstrap_two_view(from_numpy_feature_set(feats), from_numpy_graph(graph), 0,
                             batch.intrinsics, tcfg, torch.device("cpu"))
    assert rec.num_points == ref.num_points
    np.testing.assert_array_equal(rec.obs_kp, ref.obs_kp)
    assert rec.mean_reprojection_error() == pytest.approx(ref.mean_reprojection_error(), rel=0.01)


def test_unported_branches_raise(fixture, tmp_path, monkeypatch):
    """Multi-device execution (shard.*), refused before dist/ was ported,
    now needs a process group of shard.num_devices processes and raises a
    ValueError without one (sfm_tpu falls back to one chip: a recorded
    divergence); artifact_dir and pair_mode="vocab_tree", refused before
    they were ported, now reach the feature stage."""
    from sfm_tpu_torch.pipeline import stages

    imgs = fixture[0]
    three = [imgs[0], imgs[1], imgs[0]]
    with pytest.raises(ValueError, match="process group"):
        sfm_tpu_torch.reconstruct(three, device="cpu", verbose=False, **{"shard.num_devices": 2})
    with pytest.raises(ValueError, match="pair_mode"):
        sfm_tpu_torch.reconstruct(three, device="cpu", pair_mode="nearest", verbose=False)

    def reached(*a, **k):
        raise KeyboardInterrupt("feature stage reached")

    monkeypatch.setattr(stages, "extract_stage", reached)
    with pytest.raises(KeyboardInterrupt, match="feature stage reached"):
        sfm_tpu_torch.reconstruct(three, device="cpu", artifact_dir=str(tmp_path), verbose=False)
    with pytest.raises(KeyboardInterrupt, match="feature stage reached"):
        sfm_tpu_torch.reconstruct(list(imgs), device="cpu", pair_mode="vocab_tree", verbose=False)


def test_reconstruction_interop_round_trip(fixture):
    from sfm_tpu_torch.utils.interop import from_numpy_reconstruction, to_numpy

    ref = fixture[3]
    rec = from_numpy_reconstruction(ref)
    assert rec.num_points == ref.num_points and rec.image_names == ref.image_names
    assert rec.mean_reprojection_error() == pytest.approx(ref.mean_reprojection_error(), rel=1e-5)
    back = to_numpy(rec)
    np.testing.assert_array_equal(back["obs_kp"], ref.obs_kp)
