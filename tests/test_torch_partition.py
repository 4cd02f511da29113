"""pipeline/partition.py of sfm_tpu_torch against sfm_tpu's (CPU), on the
ring24 fixture of tests/integration/test_partition.py (24 cameras on a full
orbit, 200 points, features and verified graph synthesized from the ground
truth) with that file's config.

Bars:
- partition_images and _mask_graph_to_cluster (host numpy): equal index sets;
- partitioned_reconstruct, incremental engine in the clusters, both packages
  fed the same features and graph: registered count equal +-1, mean
  reprojection error within 5% of sfm_tpu's (fp32 rounding and the
  frameworks' RANSAC draws differ), camera-centre RMSE after Sim(3) under the
  JAX test's bar, 0.08 (2% of the orbit radius);
- the PnP rescue re-registers cameras taken out of the merged model, as
  sfm_tpu's does, within 1e-2 of the poses they had;
- the windowed polish (forced by lowering the camera ceiling in both
  packages) leaves the model within 5% of sfm_tpu's mean reprojection error.
"""

import copy
import pathlib
import re

import numpy as np
import pytest
import torch

from sfm_tpu.config import (
    BAConfig, EngineConfig, PartitionConfig, PipelineConfig, RansacConfig, config_to_dict,
)
from sfm_tpu.pipeline import partition as jpartition
from sfm_tpu.utils.synthetic import make_orbit_scene
from sfm_tpu_torch import config as tconfig
from sfm_tpu_torch.pipeline import partition
from sfm_tpu_torch.scene.state import ReconstructionError
from sfm_tpu_torch.utils.interop import (
    from_numpy_feature_set, from_numpy_graph, from_numpy_reconstruction,
)
from tests.integration.test_incremental import scene_to_features_and_graph
from tests.test_torch_engine import camera_rmse

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parent.parent


def tcfg(cfg):
    return tconfig.config_from_dict(tconfig.PipelineConfig, config_to_dict(cfg))


def ring24_inputs():
    scene = make_orbit_scene(num_cameras=24, num_points=200, noise_px=0.0, seed=20, arc_fraction=1.0)
    feats, graph = scene_to_features_and_graph(scene, max_kp=220, noise=0.3, seed=21)
    return scene, feats, graph


def ring24_config(engine_mode="incremental"):
    return PipelineConfig(
        engine=EngineConfig(local_ba_window=5, global_ba_every=6),
        ransac=RansacConfig(num_hypotheses=512),
        ba=BAConfig(max_iterations=20),
        partition=PartitionConfig(enabled=True, target_cluster_size=10, overlap_cameras=4),
        engine_mode=engine_mode, verbose=False,
    )


def assert_slice_matches(rec, ref, scene):
    """The slice's bars: the port's result against sfm_tpu's."""
    assert abs(rec.num_registered - ref.num_registered) <= 1
    assert rec.num_registered >= 22
    assert rec.mean_reprojection_error() == pytest.approx(ref.mean_reprojection_error(), rel=0.05)
    reg = rec.registered & ref.registered
    assert camera_rmse_registered(rec, scene, reg) < 0.08
    assert camera_rmse_registered(ref, scene, reg) < 0.08


def camera_rmse_registered(rec, scene, reg):
    if reg.all():
        return camera_rmse(rec, scene)
    import types
    ids = np.where(reg)[0]
    sub = types.SimpleNamespace(rvecs=rec.rvecs[ids], tvecs=rec.tvecs[ids])
    sub_scene = types.SimpleNamespace(rvecs=scene.rvecs[ids], tvecs=scene.tvecs[ids], num_cameras=len(ids))
    return camera_rmse(sub, sub_scene)


@pytest.fixture(scope="module")
def ring24():
    scene, feats, graph = ring24_inputs()
    cfg = ring24_config()
    ref = jpartition.partitioned_reconstruct(feats, graph, scene.intrinsics.copy(), cfg)
    rec = partition.partitioned_reconstruct(from_numpy_feature_set(feats), from_numpy_graph(graph),
                                            scene.intrinsics.copy(), tcfg(cfg), "cpu")
    return scene, feats, graph, cfg, ref, rec


@pytest.mark.parametrize("target,overlap", [(10, 4), (8, 0), (250, 10)])
def test_partition_images_matches_jax(target, overlap):
    _, _, graph = ring24_inputs()
    ref = jpartition.partition_images(graph, 24, target, overlap)
    got = partition.partition_images(from_numpy_graph(graph), 24, target, overlap)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(got))) == 24


def test_mask_graph_to_cluster_matches_jax():
    _, _, graph = ring24_inputs()
    cluster = np.array([0, 1, 2, 3, 7, 9])
    ref = jpartition._mask_graph_to_cluster(graph, cluster)
    got = partition._mask_graph_to_cluster(from_numpy_graph(graph), cluster)
    np.testing.assert_array_equal(got.ok, ref.ok)
    assert 0 < got.ok.sum() < graph.ok.sum()
    assert got.idx_i is ref.idx_i or np.array_equal(got.idx_i, ref.idx_i)


def test_partitioned_reconstruct_matches_jax(ring24):
    scene, _, _, _, ref, rec = ring24
    assert_slice_matches(rec, ref, scene)
    assert rec.num_points == pytest.approx(ref.num_points, rel=0.05)
    assert {"partition.clusters", "partition.merge", "partition.rescue", "partition.polish"} <= set(rec.stage_seconds)


def test_rescue_unregistered_matches_jax(ring24):
    scene, feats, graph, cfg, ref, rec = ring24
    gone = [5, 17]

    def without(model):
        m = copy.deepcopy(model)
        keep = ~np.isin(m.obs_image, gone)
        for f in ("obs_point", "obs_image", "obs_kp", "obs_uv"):
            setattr(m, f, getattr(m, f)[keep])
        m.registered[gone] = False
        m.rvecs[gone] = 0.0
        m.tvecs[gone] = 0.0
        return m

    jm, tm = without(ref), without(rec)
    n_j = jpartition._rescue_unregistered(jm, feats, graph, scene.intrinsics, cfg)
    n_t = partition._rescue_unregistered(tm, from_numpy_feature_set(feats), from_numpy_graph(graph),
                                         scene.intrinsics, tcfg(cfg), torch.device("cpu"))
    assert n_t == n_j == 2
    assert tm.registered[gone].all()
    np.testing.assert_allclose(tm.rvecs[gone], rec.rvecs[gone], atol=1e-2)
    np.testing.assert_allclose(tm.tvecs[gone], rec.tvecs[gone], atol=1e-2)
    assert (np.isin(tm.obs_image, gone).sum() >= 2 * cfg.engine.abs_pose_min_inliers)
    assert partition._rescue_unregistered(tm, from_numpy_feature_set(feats), from_numpy_graph(graph),
                                          scene.intrinsics, tcfg(cfg), torch.device("cpu")) == 0


def test_windowed_polish_matches_jax(ring24, monkeypatch):
    """Past the camera ceiling the polish sweeps 50%-overlapping camera
    windows; lowered to 8 cameras (windows of 16) it runs on the ring."""
    scene, _, _, cfg, ref, rec = ring24
    for mod in (jpartition, partition):
        monkeypatch.setattr(mod, "_POLISH_MAX_CAMERAS", 8)
        monkeypatch.setattr(mod, "_WINDOW_CAMERAS", 16)
    rng = np.random.default_rng(3)
    noise = rng.normal(0, 0.01, rec.points.shape).astype(np.float32)
    jm, tm = copy.deepcopy(ref), copy.deepcopy(rec)
    jm.points = jm.points + noise[:len(jm.points)]
    tm.points = tm.points + noise[:len(tm.points)]
    before = tm.mean_reprojection_error()
    assert jpartition._merged_polish(jm, cfg) is None
    assert partition._merged_polish(tm, tcfg(cfg), "cpu") is None
    assert tm.mean_reprojection_error() < 0.5 * before
    assert tm.mean_reprojection_error() == pytest.approx(jm.mean_reprojection_error(), rel=0.05)
    assert camera_rmse(tm, scene) < 0.08


def test_checkpoint_arguments_are_refused(ring24, tmp_path, monkeypatch):
    """The checkpoint arguments, refused before scene/artifacts.py was
    ported, now resume: with a complete 'merged_prepolish' slot (here the
    ring's merged model) no cluster is partitioned or reconstructed, and the
    saved model goes straight to the polish."""
    from sfm_tpu_torch.scene.artifacts import ArtifactStore

    scene, feats, graph, cfg, _, rec = ring24
    store = ArtifactStore(str(tmp_path))
    store.save_reconstruction("k", rec, stage="merged_prepolish")

    def refuse(*a, **k):
        raise AssertionError("clusters re-ran despite a complete merged_prepolish slot")

    polished = []
    monkeypatch.setattr(partition, "partition_images", refuse)
    monkeypatch.setattr(partition, "_polish_phase", lambda merged, *a: polished.append(merged))
    out = partition.partitioned_reconstruct(from_numpy_feature_set(feats), from_numpy_graph(graph),
                                            scene.intrinsics, tcfg(cfg), "cpu", store=store, key="k")
    assert polished == [out]
    for f in ("rvecs", "tvecs", "registered", "points", "point_valid", "obs_point", "obs_uv"):
        np.testing.assert_array_equal(getattr(out, f), getattr(rec, f))


def test_cluster_failures(monkeypatch):
    """A cluster that cannot reconstruct (the engine's own error) is skipped;
    any other error, a CUDA or build error among them, is not swallowed."""
    from sfm_tpu_torch.pipeline import engine

    scene, feats, graph = ring24_inputs()
    args = (from_numpy_feature_set(feats), from_numpy_graph(graph), scene.intrinsics.copy(),
            tcfg(ring24_config()), "cpu")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(engine, "incremental_reconstruct", broken)
    with pytest.raises(RuntimeError, match="CUDA error"):
        partition.partitioned_reconstruct(*args)

    def hopeless(*a, **k):
        raise ReconstructionError("no valid initial pair")

    monkeypatch.setattr(engine, "incremental_reconstruct", hopeless)
    with pytest.raises(ReconstructionError, match="no cluster produced"):
        partition.partitioned_reconstruct(*args)


def test_port_imports_neither_jax_nor_sfm_tpu():
    pat = re.compile(r"^\s*(import jax|from jax|import sfm_tpu\b|from sfm_tpu\b)", re.M)
    files = [*REPO.glob("sfm_tpu_torch/**/*.py"), REPO / "chip_smoke.py", REPO / "tools" / "torch_perf.py"]
    assert len(files) > 40
    hits = [str(f.relative_to(REPO)) for f in files if pat.search(f.read_text())]
    assert hits == []


def test_reconstruct_on_cuda_raises_without_a_card():
    """The entry point runs on the card unless the caller asks for the CPU;
    without a card it raises, whatever the engine, and never moves to the CPU."""
    import sfm_tpu_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    imgs = [np.zeros((32, 32), np.float32)] * 3
    for kw in ({}, {"engine_mode": "global"}, {"partition.enabled": True}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sfm_tpu_torch.reconstruct(imgs, **kw)
