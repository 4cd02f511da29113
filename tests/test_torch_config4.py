"""BASELINE config #4 (benchmarks/ladder.py's settings, chip_smoke.py phase
14) on the CPU, at small sizes:

- (i) the divide-and-conquer pipeline with the global engine and
  partition.parallel_clusters=2 against 1, through reconstruct() on
  tests/test_torch_partition_images.py's 6-image fixture, with the
  feature stage's output replaced by the scene's projections (extracting
  1,024 keypoints from six views takes ~20 s on two CPU threads and is
  not what the threads change): the same clusters and bit-identical
  cameras, points and registered mask;
- (ii) the ladder's settings scaled to 16 views (the ladder's scene at
  n = 16, clusters of 6 + 3, vocab pairs, parallel_clusters=2) through the
  port and through sfm_tpu, both fed one feature set and one verified
  graph: the keypoints are the rendered scene's projections (0.3 px noise)
  with a descriptor per scene point, because the feature stage on 16
  views of 1,024 keypoints takes about a minute on two CPU threads; the
  port's vocab tree, match, verify and densify make the graph. Both
  register >= 15 of 16 at < 1.2 px, and the port's camera RMSE and mean
  reprojection error are each within 1.5x of sfm_tpu's (on this input the
  two agree to 1e-5 of each other);
- the repairs the clusters on threads needed: the kernel library and the
  native library are built once when several threads ask at once, the
  launch counts add up across threads, and chip_smoke.forbid_plain covers
  K1's and K2's plain versions;
- chip_smoke.py's views rendered ahead in a background pool (which keeps
  the script with phase 14 inside its time limit) are the bits render_pool
  renders itself.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import chip_smoke as cs
from sfm_tpu_torch.config import PipelineConfig, apply_overrides, config_to_dict
from sfm_tpu_torch.pipeline import partition, stages
from tests.test_torch_engine import camera_rmse

torch.set_num_threads(2)

LADDER_N = 16
LADDER_CLUSTERS = {"partition.target_cluster_size": 6, "partition.overlap_cameras": 3,
                   "partition.parallel_clusters": 2, "verbose": False}


# ---- (i) clusters on threads give the bits of clusters in turn ----------------


@pytest.fixture(scope="module")
def six_views():
    """tests/test_torch_partition_images.py's scene_images."""
    from sfm_tpu_torch.utils.synthetic import render_blob_scene

    imgs, scene = render_blob_scene(image_size=(256, 256), num_images=6, num_blobs=140,
                                    arc_fraction=0.10, seed=5)
    return list(imgs), scene


def six_view_config(workers: int):
    from sfm_tpu_torch.config import (
        BAConfig, EngineConfig, MatchConfig, PartitionConfig, RansacConfig, SiftConfig,
    )

    return PipelineConfig(
        sift=SiftConfig(max_keypoints=512, max_candidates=2048, num_octaves=3, image_max_dim=256),
        match=MatchConfig(max_matches=256, min_matches=8),
        ransac=RansacConfig(num_hypotheses=512, min_inliers=10, error_threshold_px=2.0),
        engine=EngineConfig(init_min_inliers=20, abs_pose_min_inliers=8, local_ba_window=4,
                            global_ba_every=3),
        ba=BAConfig(max_iterations=15),
        partition=PartitionConfig(enabled=True, target_cluster_size=3, overlap_cameras=2,
                                  parallel_clusters=workers),
        engine_mode="global", verbose=False,
    )


def test_parallel_clusters_bit_identical(six_views, monkeypatch):
    import sfm_tpu_torch
    from sfm_tpu_torch.pipeline import global_engine

    imgs, scene = six_views
    memo = {}

    def once(name):
        inner = getattr(stages, name)

        def fn(*a, **k):
            if name not in memo:
                memo[name] = inner(*a, **k)
            return memo[name]
        return fn

    def projected(batch, cfg, *a, **k):
        return projected_features(scene, cfg.sift.max_keypoints, np.random.default_rng(4))

    seen, inner_part = [], partition.partition_images

    def part(*a, **k):
        out = inner_part(*a, **k)
        seen.append([c.tolist() for c in out])
        return out

    threads, inner_global = set(), global_engine.global_reconstruct

    def cluster(*a, **k):
        threads.add(threading.current_thread().name)
        return inner_global(*a, **k)

    # Both runs share one feature set and one match stage.
    monkeypatch.setattr(stages, "extract_stage", projected)
    monkeypatch.setattr(stages, "match_and_verify_stage", once("match_and_verify_stage"))
    monkeypatch.setattr(partition, "partition_images", part)
    monkeypatch.setattr(global_engine, "global_reconstruct", cluster)
    serial = sfm_tpu_torch.reconstruct(imgs, six_view_config(1), device="cpu")
    serial_threads, threads = threads, set()
    threaded = sfm_tpu_torch.reconstruct(imgs, six_view_config(2), device="cpu")
    assert len(seen) == 2 and seen[0] == seen[1] and len(seen[0]) >= 2
    assert serial_threads == {threading.main_thread().name} and len(threads) == 2
    assert serial.num_registered >= 5
    for f in ("registered", "rvecs", "tvecs", "points", "point_valid", "obs_point", "obs_image"):
        np.testing.assert_array_equal(getattr(threaded, f), getattr(serial, f), err_msg=f)


# ---- (ii) the ladder at 16 views against sfm_tpu ------------------------------


def projected_features(scene, N: int, rng):
    """A FeatureSet of N slots per view: the keypoints as the scene's
    projections with 0.3 px noise and one unit descriptor per scene point
    (0.05 noise per view)."""
    B, M = scene.num_cameras, scene.num_points
    point_desc = rng.standard_normal((M, 128)).astype(np.float32)
    xy = np.zeros((B, N, 2), np.float32)
    desc = np.zeros((B, N, 128), np.float32)
    valid = np.zeros((B, N), bool)
    for i in range(B):
        vis = np.where(scene.visible[i])[0][:N]
        k = len(vis)
        xy[i, :k] = scene.pixels[i, vis] + rng.normal(0, 0.3, (k, 2))
        d = point_desc[vis] + 0.05 * rng.standard_normal((k, 128)).astype(np.float32)
        desc[i, :k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
        valid[i, :k] = True
    return stages.FeatureSet(xy=xy, sigma=np.full((B, N), 1.6, np.float32),
                             angle=np.zeros((B, N), np.float32), response=np.ones((B, N), np.float32),
                             desc=desc, valid=valid)


def ladder_inputs():
    """The ladder's scene at LADDER_N views (its render's geometry), its
    projected_features, and the port's vocab pairs, match, verify and
    densify on them with the ladder's config: (scene, FeatureSet,
    MatchGraph, config)."""
    from sfm_tpu_torch.ops.vocab import vocab_tree_pairs
    from sfm_tpu_torch.utils.synthetic import blob_scene_views

    _, scene = blob_scene_views(**cs.config4_scene(LADDER_N))
    cfg = apply_overrides(PipelineConfig(), {**cs.config4_overrides(LADDER_N), **LADDER_CLUSTERS})
    B = scene.num_cameras
    feats = projected_features(scene, cfg.sift.max_keypoints, np.random.default_rng(3))
    intrinsics = scene.intrinsics.copy()
    pairs = vocab_tree_pairs(feats, cfg.vocab, "cpu", seed=cfg.seed)
    graph = stages.match_and_verify_stage(feats, pairs, intrinsics, cfg, "cpu", seed=cfg.seed)
    graph = stages.densify_graph(feats, graph, intrinsics, cfg, B, "cpu", seed=cfg.seed + 1)
    return scene, feats, graph, cfg


def test_ladder_16_views_against_sfm_tpu():
    from sfm_tpu.config import PipelineConfig as JConfig
    from sfm_tpu.config import config_from_dict
    from sfm_tpu.pipeline import partition as jpartition
    from sfm_tpu.pipeline.stages import FeatureSet as JFeatureSet
    from sfm_tpu.pipeline.stages import MatchGraph as JMatchGraph
    from sfm_tpu_torch.utils.interop import to_numpy

    scene, feats, graph, cfg = ladder_inputs()
    assert graph.ok.sum() >= LADDER_N
    # sfm_tpu on a thread of its own while the port runs: the two share no
    # state, and their host work overlaps.
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(jpartition.partitioned_reconstruct, JFeatureSet(**to_numpy(feats)),
                          JMatchGraph(**to_numpy(graph)), scene.intrinsics.copy(),
                          config_from_dict(JConfig, config_to_dict(cfg)))
        rec = partition.partitioned_reconstruct(feats, graph, scene.intrinsics.copy(), cfg, "cpu")
        ref = ref.result()
    radius = cs.CONFIG4_RADIUS
    for what, r in (("sfm_tpu", ref), ("port", rec)):
        assert r.num_registered >= LADDER_N - 1, what
        assert r.mean_reprojection_error() < 1.2, what
    got = camera_rmse_of(rec, scene)
    want = camera_rmse_of(ref, scene)
    assert got <= 1.5 * want, (got, want, radius)
    assert rec.mean_reprojection_error() <= 1.5 * ref.mean_reprojection_error()


def camera_rmse_of(rec, scene) -> float:
    import types

    reg = np.where(rec.registered)[0]
    return camera_rmse(types.SimpleNamespace(rvecs=rec.rvecs[reg], tvecs=rec.tvecs[reg]),
                       types.SimpleNamespace(rvecs=scene.rvecs[reg], tvecs=scene.tvecs[reg],
                                             num_cameras=len(reg)))


# ---- the repairs: builds and counts across threads ---------------------------


@pytest.mark.parametrize("module", ["kernels", "native"])
def test_library_built_once_across_threads(module, monkeypatch):
    """Four threads ask for the library at once: one builds, the others
    wait and get the same object."""
    import importlib

    mod = importlib.import_module(f"sfm_tpu_torch.{module}")
    getter = mod.library if module == "kernels" else mod.get_lib
    builds, lib = [], object()

    def build():
        builds.append(threading.current_thread().name)
        time.sleep(0.2)
        monkeypatch.setattr(mod, "_lib", lib)
        return lib

    monkeypatch.setattr(mod, "_lib", None)
    monkeypatch.setattr(mod, "_build_and_load", build)
    got = []
    workers = [threading.Thread(target=lambda: got.append(getter())) for _ in range(4)]
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    assert len(builds) == 1 and len(got) == 4 and all(g is lib for g in got)


def test_launch_counts_add_up_across_threads():
    from sfm_tpu_torch import kernels

    saved = dict(kernels.LAUNCHES)
    try:
        kernels.reset_launches()
        calls = 20000

        def count():
            for _ in range(calls):
                kernels.count_launch("pcg_solve")

        workers = [threading.Thread(target=count) for _ in range(4)]
        for t in workers:
            t.start()
        for t in workers:
            t.join()
        assert kernels.LAUNCHES["pcg_solve"] == 4 * calls
    finally:
        kernels.LAUNCHES.update(saved)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that answers is_cuda = True, as a tensor on the card
    would: what forbid_plain looks at."""

    @property
    def is_cuda(self):
        return True


def test_forbid_plain_covers_every_kernel_module():
    """Inside forbid_plain K1's, K2's and the BA kernels' plain versions
    record a call with a CUDA tensor (and none with CPU tensors) and still
    return the plain result; after it they are the functions again."""
    from sfm_tpu_torch.kernels import ba_kernels, dog_extrema, match_topk

    def plains():
        return (dog_extrema.dog_extrema_scores_plain, match_topk.match_topk2_plain,
                ba_kernels.fused_cost_sums_plain)

    before = plains()
    gauss = torch.rand(1, 4, 16, 16)
    da, db = torch.rand(1, 8, 128), torch.rand(1, 9, 128)
    vb = torch.ones(1, 9, dtype=torch.bool)
    with cs.forbid_plain() as calls:
        assert all(f is not b for f, b in zip(plains(), before))
        assert torch.equal(dog_extrema.dog_extrema_scores(gauss, 0.01), before[0](gauss, 0.01))
        assert all(torch.equal(a, b) for a, b in zip(match_topk.match_topk2(da, db, vb), before[1](da, db, vb)))
        assert calls == []
        dog_extrema.dog_extrema_scores_plain(gauss.as_subclass(_CudaLooking), 0.01)
        match_topk.match_topk2_plain(da.as_subclass(_CudaLooking), db, vb)
        assert calls == ["dog_extrema_scores_plain", "match_topk2_plain"]
    assert plains() == before


def test_ba_sources_parse_with_double_rows():
    """The BA sources parse with g++ against the CUDA shim
    (tools/cuda_syntax_check.py), with K3's rows and K5's
    back-substitution in double, the repair of the 1,000-camera polish's
    fp32 misses. The kernels' accuracy itself has no CPU route: chip_smoke
    phase 14 (c) holds K3 and K5 against float64 on the polish's problem."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, str(repo / "tools" / "cuda_syntax_check.py")],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_prefetched_renders_are_render_pools_bits(monkeypatch):
    """chip_smoke.prefetch_renders renders scenes in a background pool and
    render_pool takes them from there: the same views and ground truth as
    render_blob_scene in one process; a scene not asked for renders in
    render_pool's own pool as before, and nothing stays prefetched after
    the pool stops."""
    import os

    from sfm_tpu_torch.utils.synthetic import render_blob_scene

    monkeypatch.setattr(os, "cpu_count", lambda: 1)   # render_pool's own pool: one worker
    scene = dict(image_size=(64, 48), num_images=3, num_blobs=24, focal=80.0, arc_fraction=0.1,
                 radius=4.0, seed=3)
    other = dict(scene, num_images=2)
    want, truth = render_blob_scene(**scene)
    with cs.prefetch_renders([scene]):
        assert len(cs._PREFETCHED) == 1
        got, got_truth = cs.render_pool(**scene)
        assert not cs._PREFETCHED
        alone, _ = cs.render_pool(**other)
    assert not cs._PREFETCHED
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got_truth.rvecs, truth.rvecs) and np.array_equal(got_truth.points, truth.points)
    assert np.array_equal(alone, render_blob_scene(**other)[0])
