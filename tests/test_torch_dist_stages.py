"""The stages' multi-device routes and reconstruct at D = 2, on gloo
processes on the CPU, against the single-process port.

- DP extraction (each process its 8 views of every chunk of 16, then
  all_gather; 9 views written as PGM files, so one process pads 7 empty
  canvases), from the files loaded eagerly and streamed: every Features
  array equal to the single-process stage's on the eagerly loaded files;
- the pair-sharded match + verify stage on the 15 pairs of views at most 2
  apart (blocks of 8 pairs split 4 / 4, then 4 / 3): the graph equal, field
  by field;
- the ring route as run_pipeline takes it (ring_match_pairs, then the
  prematched matches verified pair-sharded): the pairs the block matcher
  keeps at match.min_matches, and the single-process graph of those pairs;
- reconstruct at D = 2 (DP extraction, the ring matcher, pair-sharded
  verification, the camera-sharded BA in every bundle adjustment) on 8
  rendered 128^2 views against the single-process port, with
  tests/distributed/test_pipeline_sharded.py's bars: the same registered
  views, at least 0.9 of the points, mean reprojection error below
  max(1.5 e, e + 0.1). The views are render_blob_scene's at arc 0.05 with
  120 blobs and 512 keypoints (test_pipeline_sharded.py's arc 0.10 and 80
  blobs register 2 of the 8 views in the port, which leaves the engine
  nothing to do), with 16 CG steps a solve in both runs (the sharded solve
  runs its steps from Python, ~1 ms each here: 64 took the two processes
  ~40 s); both processes return the same bits. The single-process run goes
  on in this process while the two processes run.

Processes are spawned and never import JAX; each run has its own time
limit. The artifact store of a process that does not write (local rank
other than 0) is tested here too.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import (
    MatchConfig, PipelineConfig, RansacConfig, ShardConfig, SiftConfig, apply_overrides,
)
from sfm_tpu_torch.dist.launch import run_ranks
from sfm_tpu_torch.pipeline import ingest, stages
from sfm_tpu_torch.utils.synthetic import render_blob_scene

TIMEOUT = 240.0
CPU = torch.device("cpu")
RECONSTRUCT = {"sift.max_keypoints": 512, "sift.max_candidates": 1024, "sift.num_octaves": 2,
               "sift.image_max_dim": 128, "match.max_matches": 128, "match.min_matches": 8,
               "ransac.num_hypotheses": 256, "ransac.min_inliers": 10, "ransac.error_threshold_px": 2.0,
               "ba.cg_iterations": 16, "verbose": False}
GRAPH_FIELDS = ("pairs", "idx_i", "idx_j", "inlier", "num_inliers", "num_h_inliers", "rvec", "tvec", "ok",
                "pose_ok")
FEATURE_FIELDS = ("xy", "sigma", "angle", "response", "desc", "valid")


def config(D=1) -> PipelineConfig:
    return PipelineConfig(
        sift=SiftConfig(max_keypoints=128, max_candidates=512, num_octaves=2, image_max_dim=128),
        match=MatchConfig(max_matches=64, min_matches=8, block_pairs=8),
        ransac=RansacConfig(num_hypotheses=128, min_inliers=10, error_threshold_px=2.0),
        shard=ShardConfig(num_devices=D), verbose=False)


def stage_views():
    return list(render_blob_scene(image_size=(128, 128), num_images=9, arc_fraction=0.08, num_blobs=60)[0])


def reconstruct_views():
    return list(render_blob_scene(image_size=(128, 128), num_images=8, arc_fraction=0.05, num_blobs=120)[0])


def run_stages(pgm_dir, cfg, mesh=None):
    """Every stage route of the module on one process (mesh None: single,
    without the streamed extraction and the ring route)."""
    batch = ingest.load_images(pgm_dir, cfg.sift)
    feats = stages.extract_stage(batch, cfg, CPU, mesh)
    pairs = stages.exhaustive_pairs(len(batch.names))
    pairs = pairs[pairs[:, 1] - pairs[:, 0] <= 2]          # the 15 pairs of neighbours
    graph = stages.match_and_verify_stage(feats, pairs, batch.intrinsics, cfg, CPU, seed=3, mesh=mesh)
    out = dict(feats=feats, graph=graph, intrinsics=batch.intrinsics)
    if mesh is not None:
        out["streamed"] = stages.extract_stage_streaming(ingest.resolve_paths(pgm_dir), cfg, CPU, mesh)[0]
        ring = stages.ring_match_pairs(feats, cfg, CPU, mesh)
        out["ring"] = ring
        out["ring_graph"] = stages.match_and_verify_stage(feats, ring[0], batch.intrinsics, cfg, CPU, seed=3,
                                                          prematched=ring[1:], mesh=mesh)
    return out


def summary(rec) -> tuple:
    return rec.registered, rec.num_points, rec.mean_reprojection_error(), rec.rvecs, rec.tvecs, rec.points


def _worker(mesh, pgm_dir, views):
    import sfm_tpu_torch

    out = run_stages(pgm_dir, config(mesh.size), mesh)
    out["rec"] = summary(sfm_tpu_torch.reconstruct(views, device="cpu", **RECONSTRUCT,
                                                   **{"shard.num_devices": mesh.size}))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from chip_smoke import write_pgm_views

    import sfm_tpu_torch

    pgm_dir = write_pgm_views(stage_views(), str(tmp_path_factory.mktemp("pgm")))
    torch.set_num_threads(2)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _worker, 2, (pgm_dir, reconstruct_views()),
                            init_file=str(tmp_path_factory.mktemp("stages") / "init"), timeout=TIMEOUT, threads=2)
        single = run_stages(pgm_dir, config())
        single["rec"] = summary(sfm_tpu_torch.reconstruct(reconstruct_views(), device="cpu", **RECONSTRUCT))
        return single, ranks.result()


def assert_same(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize("route", ["feats", "streamed"])
def test_dp_extraction_equals_single_process(runs, route):
    single, sharded = runs
    assert single["feats"].valid.sum() > 100
    for r in sharded:
        assert_same(r[route], single["feats"], FEATURE_FIELDS)


def test_pair_sharded_verify_equals_single_process(runs):
    single, sharded = runs
    assert single["graph"].ok.sum() >= 5
    for r in sharded:
        assert_same(r["graph"], single["graph"], GRAPH_FIELDS)


def test_ring_route_equals_single_process(runs):
    from chip_smoke import block_matches

    single, sharded = runs
    cfg = config()
    feats = single["feats"]
    pairs, pi, pj, pv = sharded[0]["ring"]
    every = stages.exhaustive_pairs(len(feats.xy))
    ii, jj, ok = block_matches(feats, every, cfg, CPU)
    keep = ok.sum(-1) >= cfg.match.min_matches
    assert 10 <= keep.sum() < len(keep)
    for a, b in zip((pairs, pi, pj, pv), (every[keep], ii[keep], jj[keep], ok[keep])):
        np.testing.assert_array_equal(a, b)
    ref = stages.match_and_verify_stage(feats, pairs, single["intrinsics"], cfg, CPU, seed=3)
    for r in sharded:
        assert_same(r["ring_graph"], ref, GRAPH_FIELDS)


def test_reconstruct_two_processes_meets_sharded_bars(runs):
    single, sharded = runs
    rec1 = single["rec"]
    reg, n_points, err = sharded[0]["rec"][:3]
    np.testing.assert_array_equal(reg, rec1[0])
    assert reg.sum() == 8 and n_points >= 0.9 * rec1[1]
    assert err < max(1.5 * rec1[2], rec1[2] + 0.1), (rec1[2], err)
    for a, b in zip(sharded[1]["rec"], sharded[0]["rec"]):
        np.testing.assert_array_equal(a, b)


def test_reader_store_writes_nothing(tmp_path):
    from sfm_tpu_torch.pipeline.run import is_writer
    from sfm_tpu_torch.scene.artifacts import ArtifactStore

    reader = ArtifactStore(str(tmp_path), writable=False)
    reader.save("meta", "k", {"a": np.zeros(3)})
    assert reader.is_complete("meta", "k") is False and os.listdir(tmp_path) == []
    writer = ArtifactStore(str(tmp_path))
    writer.save("meta", "k", {"a": np.zeros(3)})
    assert reader.manifest == {"meta": "k"} and reader.is_complete("meta", "k")
    assert is_writer(None)
