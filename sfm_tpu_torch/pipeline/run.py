"""End-to-end pipeline driver (port of sfm_tpu/pipeline/run.py).

Ported: in-memory or path inputs loaded eagerly, exhaustive pairs, match +
verification, the two-image branch (two-view bootstrap + BA) and, for any
other image count, the incremental engine, the global engine
(engine_mode="global") and the divide-and-conquer pipeline
(partition.enabled, either engine inside the clusters). Every other branch
raises NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.pipeline import ingest, stages
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.logging import StageTimer

_STREAMING_MIN_IMAGES = 33  # the JAX package streams path inputs above this


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md queue 1 {item})")


def run_pipeline(images: Sequence, cfg: PipelineConfig, device: torch.device) -> Reconstruction:
    if cfg.shard.multihost or cfg.shard.num_devices > 1:
        _not_ported("multi-device execution (shard.*)", "item 6: dist/")
    if cfg.artifact_dir:
        _not_ported("artifact_dir (stage artifacts and resume)", "item 3: scene/artifacts.py")
    if cfg.pair_mode != "exhaustive":
        if cfg.pair_mode == "vocab_tree":
            _not_ported("pair_mode='vocab_tree'", "item 4: vocab tree and densify")
        raise ValueError(f"unknown pair_mode: {cfg.pair_mode}")
    paths = ingest.resolve_paths(images)
    if paths is not None and len(paths) >= _STREAMING_MIN_IMAGES:
        _not_ported("streaming feature extraction", "item 4: streaming extraction")

    timer = StageTimer(verbose=cfg.verbose, profile_dir=cfg.profile_dir, device=device)
    with timer.stage("ingest"):
        batch = ingest.load_images(images, cfg.sift)
    num_images = len(batch.canvases)
    if num_images != 2 and cfg.engine_mode not in ("incremental", "global"):
        raise ValueError(f"unknown engine_mode: {cfg.engine_mode}")

    with timer.stage("features"):
        feats = stages.extract_stage(batch, cfg, device)
    with timer.stage("pairs"):
        pairs = stages.exhaustive_pairs(num_images)
    with timer.stage("match+verify"):
        graph = stages.match_and_verify_stage(feats, pairs, batch.intrinsics, cfg, device,
                                              seed=cfg.seed)
    engine_seconds = {}
    if num_images == 2:
        with timer.stage("two_view"):
            ok_edges = np.where(graph.ok & graph.pose_ok)[0]
            if len(ok_edges) == 0:
                raise RuntimeError("two-view reconstruction failed: no verified pair")
            from sfm_tpu_torch.pipeline.two_view import bootstrap_two_view

            rec = bootstrap_two_view(feats, graph, int(ok_edges[0]), batch.intrinsics, cfg, device)
    elif cfg.engine_mode == "global" and not cfg.partition.enabled:
        with timer.stage("global_sfm"):
            from sfm_tpu_torch.pipeline.global_engine import global_reconstruct

            rec = global_reconstruct(feats, graph, batch.intrinsics, cfg, device)
            engine_seconds = rec.stage_seconds
    else:
        # Partition mode hosts both engines: each cluster reconstructs with
        # cfg.engine_mode, then the shared merge and polish phases run.
        with timer.stage("incremental" if cfg.engine_mode == "incremental" else "global_sfm"):
            if cfg.partition.enabled:
                from sfm_tpu_torch.pipeline.partition import partitioned_reconstruct

                rec = partitioned_reconstruct(feats, graph, batch.intrinsics, cfg, device)
            else:
                from sfm_tpu_torch.pipeline.engine import incremental_reconstruct

                rec = incremental_reconstruct(feats, graph, batch.intrinsics, cfg, device)
            engine_seconds = rec.stage_seconds

    rec.image_names = batch.names
    rec.image_sizes = np.asarray(batch.valid_hw)[:, ::-1].astype(np.int32)
    rec.stage_seconds = {**timer.durations, **engine_seconds}
    if cfg.verbose:
        print(f"[sfm_tpu_torch] {rec.summary()}")
    return rec
