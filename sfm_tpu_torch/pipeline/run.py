"""End-to-end pipeline driver (port of sfm_tpu/pipeline/run.py).

Ported: in-memory or path inputs loaded eagerly, exhaustive pairs, match +
verification, and the two-image branch (two-view bootstrap + BA). Every
other branch raises NotImplementedError naming its ROADMAP.md item.
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
    if num_images != 2:
        if cfg.engine_mode == "global":
            _not_ported("engine_mode='global'", "item 5: partition, merge and the global engine")
        if cfg.engine_mode != "incremental":
            raise ValueError(f"unknown engine_mode: {cfg.engine_mode}")
        _not_ported(f"reconstruction of {num_images} images (incremental engine)",
                    "items 1-2: tracks, native/ and PnP, then PCG and the incremental engine")

    with timer.stage("features"):
        feats = stages.extract_stage(batch, cfg, device)
    with timer.stage("pairs"):
        pairs = stages.exhaustive_pairs(num_images)
    with timer.stage("match+verify"):
        graph = stages.match_and_verify_stage(feats, pairs, batch.intrinsics, cfg, device,
                                              seed=cfg.seed)
    with timer.stage("two_view"):
        ok_edges = np.where(graph.ok & graph.pose_ok)[0]
        if len(ok_edges) == 0:
            raise RuntimeError("two-view reconstruction failed: no verified pair")
        from sfm_tpu_torch.pipeline.two_view import bootstrap_two_view

        rec = bootstrap_two_view(feats, graph, int(ok_edges[0]), batch.intrinsics, cfg, device)

    rec.image_names = batch.names
    rec.image_sizes = np.asarray(batch.valid_hw)[:, ::-1].astype(np.int32)
    rec.stage_seconds = dict(timer.durations)
    if cfg.verbose:
        print(f"[sfm_tpu_torch] {rec.summary()}")
    return rec
