"""End-to-end pipeline driver (port of sfm_tpu/pipeline/run.py).

Inputs in memory, or paths loaded eagerly (streamed chunk by chunk from 33
images up); exhaustive or vocab-tree pairs (the latter densified along the
verified graph's distance ladder); match + verification; the two-image
branch (two-view bootstrap + BA) or, for any other image count, the
incremental engine, the global engine (engine_mode="global") or the
divide-and-conquer pipeline (partition.enabled, either engine inside the
clusters). With artifact_dir each stage's output is saved under a key of
its own config scope and the input, and a rerun resumes from the last
completed stage. Multi-device execution (shard.*) raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig, stage_config_hash
from sfm_tpu_torch.pipeline import ingest, stages
from sfm_tpu_torch.scene.artifacts import ArtifactStore, input_hash, path_hash
from sfm_tpu_torch.scene.state import Reconstruction
from sfm_tpu_torch.utils.logging import StageTimer

_STREAMING_MIN_IMAGES = 33  # from this many path inputs up, decode streams chunk by chunk


def _stage_keys(cfg: PipelineConfig, ikey: str) -> tuple[str, str, str]:
    """Stage-scoped artifact keys: a reconstruction-config change resumes
    from "matches", a match-config change from "features"."""
    return tuple(stage_config_hash(cfg, s) + "-" + ikey for s in ("features", "matches", "reconstruction"))


def run_pipeline(images: Sequence, cfg: PipelineConfig, device: torch.device) -> Reconstruction:
    if cfg.shard.multihost or cfg.shard.num_devices > 1:
        raise NotImplementedError(
            "multi-device execution (shard.*) is not ported yet (ROADMAP.md queue 1 item 6: dist/)")
    if cfg.pair_mode not in ("exhaustive", "vocab_tree"):
        raise ValueError(f"unknown pair_mode: {cfg.pair_mode}")

    timer = StageTimer(verbose=cfg.verbose, profile_dir=cfg.profile_dir, device=device)
    paths = ingest.resolve_paths(images)
    streaming = paths is not None and len(paths) >= _STREAMING_MIN_IMAGES

    store = ArtifactStore(cfg.artifact_dir) if cfg.artifact_dir else None
    if streaming:
        if store:
            fkey, mkey, rkey = _stage_keys(cfg, path_hash(paths))
        with timer.stage("features"):
            if store and store.is_complete("features", fkey) and store.is_complete("meta", fkey):
                feats = store.load_features()
                meta = store.load("meta")
                intrinsics, names = meta["intrinsics"], [str(n) for n in meta["names"]]
                valid_hw = meta["valid_hw"]
            else:
                feats, intrinsics, valid_hw, names = stages.extract_stage_streaming(paths, cfg, device)
                if store:
                    store.save_features(fkey, feats)
                    store.save("meta", fkey, dict(intrinsics=intrinsics, valid_hw=valid_hw,
                                                  names=np.asarray(names)))
    else:
        with timer.stage("ingest"):
            batch = ingest.load_images(images, cfg.sift)
        intrinsics, names, valid_hw = batch.intrinsics, batch.names, batch.valid_hw
        if store:
            fkey, mkey, rkey = _stage_keys(cfg, input_hash(batch.canvases, batch.names))
        with timer.stage("features"):
            if store and store.is_complete("features", fkey):
                feats = store.load_features()
            else:
                feats = stages.extract_stage(batch, cfg, device)
                if store:
                    store.save_features(fkey, feats)
        del batch
    num_images = len(names)
    if num_images != 2 and cfg.engine_mode not in ("incremental", "global"):
        raise ValueError(f"unknown engine_mode: {cfg.engine_mode}")

    with timer.stage("pairs"):
        if cfg.pair_mode == "exhaustive":
            pairs = stages.exhaustive_pairs(num_images)
        else:
            from sfm_tpu_torch.ops.vocab import vocab_tree_pairs

            pairs = vocab_tree_pairs(feats, cfg.vocab, device, seed=cfg.seed, verbose=cfg.verbose)

    with timer.stage("match+verify"):
        if store and store.is_complete("matches", mkey):
            graph = store.load_graph()
        else:
            graph = stages.match_and_verify_stage(feats, pairs, intrinsics, cfg, device, seed=cfg.seed)
            if cfg.pair_mode != "exhaustive" and cfg.match.densify_scales > 0:
                # Pruned pair modes leave a narrow band graph on sequential
                # captures; densify along the graph-distance ladder so
                # loop-scale drift has constraints to push against.
                graph = stages.densify_graph(feats, graph, intrinsics, cfg, num_images, device,
                                             seed=cfg.seed + 1)
            if store:
                store.save_graph(mkey, graph)

    engine_seconds = {}
    if store and store.is_complete("reconstruction", rkey):
        rec = store.load_reconstruction()
    elif num_images == 2:
        with timer.stage("two_view"):
            ok_edges = np.where(graph.ok & (graph.pose_ok if graph.pose_ok is not None else True))[0]
            if len(ok_edges) == 0:
                raise RuntimeError("two-view reconstruction failed: no verified pair")
            from sfm_tpu_torch.pipeline.two_view import bootstrap_two_view

            rec = bootstrap_two_view(feats, graph, int(ok_edges[0]), intrinsics, cfg, device)
    elif cfg.engine_mode == "global" and not cfg.partition.enabled:
        with timer.stage("global_sfm"):
            from sfm_tpu_torch.pipeline.global_engine import global_reconstruct

            rec = global_reconstruct(feats, graph, intrinsics, cfg, device)
            engine_seconds = rec.stage_seconds
    else:
        # Partition mode hosts both engines: each cluster reconstructs with
        # cfg.engine_mode, then the shared merge and polish phases run.
        with timer.stage("incremental" if cfg.engine_mode == "incremental" else "global_sfm"):
            if cfg.partition.enabled:
                from sfm_tpu_torch.pipeline.partition import partitioned_reconstruct

                rec = partitioned_reconstruct(feats, graph, intrinsics, cfg, device,
                                              store=store, key=rkey if store else None)
            else:
                from sfm_tpu_torch.pipeline.engine import incremental_reconstruct

                ckpt_cb = None
                if store is not None:
                    def ckpt_cb(step, snapshot, _store=store, _key=rkey):
                        _store.save_reconstruction(_key, snapshot, stage=f"scene_{step:04d}")

                rec = incremental_reconstruct(feats, graph, intrinsics, cfg, device,
                                              checkpoint_cb=ckpt_cb)
            engine_seconds = rec.stage_seconds
    if store and not store.is_complete("reconstruction", rkey):
        store.save_reconstruction(rkey, rec)

    rec.image_names = names
    rec.image_sizes = np.asarray(valid_hw)[:, ::-1].astype(np.int32)  # (w, h)
    rec.stage_seconds = {**timer.durations, **engine_seconds}
    if cfg.artifact_dir:
        timer.dump(os.path.join(cfg.artifact_dir, "stage_timings.json"))
    if cfg.verbose:
        print(f"[sfm_tpu_torch] {rec.summary()}")
    return rec
