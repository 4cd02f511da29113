"""End-to-end pipeline driver (port of sfm_tpu/pipeline/run.py).

Inputs in memory, or paths loaded eagerly (streamed chunk by chunk from 33
images up); exhaustive or vocab-tree pairs (the latter densified along the
verified graph's distance ladder); match + verification; the two-image
branch (two-view bootstrap + BA) or, for any other image count, the
incremental engine, the global engine (engine_mode="global") or the
divide-and-conquer pipeline (partition.enabled, either engine inside the
clusters). With artifact_dir each stage's output is saved under a key of
its own config scope and the input, and a rerun resumes from the last
completed stage.

Several devices (shard.num_devices > 1): one process per device, every
process running this function with the same inputs in a torch.distributed
group of shard.num_devices processes (shard.multihost joins it here, from
the shard.* coordinator fields or a launcher's env:// variables; without a
group of that size this raises a ValueError, where sfm_tpu falls back to
one chip). The stages share their device work over the group (DP feature
extraction, the ring matcher with shard.ring_matching on exhaustive pairs,
pair-sharded verification, the camera-sharded BA with shard.shard_ba) and
every process returns the same reconstruction (clusters one at a time:
partition.parallel_clusters > 1 raises). The process of local rank
0 on each host writes the artifacts and stage_timings.json (sfm_tpu's
processes each write theirs; on one host that would race).
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


def is_writer(mesh) -> bool:
    """Whether this process writes the run's files: the only process, or
    the process of local rank 0 of a multi-device run."""
    return mesh is None or mesh.local_rank == 0


def run_pipeline(images: Sequence, cfg: PipelineConfig, device: torch.device) -> Reconstruction:
    from sfm_tpu_torch.dist.mesh import initialize_multihost, mesh_for

    if cfg.shard.multihost:
        initialize_multihost(cfg.shard, device)
    mesh = mesh_for(cfg.shard, device)
    if mesh is not None and cfg.partition.enabled and cfg.partition.parallel_clusters > 1:
        # Clusters on threads would issue their BAs' collectives in an order
        # that differs from process to process.
        raise ValueError("partition.parallel_clusters > 1 cannot run with shard.num_devices > 1: "
                         "every process must issue its collectives in the same order")
    if cfg.pair_mode not in ("exhaustive", "vocab_tree"):
        raise ValueError(f"unknown pair_mode: {cfg.pair_mode}")

    timer = StageTimer(verbose=cfg.verbose, profile_dir=cfg.profile_dir, device=device)
    paths = ingest.resolve_paths(images)
    streaming = paths is not None and len(paths) >= _STREAMING_MIN_IMAGES

    store = ArtifactStore(cfg.artifact_dir, writable=is_writer(mesh)) if cfg.artifact_dir else None
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
                feats, intrinsics, valid_hw, names = stages.extract_stage_streaming(paths, cfg, device,
                                                                                    mesh)
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
                feats = stages.extract_stage(batch, cfg, device, mesh)
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
            prematched = None
            if mesh is not None and cfg.shard.ring_matching and cfg.pair_mode == "exhaustive":
                # The all-pairs sweep as the ring matcher over the group;
                # verification consumes its matches.
                pairs, pi, pj, pv = stages.ring_match_pairs(feats, cfg, device, mesh)
                prematched = (pi, pj, pv) if pi is not None else None
            graph = stages.match_and_verify_stage(feats, pairs, intrinsics, cfg, device, seed=cfg.seed,
                                                  prematched=prematched, mesh=mesh)
            if cfg.pair_mode != "exhaustive" and cfg.match.densify_scales > 0:
                # Pruned pair modes leave a narrow band graph on sequential
                # captures; densify along the graph-distance ladder so
                # loop-scale drift has constraints to push against.
                graph = stages.densify_graph(feats, graph, intrinsics, cfg, num_images, device,
                                             seed=cfg.seed + 1, mesh=mesh)
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
    if cfg.artifact_dir and is_writer(mesh):
        timer.dump(os.path.join(cfg.artifact_dir, "stage_timings.json"))
    if cfg.verbose:
        print(f"[sfm_tpu_torch] {rec.summary()}")
    return rec
