#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port (sfm_tpu_torch) on one GPU.

    python3 tools/torch_perf.py scene N:BLOBS:ARC[:FOCAL[:RADIUS]] [...]
        reconstruct rendered rings of N 1024^2 views of the blob scene
        (chip_smoke.py's incremental slice) and report observations,
        accuracy, the bundle adjustments' sizes and solvers, and the stages;
    python3 tools/torch_perf.py slice [--runs 2] [--root DIR]
        chip_smoke.py's incremental slice several times in one process
        (cold, then warm): stage and engine-phase seconds; then the last
        run's final global BA once more under torch.profiler: device busy
        time, idle share, device launches per LM iteration, kernel time by
        name, seconds per PCG solve; the normal-equation build's and the LM
        candidate's device launches and device time per call (as in lm);
        and that BA's seconds per LM iteration with the dense and with the
        PCG reduced solve; --save-problem PATH writes that BA's problem and
        config (.npz) for lm;
    python3 tools/torch_perf.py lm PATH [--root DIR]
        on a problem saved by slice: the normal-equation build and the LM
        candidate with its cost, one LM iteration's inputs, under
        torch.profiler (device launches, device ms per call) and CUDA
        events, and one bundle_adjust's device launches per LM iteration;
        --root DIR takes sfm_tpu_torch from another tree (an unpacked parent
        commit), so that parent and change are measured on one problem;
    python3 tools/torch_perf.py crossover
        dense Cholesky vs PCG reduced solve on the same problems, seconds
        per LM iteration across padded (C, O);
    python3 tools/torch_perf.py polish [--iterations 5] [--root DIR]
        chip_smoke.py's merged-model polish at full width (10,240 cameras,
        about 1.5 M observations): the seconds of its steps (build_problem,
        each solve, the filter), then the first solve's first LM iterations
        once more under torch.profiler: device busy time, idle share, device
        launches per LM iteration, kernel time by name, seconds per PCG solve
        (--root DIR as for lm, here and for slice);
    python3 tools/torch_perf.py partition [--variants default no_straighten] [--dump DIR]
        chip_smoke.py's divide-and-conquer slice with one feature and match
        stage shared by the variants: each cluster's accuracy, then mean
        reprojection error and camera-centre RMSE before and after every
        phase of the polish (straightening, each merged polish, the track
        splits and merges), and the phases' seconds; a variant switches one
        PartitionConfig field off. --dump DIR writes the first straightening's
        inputs and result into DIR for tools/straighten_parity.py;
    python3 tools/torch_perf.py global N [...]
        engine_mode="global" on the first N views of that ring: accuracy
        and stage seconds;
    python3 tools/torch_perf.py kernels [--pairs 32] [--keypoints 4096]
        the kernels alone, held against their plain versions and timed
        beside them and their library yardsticks, each row with its device
        time per call from torch.profiler (chip_smoke.py's checks, without
        the reconstructions): K1 on a 1024^2 octave; K2 on one pair and on a
        block of pairs; K3, K5, K7 (standalone and inside K3), K9 and K11 on
        an orbit problem (C = 128, tracks of ~100 views: not the final
        global BA's shapes); K4, K6, K8, K10 and K9 on the merged model
        (C = 10,240), K9's camera side K = 6, 36 and 42, point side K = 3
        and 9;
    python3 tools/torch_perf.py pcg [--cameras 100] [--points 500] [--blocks N] [--root DIR]
        pcg_solve alone on an orbit problem (chip_smoke.check_pcg, resident
        and streaming, and on N blocks), then its device time per solve and
        that of the loop over K11 it replaced; --root DIR as for lm;
    python3 tools/torch_perf.py phases
        pcg_solve's device time by phase of a CG step: a copy of
        csrc/schur_kernels.cu with %globaltimer marks around its four phases
        and grid barriers (thread 0 of every block adds up each phase),
        built beside the package's library, on the C = 128 orbit, the
        1,024-camera wide orbit and the merged model (C = 10,240, streaming):
        microseconds per step, mean and max over the blocks;
    python3 tools/torch_perf.py features [--images 100] [--root DIR]
        the feature stage alone on chip_smoke.py's incremental ring
        (stages.extract_stage, cold then warm: seconds), recording every
        stack it hands K1; K1 at each of those shapes on the stacks it was
        handed (bit-exact, event and device time, bound); then, on the first
        chunk of 8 views, extract_features with use_pallas True and False
        (identical), K12 on that chunk's four octaves
        (chip_smoke.check_descriptors: one launch a call, the gap to its
        plain version, event and device time, bound) and where the chunk's
        device time goes (chip_smoke.feature_breakdown: device ms and
        launches by part, idle share): the first thing to run after
        touching csrc/dog_extrema.cu or csrc/sift_descriptors.cu (--root
        DIR as for lm);
    python3 tools/torch_perf.py dogsweep
        K1's design choices: copies of csrc/dog_extrema.cu with a ring of
        3, 4 or 6 stages and the tiles (16, 64), (16, 32), (32, 64), (8, 64)
        and (8, 32) (those within 48 KB of shared memory), built beside the
        package's library, each held bit-exact against the plain version and
        its device time taken (chip_smoke.device_ms) at every octave of a
        chunk of 8 and of a last chunk of 4 noise images on 1024^2 canvases,
        and at [1, 6, 1024, 1024];
    python3 tools/torch_perf.py profiler [--calls 10] [--sessions 3]
        does torch.profiler record every launch? K3 with the Schur-Jacobi
        blocks, K5, pcg_solve on the orbit problem and K6 on the merged
        model, `calls` calls a session: one-step sessions whose calls start
        at once or after a 20 ms idle lead-in, and one session of
        chip_smoke.traced (a discarded first step of the same calls; it
        merges two such sessions): the wrapper's own launches
        per call (kernels.LAUNCHES) beside the launches and device ms per
        call the profiler recorded.
    python3 tools/torch_perf.py ptxas
        each kernel source compiled as the package builds it, with
        -Xptxas -v: registers, spill stores and loads, shared memory and
        stack of every kernel, by name (the 6-wide and 8-wide builds of K3,
        K4, K5, K6, K7, K8, K10, K11 and pcg_solve apart);
    python3 tools/torch_perf.py refined [--source ring|orbit] [--offsets 0.04 ...]
        chip_smoke.py's phase 11 without the other phases: the 8-wide
        builds held and timed (check_refined_kernels) on the final global
        BA's problem of the incremental ring (--source ring, phase 5 run
        first) or on the C = 128 orbit (--source orbit), then the refined
        BA (run_refined_ba) on the ring's problem (with ring) and on the
        orbit without outliers; then the 46-view ring reconstructed
        with the focal prior off by each offset (run_refined_reconstruct,
        its bars reported, not enforced; --baseline: each offset also
        without refinement).
    python3 tools/torch_perf.py dist [--polish]
        the multi-device routes without the reconstructions: first which
        collectives gloo runs on CUDA tensors (two processes on the one
        card: all_reduce, all_gather, the ring's send/recv); then, in a
        one-process NCCL group (chip_smoke.join_group), K3's sharded mode and
        both halves of K11 held and timed (chip_smoke.check_sharded_kernels)
        and the sharded BA against the single-card one
        (chip_smoke.check_sharded_ba) on the C = 128 orbit at 6 and 8 wide,
        and the sharded LM's steps (chip_smoke.sharded_lm_report); with
        --polish also on the merged model (C = 10,240) for 3 iterations;
        with --phase12 (no probe, no orbit) chip_smoke.py's phase 12 alone
        on its inputs, made as phases 5, 8 and 11 make them (the ring's
        reconstruction, the merged polish, the 46 views).
    python3 tools/torch_perf.py refinedpolish [--sharded]
        chip_smoke.py's phase 13 without the other phases: phase 8's merged
        model (10,240 cameras) from a focal 4% off through the refined
        global BA (run_refined_polish; its bars reported, not enforced),
        then the 8-wide K4, K6, K8, K10 and K9 held and timed on its
        problem (check_big) and pcg_solve_big 8 wide (check_pcg); with
        --sharded also the sharded LM on that problem for 3 iterations in a
        one-process NCCL group (check_sharded_ba);
    python3 tools/torch_perf.py ringfeatures [--offsets 0 0.04] [--out DIR]
        chip_smoke.py phase 11's 46-view ring rendered at (1 + offset) x
        the focal prior, through the feature stage and the exhaustive
        match + verify stage with the default config; writes what the
        incremental engine reads (keypoints, validity, the verified graph,
        the prior intrinsics) and the ground truth to
        DIR/ring46_<offset>.npz (default DIR chiprun_out) for
        tools/refine_parity.py --features, which runs both packages'
        engines on them on the CPU.
    python3 tools/torch_perf.py config4 [N] [global|incremental] [--kernels]
        BASELINE config #4 from files at N views (default 1,000):
        chip_smoke.py phase 14's run (run_config4: benchmarks/ladder.py's
        scene and settings at N, the clusters of `mode`'s engine on four
        threads, through cli.main) with its readings (registered, px,
        camera RMSE, stage seconds, pairs, clusters, rescues, the BAs)
        and phase 14's bars (reported, not enforced); --kernels also holds
        and times the path's kernels at the run's shapes (config4_kernels)
        and the idle shares (config4_idle); the pipeline prints its own
        progress lines.

Every line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def scene_cmd(device, specs):
    for spec in specs:
        n, blobs, arc, *rest = spec.split(":")
        focal = float(rest[0]) if rest else cs.INC_FOCAL
        radius = float(rest[1]) if len(rest) > 1 else cs.INC_RADIUS
        rec, launches, ba_log, wall, scene = cs.run_incremental(
            device, int(n), int(blobs), float(arc), focal, radius)
        s = rec.summary()
        out = dict(spec=spec, wall_s=wall, registered=s["num_registered"], images=int(n),
                   points=s["num_points"], observations=s["num_observations"],
                   mean_reproj_px=s["mean_reproj_error_px"],
                   median_reproj_px=s["median_reproj_error_px"],
                   camera_rmse_over_radius=cs.camera_rmse(rec, scene) / radius,
                   final_ba={k: v for k, v in ba_log[-1].items() if k not in ("problem", "cfg")}
                   if ba_log else None,
                   pcg_bas=sum(b["solver"] == "pcg" for b in ba_log), bas=len(ba_log),
                   stages=rec.stage_seconds, launches=launches)
        print(f"[scene] {card()} {json.dumps(out)}", flush=True)


def slice_cmd(device, runs: int, save_problem: str | None):
    from sfm_tpu_torch import reconstruct
    from sfm_tpu_torch.ba.core import uses_dense_solver

    images = cs.INC_IMAGES
    imgs, scene = cs.render_ring(images, cs.INC_BLOBS, cs.INC_ARC)
    rec = None
    for r in range(runs):
        with cs.record_bundle_adjustments() as ba_log:
            t0 = time.perf_counter()
            rec = reconstruct(list(imgs), device=device, verbose=False)
            wall = time.perf_counter() - t0
        s = rec.summary()
        print(f"[slice] {card()} run {r} ({'cold' if r == 0 else 'warm'}): wall {wall:.3f}s "
              f"registered {s['num_registered']}/{images} points {s['num_points']} "
              f"obs {s['num_observations']} reproj {s['mean_reproj_error_px']:.4f}px "
              f"rmse {cs.camera_rmse(rec, scene):.5f} stages "
              + json.dumps({k: round(v, 4) for k, v in rec.stage_seconds.items()}), flush=True)

    # The final global BA of the last run, as the engine handed it over, traced.
    prob, cfg = ba_log[-1]["problem"], ba_log[-1]["cfg"]
    if save_problem:
        _save_problem(save_problem, prob, cfg)
    solver = "dense" if uses_dense_solver(prob, cfg) else "pcg"
    _profile_solve(prob, cfg, f"global BA {solver}")
    _lm_steps(prob, cfg, device, "final global BA")
    row = {s: per_iteration(prob, s) for s in ("dense", "pcg")}
    print(f"[crossover] {card()} final global BA C={prob.num_cameras} O={prob.obs_w.shape[0]} "
          f"gate={solver} " + json.dumps(row), flush=True)


def _save_problem(path: str, prob, cfg):
    """A BA problem and its BAConfig as .npz (utils/interop field names)."""
    import dataclasses

    import numpy as np

    from sfm_tpu_torch.utils.interop import to_numpy

    arrays = {k: v for k, v in to_numpy(prob).items() if v is not None}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, cfg_json=json.dumps(dataclasses.asdict(cfg)), **arrays)


def _load_problem(path: str, device):
    import numpy as np

    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.utils.interop import from_numpy_problem

    data = dict(np.load(path))
    cfg = BAConfig(**json.loads(str(data.pop("cfg_json"))))
    return from_numpy_problem(data, device), cfg


def _lm_steps(prob, cfg, device, what: str):
    """chip_smoke.lm_report on this problem, printed on one line with the
    card and the package it ran (lm --root: an older tree)."""
    from sfm_tpu_torch.ba import core

    rows = cs.lm_report(prob, cfg, device)
    print(f"[lm] {card()} {what} C={prob.num_cameras} O={prob.obs_w.shape[0]} package "
          f"{os.path.dirname(os.path.dirname(os.path.abspath(core.__file__)))}: " + json.dumps(rows),
          flush=True)


def lm_cmd(device, path: str):
    prob, cfg = _load_problem(path, device)
    _lm_steps(prob, cfg, device, os.path.basename(path))


def _profile_solve(prob, cfg, what: str):
    """One bundle_adjust(prob, cfg) under torch.profiler after a warm-up
    run (chip_smoke.traced): wall, device busy time, idle share, device launches per LM
    iteration, the top kernels; then one more run with every PCG solve
    (core._pcg) synchronised on both sides: seconds per PCG solve."""
    import torch

    from sfm_tpu_torch.ba import bundle_adjust, core

    rows, wall_ms, (_, stats) = cs.traced(lambda: bundle_adjust(prob, cfg))   # after a warm run
    busy_ms, top = cs.device_time_ms(rows)
    print(f"[profile] {card()} {what} C={prob.num_cameras} O={prob.obs_w.shape[0]} "
          f"{stats.iterations} LM iterations: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}, device launches per LM iteration "
          f"{cs.device_launches(rows) / max(stats.iterations, 1):.1f}", flush=True)
    for name, count, ms in top:
        print(f"[profile]   {ms:9.3f} ms  {count:6d}x  {name}", flush=True)
    its = max(stats.iterations, 1)
    by_count = sorted(rows, key=lambda r: -r[1])
    print(f"[profile] {card()} {what}: device rows by launches per LM iteration: " + json.dumps(
        [(name[:50], round(n / its, 2)) for name, n, _ in by_count[:30]]), flush=True)
    inner, solves = core._pcg, []

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        solves.append(time.perf_counter() - t0)
        return out

    core._pcg = timed
    try:
        bundle_adjust(prob, cfg)
    finally:
        core._pcg = inner
    if solves:
        print(f"[profile] {card()} {what}: {len(solves)} PCG solves, seconds per solve median "
              f"{statistics.median(solves):.6f} min {min(solves):.6f} max {max(solves):.6f}", flush=True)


def pcg_cmd(device, cameras: int, points: int, blocks: int | None):
    """The fused PCG solve alone on chip_smoke.py's orbit problem (resident
    and streaming, and on a grid of `blocks` blocks when given), held
    against its plain version in float64 and timed beside the loop of
    Python steps over the coupling-only K11 and its bound
    (chip_smoke.check_pcg); then 10 fused solves and 10 loops under
    torch.profiler: device time per solve."""
    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.kernels import ba_kernels as kb

    prob = cs.schur_problem(device, cameras, points)
    cfg = BAConfig()
    for kw in [{}, {"streaming": True}] + ([{"blocks": blocks}] if blocks else []):
        row = cs.check_pcg(prob, cfg, device, "orbit", **kw)
        print(f"[pcg] {card()} " + json.dumps(row), flush=True)
    inv, ne = cs.first_iteration_inputs(prob, cfg)
    M_inv, d = core.pcg_preconditioner(ne, prob, inv)
    rhs = core._schur_rhs(ne, prob, inv).contiguous()
    plan = inv.pcg_plan
    args = (ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
            inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d, rhs, cfg.cg_iterations, cfg.cg_tolerance)
    print(f"[pcg] {card()} plan: grid {plan.grid}, largest slice {plan.max_slice} observations, "
          f"{plan.smem_bytes} B staged per block", flush=True)
    _profile_calls("pcg_solve (fused)", lambda: kb.pcg_solve(*args, plan=plan))
    _profile_calls("PCG loop over K11", lambda: kb.pcg_loop(
        lambda v: cs.schur_matvec_step(ne, prob, v, inv), M_inv, d, rhs, cfg.cg_iterations,
        cfg.cg_tolerance))


def polish_cmd(device, iterations: int):
    """The merged-model polish of chip_smoke.py, step by step as
    pipeline/partition._merged_polish runs it, then a profile of the first
    solve's first `iterations` LM iterations."""
    import dataclasses

    import torch

    from sfm_tpu_torch.ba import build_problem, bundle_adjust, writeback
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.scene.state import filter_observations

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    cfg = PipelineConfig()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, max_iterations=cfg.partition.polish_ba_iterations))
    rec, truth = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                            centre_noise=cs.POLISH_CENTRE_NOISE)
    steps = {}
    _, steps["sanitation_filter"] = timed(
        lambda: filter_observations(rec, max(32.0, 4.0 * cfg.engine.max_reprojection_error_px)))
    first = None
    for round_ in range(2):
        (prob, cams, pids), steps[f"build_problem_{round_}"] = timed(
            lambda: build_problem(rec, tight=True, device=device))
        first = first or prob
        (out, stats), steps[f"solve_{round_}"] = timed(lambda: bundle_adjust(prob, cfg.ba))
        steps[f"solve_{round_}_lm_iterations"] = stats.iterations
        _, steps[f"writeback_{round_}"] = timed(lambda: writeback(rec, out, cams, pids))
        dropped, steps[f"filter_{round_}"] = timed(
            lambda: filter_observations(rec, cfg.engine.max_reprojection_error_px))
        steps[f"filter_{round_}_dropped"] = dropped
        if dropped == 0:
            break
    print(f"[polish] {card()} C={first.num_cameras} P={first.num_points} O={first.obs_w.shape[0]} "
          f"steps (s) {json.dumps(steps)}; after: {rec.mean_reprojection_error():.4f} px, camera RMSE "
          f"{cs.camera_rmse(rec, truth) / truth.radius:.6f} of the radius", flush=True)
    _profile_solve(first, dataclasses.replace(cfg.ba, max_iterations=iterations, function_tolerance=0.0),
                   "merged polish, first solve")


PARTITION_VARIANTS = {
    "default": {},
    "no_straighten": {"partition.straighten_pose_graph": False},
    "no_refine": {"partition.refine_rounds": 0},
}
_REC_FIELDS = ("intrinsics", "rvecs", "tvecs", "registered", "points", "point_errors", "point_valid",
               "obs_point", "obs_image", "obs_kp", "obs_uv")
_GRAPH_FIELDS = ("pairs", "idx_i", "idx_j", "inlier", "num_inliers", "num_h_inliers", "rvec", "tvec", "ok")


def partition_cmd(device, variants, dump: str | None):
    import numpy as np

    from sfm_tpu_torch.config import PipelineConfig, apply_overrides
    from sfm_tpu_torch.pipeline import global_pose, ingest, merge, partition, stages

    ring, scene = cs.render_ring(cs.INC_IMAGES, cs.INC_BLOBS, cs.INC_ARC)
    cfg = apply_overrides(PipelineConfig(verbose=False), {
        "partition.enabled": True, "partition.target_cluster_size": cs.PART_CLUSTER,
        "partition.overlap_cameras": cs.PART_OVERLAP})
    batch = ingest.load_images(list(ring), cfg.sift)
    feats = stages.extract_stage(batch, cfg, device)
    graph = stages.match_and_verify_stage(feats, stages.exhaustive_pairs(len(ring)), batch.intrinsics,
                                          cfg, device)

    def state(rec) -> str:
        return (f"rmse {100 * cs.camera_rmse(rec, scene) / cs.INC_RADIUS:.4f}% of the radius, "
                f"{rec.mean_reprojection_error():.4f} px, {rec.num_registered} registered, "
                f"{rec.num_points} points, {rec.num_observations} observations")

    def traced(mod, name):
        inner = getattr(mod, name)

        def wrapper(rec, *a, **k):
            before = state(rec)
            t0 = time.perf_counter()
            out = inner(rec, *a, **k)
            print(f"[partition]   {name} {time.perf_counter() - t0:.2f}s: {before} -> {state(rec)}",
                  flush=True)
            return out
        setattr(mod, name, wrapper)
        return inner

    def traced_merge(recs, c):
        for i, r in enumerate(recs):
            print(f"[partition]   cluster {i}: {state(r)}", flush=True)
        return inner_merge(recs, c)

    def dumping(rec, g, **k):
        os.makedirs(dump, exist_ok=True)
        np.savez_compressed(
            os.path.join(dump, "straighten_inputs.npz"), xy=feats.xy, gt_rvecs=scene.rvecs,
            gt_tvecs=scene.tvecs, radius=cs.INC_RADIUS,
            **{"rec_" + f: getattr(rec, f) for f in _REC_FIELDS},
            **{"g_" + f: getattr(g, f) for f in _GRAPH_FIELDS},
            g_pose_ok=g.pose_ok if g.pose_ok is not None else np.ones(len(g.ok), bool))
        out = inner_straighten(rec, g, **k)
        np.savez_compressed(os.path.join(dump, "straighten_out.npz"), rvecs=rec.rvecs,
                            tvecs=rec.tvecs, points=rec.points, point_valid=rec.point_valid)
        return out

    inner_merge, merge.merge_reconstructions = merge.merge_reconstructions, traced_merge
    inner_straighten = global_pose.straighten_reconstruction
    if dump:
        global_pose.straighten_reconstruction = dumping
    saved = [(partition, "_merged_polish"), (global_pose, "straighten_reconstruction"),
             (merge, "split_tracks_by_consensus"), (merge, "merge_tracks_by_track_id"),
             (merge, "merge_tracks_by_correspondence"), (merge, "merge_tracks_by_proximity")]
    saved = [(mod, name, traced(mod, name)) for mod, name in saved]
    try:
        for v in variants:
            print(f"[partition] {card()} variant {v}: {PARTITION_VARIANTS[v]}", flush=True)
            t0 = time.perf_counter()
            rec = partition.partitioned_reconstruct(feats, graph, batch.intrinsics,
                                                    apply_overrides(cfg, PARTITION_VARIANTS[v]), device)
            print(f"[partition] {card()} variant {v} done in {time.perf_counter() - t0:.2f}s: {state(rec)}; "
                  f"phases (s) {json.dumps({k: round(x, 3) for k, x in rec.stage_seconds.items()})}",
                  flush=True)
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
        merge.merge_reconstructions = inner_merge
        global_pose.straighten_reconstruction = inner_straighten


def global_cmd(device, sizes):
    """engine_mode="global" on the first N views of chip_smoke.py's ring."""
    ring, scene = cs.render_ring(cs.INC_IMAGES, cs.INC_BLOBS, cs.INC_ARC)
    for n in sizes:
        rec, launches, ba_log, _, wall = cs.run_reconstruct(device, ring[:n], engine_mode="global")
        s = rec.summary()
        print(f"[global] {card()} {n} views: wall {wall:.2f}s, {s['num_registered']} registered, "
              f"{s['num_points']} points, {s['mean_reproj_error_px']:.4f} px, camera RMSE "
              f"{100 * cs.camera_rmse(rec, scene) / cs.INC_RADIUS:.4f}% of the radius; stages (s) "
              + json.dumps({k: round(x, 3) for k, x in rec.stage_seconds.items()}), flush=True)


def _profile_calls(what: str, fn, calls: int = 10):
    """Device time per call and by kernel name of `calls` calls of fn()
    after a warm-up (chip_smoke.traced, per_call)."""
    fn()
    rows, wall_ms, _ = cs.traced(fn, calls)
    launches, ms, top = cs.per_call(rows, calls)
    print(f"[profile] {card()} {what}, {calls} calls: wall {wall_ms:.3f} ms, per call: {launches:g} "
          f"launches, device {ms:.4f} ms", flush=True)
    for name, n, row_ms in top[:6]:
        print(f"[profile]   {row_ms:9.4f} ms  {n:5.2f}x  {name}", flush=True)


# Where phases_cmd marks pcg_solve_kernel: (text in the loop, mark before, mark after).
_PHASE_MARKS = (
    ("        coupling_point(gobs, io, a.hinv, has ? pt : -1, lo, hi, sub, a.lanes);\n    }\n    grid.sync();\n",
     "A", "sync1"),
    ("      __syncthreads();\n    }\n    acc_a = 0.0f;\n    acc_b = 0.0f;\n", "B teams", None),
    ("      a.part[G + b] = acc_b;\n    }\n    grid.sync();\n", "B Ap", "sync2"),
    ("    if (threadIdx.x == 0) a.part[2 * G + b] = acc_a;\n    grid.sync();\n", "C", "sync3"),
    ("    rz = rz_new;\n    grid.sync();\n", "D", "sync4"),
)


def _phase_source(src: str) -> tuple[str, list]:
    """schur_kernels.cu with the phase marks of phases_cmd, and the phases' names."""
    names = []
    for anchor, before, after in _PHASE_MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"phases: pcg_solve_kernel changed, no single place for {before}")
        sync = anchor.rfind("    grid.sync();\n")
        names.append(before)
        if after is None:
            marked = anchor.replace("    acc_a = 0.0f;", f"    MARK({len(names) - 1});\n    acc_a = 0.0f;", 1)
        else:
            names.append(after)
            marked = (anchor[:sync] + f"    MARK({len(names) - 2});\n    grid.sync();\n    MARK({len(names) - 1});\n")
        src = src.replace(anchor, marked)
    loop = "  for (int it = 0; it < a.iterations; ++it) {\n"
    src = src.replace(loop, "  unsigned long long t_last = 0;\n  if (threadIdx.x == 0) asm volatile(\"mov.u64 %0, "
                      "%%globaltimer;\" : \"=l\"(t_last));\n" + loop, 1)
    marks = (f"__device__ unsigned long long g_phase[4096][{len(names)}];\n"
             "#define MARK(i) do { if (threadIdx.x == 0) { unsigned long long t_; asm volatile(\"mov.u64 %0, "
             "%%globaltimer;\" : \"=l\"(t_)); g_phase[blockIdx.x][i] += t_ - t_last; t_last = t_; } } while (0)\n")
    src = src.replace('#include "segment_sum.cuh"\n', '#include "segment_sum.cuh"\n' + marks, 1)
    src += ("extern \"C\" int sfm_phase_read(unsigned long long* out) {\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));\n}\n"
            "extern \"C\" int sfm_phase_reset() {\n  void* p;\n  cudaGetSymbolAddress(&p, g_phase);\n"
            "  return (int)cudaMemset(p, 0, sizeof(g_phase));\n}\n")
    return src, names


def phases_cmd(device):
    """pcg_solve's device time by phase (see the module docstring): the
    marked copy's sfm_pcg_solve stands in for the library's while the
    wrapper runs, on first-iteration inputs made by the library."""
    import ctypes
    import tempfile

    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.ba import build_problem, core
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.kernels import ba_kernels as kb

    src, names = _phase_source((kernels.CSRC / "schur_kernels.cu").read_text())
    real = kernels.library()
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "phases.cu"), os.path.join(tmp, "libphases.so")
        with open(cu, "w") as f:
            f.write(src)
        proc = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC), "-shared", "-o", so,
                               cu], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"phases: nvcc failed:\n{proc.stderr}")
        marked_lib = ctypes.CDLL(so)
    for name in ("sfm_pcg_solve", "sfm_pcg_blocks_per_sm"):
        getattr(marked_lib, name).argtypes = list(kernels._SIGNATURES[name])
        getattr(marked_lib, name).restype = ctypes.c_int
    marked_lib.sfm_phase_read.argtypes = [ctypes.c_void_p]

    def run(prob, what, reps=5):
        cfg = BAConfig()
        inv, ne = cs.first_iteration_inputs(prob, cfg)
        M_inv, d = core.pcg_preconditioner(ne, prob, inv)
        rhs = core._schur_rhs(ne, prob, inv).contiguous()
        args = (ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
                inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d, rhs, cfg.cg_iterations, cfg.cg_tolerance)
        torch.cuda.synchronize()
        kernels._lib = marked_lib
        try:
            plan = kb.pcg_launch_plan(inv.point_bounds)
            kb.pcg_solve(*args, plan=plan)
            torch.cuda.synchronize()
            marked_lib.sfm_phase_reset()
            t0 = time.perf_counter()
            for _ in range(reps):
                kb.pcg_solve(*args, plan=plan)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
            buf = (ctypes.c_ulonglong * (4096 * len(names)))()
            marked_lib.sfm_phase_read(buf)
        finally:
            kernels._lib = real
        t = torch.tensor(list(buf), dtype=torch.float64).reshape(4096, len(names))[:plan.grid]
        t = t / (reps * cfg.cg_iterations) / 1e3     # microseconds per step
        row = {n: [round(float(t[:, i].mean()), 2), round(float(t[:, i].max()), 2)] for i, n in enumerate(names)}
        print(f"[phases] {card()} {what}: C={prob.num_cameras} O={prob.obs_w.shape[0]} grid {plan.grid} "
              f"{'streaming' if plan.streaming else 'resident'}, largest slice {plan.max_slice}; {wall * 1e3:.3f} "
              f"ms a solve (marked); us per CG step, mean and max over blocks: {json.dumps(row)}; step "
              f"{float(t.sum(1).mean()):.2f}", flush=True)

    run(cs.schur_problem(device), "orbit")
    run(cs.schur_problem(device, cs.WIDE_CAMERAS, cs.WIDE_POINTS), "wide orbit")
    rec, _ = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                        centre_noise=cs.POLISH_CENTRE_NOISE)
    run(build_problem(rec, tight=True, device=device)[0], "merged model")


def kernels_cmd(device, pairs: int, keypoints: int):
    import torch

    from sfm_tpu_torch.ba import build_problem
    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.kernels.ba_kernels import cam_segment_sum
    from sfm_tpu_torch.kernels.match_topk import match_topk2

    def rows(what, rs):
        for r in rs:
            print(f"[kernels] {card()} {what} " + json.dumps({f: r[f] for f in cs.SHAPE_FIELDS}),
                  flush=True)

    print(f"[kernels] {card()} dog_extrema_scores " + json.dumps(cs.check_dog(device, cs.SLICE_IMAGE)),
          flush=True)
    rows("match_topk2", cs.check_match(device, keypoints, pairs)[1])
    # The wrapper on fp32 descriptors, as the matcher hands them over: the
    # kernel's own share beside the bf16 conversions.
    da, db, vb = cs._planted_descriptors(device, keypoints, keypoints, seed=4, pairs=pairs)
    _profile_calls(f"match_topk2 {pairs} x {keypoints} x {keypoints}", lambda: match_topk2(da, db, vb))
    del da, db, vb
    rec, _ = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                        centre_noise=cs.POLISH_CENTRE_NOISE)
    for prob in (cs.schur_problem(device), build_problem(rec, tight=True, device=device)[0]):
        inv = core.solve_invariants(prob)
        O, C = prob.obs_w.shape[0], prob.num_cameras
        lengths = (inv.cam_bounds[1:] - inv.cam_bounds[:-1]).float()
        print(f"[kernels] {card()} segment tables O={O} N={inv.cam_inv_perm.numel()} "
              f"weighted={inv.cam_perm.numel()} C={C}: camera segments mean {float(lengths.mean()):.1f} "
              f"max {int(lengths.max())}", flush=True)
        rows("cam_segment_sum", cs.check_segment_sum(inv, O, C, prob.num_points, device))
        cfg = BAConfig()
        checked = (cs.check_big(prob, cfg, device)[0] if core.uses_big_kernels(prob) else
                   {**cs.check_ba(prob, cfg, device, "orbit"), **cs.check_schur(prob, cfg, device)})
        for k, r in checked.items():
            print(f"[kernels] {card()} {k} C={C} " + json.dumps(
                {f: r[f] for f in cs.SHAPE_FIELDS[1:] + ("k3_ms", "k3_device_ms") if f in r}), flush=True)
        for K in (6, cs.NE_CAM_ROWS):
            values = torch.randn((K, O), device=device)
            _profile_calls(f"cam_segment_sum camera side [{K}, {O}] -> [{C}, {K}]",
                           lambda: cam_segment_sum(values, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm))
        values = torch.randn((9, O), device=device)
        _profile_calls(f"cam_segment_sum point side [9, {O}] -> [{prob.num_points}, 9]",
                       lambda: cam_segment_sum(values, None, inv.point_bounds))


def features_cmd(device, images: int):
    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.pipeline import ingest, stages

    ring, _ = cs.render_ring(images, cs.INC_BLOBS, cs.INC_ARC)
    cfg = PipelineConfig()
    batch = ingest.load_images(list(ring), cfg.sift)
    with cs.record_dog_stacks() as seen:
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            stages.extract_stage(batch, cfg, device)
            print(f"[features] {card()} extract_stage of {images} x {cs.SLICE_IMAGE}^2 views ({run}): "
                  f"{time.perf_counter() - t0:.3f}s", flush=True)
    for row in cs.check_dog_path(device, seen):
        row["calls"] //= 2     # per run of the stage
        print(f"[features] {card()} dog_extrema_scores " + json.dumps(
            {f: row[f] for f in cs.SHAPE_FIELDS + ("extrema",)}), flush=True)
    del seen
    chunk, sift_cfg, valid_hw = cs.ring_chunk(device, ring)
    n_kp = cs.check_features_route(chunk, sift_cfg, valid_hw)
    print(f"[features] {card()} use_pallas True and False identical on the first chunk "
          f"({n_kp} valid keypoints)", flush=True)
    rows = cs.check_descriptors(device, chunk, sift_cfg, valid_hw)
    for row in rows:
        print(f"[features] {card()} sift_descriptors " + json.dumps({f: row[f] for f in cs.SHAPE_FIELDS}),
              flush=True)
    print(f"[features] {card()} sift_descriptors untimed gaps " + json.dumps(rows[0]["untimed"]), flush=True)
    print(f"[features] {card()} " + json.dumps(cs.feature_breakdown(chunk, sift_cfg, valid_hw)), flush=True)


# dogsweep's variants of csrc/dog_extrema.cu: ring depths, and the tiles
# dispatched beside the plan's own.
_DOG_STAGES = (3, 4, 6)
_DOG_TILES = ((16, 64), (16, 32), (32, 64), (8, 64), (8, 32))


def _dog_source(src: str, stages: int) -> tuple[str, list]:
    """dog_extrema.cu with a ring of `stages` and every _DOG_TILES tile
    whose shared memory fits 48 KB dispatched; and those tiles."""
    from sfm_tpu_torch.kernels import dog_extrema as k1

    ring, anchor = "constexpr int kStages = 3;", "  return (int)cudaErrorInvalidValue;\n}\n\n}  // namespace"
    if ring not in src or anchor not in src:
        raise RuntimeError("dogsweep: csrc/dog_extrema.cu no longer has the lines it edits")
    tiles = [t for t in _DOG_TILES if (stages + 1) * (t[0] + 2) * (t[1] + 8) * 4 <= 48 * 1024]
    extra = "".join(f"  if (tile_h == {h} && tile_w == {w})\n    return launch_tiles<{h}, {w}, VEC>("
                    "gauss, out, B, L, H, W, pre, stream);\n" for h, w in tiles if (h, w) not in k1.TILES)
    return src.replace(ring, f"constexpr int kStages = {stages};").replace(anchor, extra + anchor), tiles


def dogsweep_cmd(device):
    import ctypes
    import tempfile

    import numpy as np
    import torch

    from sfm_tpu_torch import kernels
    from sfm_tpu_torch.config import SiftConfig
    from sfm_tpu_torch.kernels import dog_extrema as k1
    from sfm_tpu_torch.ops.detect import pre_threshold
    from sfm_tpu_torch.ops.pyramid import build_pyramid

    src = (kernels.CSRC / "dog_extrema.cu").read_text()
    variants = []
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for stages in _DOG_STAGES:
            text, tiles = _dog_source(src, stages)
            cu, so = os.path.join(tmp, f"dog{stages}.cu"), os.path.join(tmp, f"libdog{stages}.so")
            with open(cu, "w") as f:
                f.write(text)
            procs.append((stages, tiles, so, subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", so, cu],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        for stages, tiles, so, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"dogsweep: nvcc failed:\n{err}")
            fn = ctypes.CDLL(so).sfm_dog_extrema
            fn.argtypes = list(kernels._SIGNATURES["sfm_dog_extrema"])
            fn.restype = ctypes.c_int
            variants.append((stages, tiles, fn))
    cfg = SiftConfig()
    pre = pre_threshold(cfg)
    img = np.random.default_rng(0).uniform(0, 1, (8, cs.SLICE_IMAGE, cs.SLICE_IMAGE)).astype(np.float32)
    octaves = [o.contiguous() for o in build_pyramid(torch.from_numpy(img).to(device), cfg)]
    stacks = ([octaves[0][:1].contiguous()] + octaves + [o[:4].contiguous() for o in octaves])
    for gauss in stacks:
        B, L, H, W = gauss.shape
        ref = k1.dog_extrema_scores_plain(gauss, pre)
        out = torch.empty_like(ref)
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for stages, tiles, fn in variants:
            for tile in tiles:
                def go(fn=fn, tile=tile):
                    if fn(gauss.data_ptr(), out.data_ptr(), B, L, H, W, pre, *tile, 1, stream) != 0:
                        raise RuntimeError(f"dogsweep: launch failed ({stages} stages, tile {tile})")
                out.zero_()
                go()
                if not torch.equal(out, ref):
                    raise AssertionError(f"dogsweep: {stages} stages, tile {tile} not bit-exact")
                ms = cs.device_ms(go, device)
                row[f"{stages} {tile[0]}x{tile[1]}"] = None if ms is None else round(ms * 1e3, 2)
        bound_us = cs.nbytes(gauss, ref) / cs.HBM_BYTES_PER_S * 1e6
        print(f"[dogsweep] {card()} {B}x{L}x{H}x{W}: plan {k1.dog_launch_plan(B, H, W)}, bound "
              f"{bound_us:.2f} us; device us by (stages, tile): {json.dumps(row)}", flush=True)


def _session(fn, calls: int, lead_in_s: float) -> list:
    """One plain torch.profiler session over `calls` calls of fn(), started
    on an idle card, the calls lead_in_s after its start: its device rows
    as chip_smoke.traced gives them."""
    import torch

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(lead_in_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in cs.device_rows(prof)]


def profiler_cmd(device, calls: int, sessions: int):
    import torch

    from sfm_tpu_torch.ba import build_problem, core
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.kernels import LAUNCHES
    from sfm_tpu_torch.kernels import ba_kernels as kb

    prob = cs.schur_problem(device)
    cfg = BAConfig()
    inv, ne = cs.first_iteration_inputs(prob, cfg)
    lam = torch.tensor(cfg.initial_lambda, dtype=torch.float32, device=device)
    step = cs.lm_step(prob, cfg, inv, ne)
    M_inv, d = core.pcg_preconditioner(ne, prob, inv)
    rhs = core._schur_rhs(ne, prob, inv).contiguous()
    base = (prob.obs_cam, prob.obs_point, prob.points, inv.static_t, prob.cam_params.contiguous(),
            prob.intrinsics)
    rec, _ = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                        centre_noise=cs.POLISH_CENTRE_NOISE)
    big = build_problem(rec, tight=True, device=device)[0]
    big_inv = core.solve_invariants(big, core.near_plane_floor(big))
    big_args = (core._pts_t(big, big.points), big_inv.static_t, core._rows_t(big.cam_params, big.obs_cam),
                big_inv.intr_t, big_inv.z_floor, cfg.robust_loss, cfg.robust_scale_px)
    fns = {
        "fused_ne_payloads": lambda: kb.fused_ne_payloads(
            *base, inv.point_bounds, inv.cam_perm, inv.cam_bounds, inv.cam_inv_perm, lam, inv.z_floor,
            cfg.robust_loss, cfg.robust_scale_px, plan=inv.pcg_plan, schur_jacobi=True),
        "fused_cost_sums": lambda: kb.fused_cost_sums(
            *base, inv.point_bounds, inv.z_floor, cfg.robust_loss, cfg.robust_scale_px, step=step,
            plan=inv.pcg_plan),
        "pcg_solve": lambda: kb.pcg_solve(
            ne.W_t, ne.Hpp_inv, prob.obs_cam, prob.obs_point, inv.point_bounds, inv.cam_perm,
            inv.cam_bounds, inv.cam_inv_perm, ne.Hcc, M_inv, d, rhs, cfg.cg_iterations, cfg.cg_tolerance,
            plan=inv.pcg_plan),
        "fused_cost_sums_big": lambda: kb.fused_cost_sums_big(*big_args),
    }
    methods = {"session, no lead-in": lambda fn: _session(fn, calls, 0.0),
               "session, 20 ms lead-in": lambda fn: _session(fn, calls, 0.02),
               "chip_smoke.traced, one session": lambda fn: cs.traced(fn, calls, sessions=1)[0]}
    for name, fn in fns.items():
        fn()
        for method, run in methods.items():
            for session in range(sessions):
                before = LAUNCHES[name]
                rows = run(fn)
                # traced runs the calls twice, the first step discarded.
                own = (LAUNCHES[name] - before) / calls / (2 if method.startswith("chip_smoke") else 1)
                launches, ms, top = cs.per_call(rows, calls)
                print(f"[profiler] {card()} {name}, {method}, session {session}: wrapper {own:g} "
                      f"launches a call; recorded {launches:g} launches, device {ms:.4f} ms a call; rows "
                      + json.dumps([[n, c] for n, c, _ in top]), flush=True)


def per_iteration(prob, solver: str) -> dict:
    """Seconds per LM iteration of bundle_adjust on prob with the given
    reduced solve forced (max_iterations=10, function tolerance 0 so every
    run takes all ten), after a warm-up run, and the final cost."""
    import torch

    from sfm_tpu_torch.ba import bundle_adjust, core
    from sfm_tpu_torch.config import BAConfig

    gate = core._DENSE_MAX_VOLUME
    cfg = BAConfig(max_iterations=10, function_tolerance=0.0,
                   dense_schur_max_cameras=10 ** 6 if solver == "dense" else 0)
    core._DENSE_MAX_VOLUME = 1 << 62 if solver == "dense" else gate
    try:
        bundle_adjust(prob, cfg)                                # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, stats = bundle_adjust(prob, cfg)
        torch.cuda.synchronize()
        return {"s_per_iteration": (time.perf_counter() - t0) / stats.iterations,
                "final_cost": float(stats.final_cost)}
    finally:
        core._DENSE_MAX_VOLUME = gate


def crossover_cmd(device):
    """Seconds per LM iteration of each reduced solver on the same orbit
    problems (per_iteration)."""
    from sfm_tpu_torch.ba import core
    from sfm_tpu_torch.config import BAConfig

    # Padded (C, O): (32, 64k) (32, 128k) (64, 32k) (64, 128k) (128, 32k)
    # (128, 64k) (128, 128k) (256, 16k) (256, 64k) (256, 128k); C * O = 4M is
    # the gate's edge (dense at or below it).
    for cams, pts in [(28, 1200), (28, 4000), (60, 300), (60, 1100), (120, 130), (120, 280),
                      (120, 520), (250, 60), (250, 250), (250, 500)]:
        prob = cs.schur_problem(device, num_cameras=cams, num_points=pts)
        C, O = prob.num_cameras, prob.obs_w.shape[0]
        # Dense S assembly past C * O = 128M is beyond memory sense.
        row = {s: None if s == "dense" and C * O > (1 << 27) else per_iteration(prob, s)
               for s in ("dense", "pcg")}
        print(f"[crossover] {card()} C={C} O={O} C*O={C * O} gate={'dense' if core.uses_dense_solver(prob, BAConfig()) else 'pcg'} "
              + json.dumps(row), flush=True)


def ptxas_cmd():
    """nvcc -Xptxas -v over each source with the package's flags; one line
    per kernel: its demangled name, registers, spills, shared memory."""
    import re
    import shutil
    import tempfile

    from sfm_tpu_torch import kernels

    nvcc = kernels._nvcc()
    filt = shutil.which("cu++filt") or os.path.join(os.path.dirname(nvcc), "cu++filt")
    with tempfile.TemporaryDirectory() as tmp:
        for src in sorted(kernels.CSRC.glob("*.cu")):
            out = subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                                  os.path.join(tmp, src.stem + ".o")], capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(out.stderr)
            name, rows = None, []
            for line in out.stderr.splitlines():
                m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
                if m:
                    name = m.group(1)
                    continue
                m = re.search(r"Used \d+ registers.*", line)
                if m and name:
                    rows.append((name, m.group(0)))
                m = re.search(r"\d+ bytes stack frame, \d+ bytes spill stores, \d+ bytes spill loads", line)
                if m and name:
                    rows.append((name, m.group(0)))
            names = sorted({n for n, _ in rows})
            demangled = {}
            if os.path.exists(filt):
                demangled = dict(zip(names, subprocess.run([filt], input="\n".join(names), capture_output=True,
                                                           text=True).stdout.splitlines()))
            for n in names:
                info = " | ".join(r for m_, r in rows if m_ == n)
                print(f"[ptxas] {card()} {src.name}: {demangled.get(n, n)}: {info}", flush=True)


def refined_cmd(device, source: str, offsets, baseline: bool):
    from sfm_tpu_torch.config import BAConfig

    if source == "ring":
        ring, _ = cs.render_ring(cs.INC_IMAGES, cs.INC_BLOBS, cs.INC_ARC)
        rec, _, ba_log, _, wall = cs.run_reconstruct(device, ring)
        del ring
        cfg = ba_log[-1]["cfg"]
        print(f"[refined] {card()} incremental ring: {json.dumps(rec.summary())}, wall {wall:.2f}s", flush=True)
    else:
        rec, cfg = cs.orbit_reconstruction(100, 500), BAConfig()
    t0 = time.perf_counter()
    rows, k9 = cs.check_refined_kernels(rec, cfg, device)
    print(f"[refined] {card()} kernel checks {time.perf_counter() - t0:.1f}s", flush=True)
    cs.log_results(f"{card()} refined ({source})", rows)
    cs.log_shapes("cam_segment_sum", k9)
    if source == "ring":
        try:
            print(f"[refined] {card()} ring BA: "
                  + json.dumps(cs.run_refined_ba(rec, cfg, device, cs.INC_FOCAL, recover=False)), flush=True)
        except AssertionError as e:   # reported, not enforced
            print(f"[refined] {card()} ring BA: {e}", flush=True)
    try:
        orbit = cs.orbit_reconstruction(*cs.REFINED_ORBIT, outliers=0.0)
        print(f"[refined] {card()} orbit BA: "
              + json.dumps(cs.run_refined_ba(orbit, cfg, device, cs.SLICE_FOCAL, recover=True)), flush=True)
    except AssertionError as e:
        print(f"[refined] {card()} orbit BA: {e}", flush=True)
    variants = {"refined": cs.REFINED_OVERRIDES, **({"not refined": {}} if baseline else {})}
    for offset in offsets:
        for what, overrides in variants.items():
            run = cs.run_refined_reconstruct(device, offset, overrides)
            cs.log_bundle_adjustments("refined", run["ba_log"])
            print(f"[refined] {card()} {cs.REFINED_IMAGES} views, focal offset {offset}, {what}: "
                  + json.dumps(cs.check_refined_reconstruct(run)) + " launches " + json.dumps(run["launches"]),
                  flush=True)


def refinedpolish_cmd(device, sharded: bool):
    t0 = time.perf_counter()
    model, truth = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                              centre_noise=cs.POLISH_CENTRE_NOISE)
    print(f"[refinedpolish] {card()} model built in {time.perf_counter() - t0:.1f}s", flush=True)
    rp = cs.run_refined_polish(model, truth, device)
    print(f"[refinedpolish] {card()} (a) " + json.dumps(rp["readings"]), flush=True)
    try:
        cs.check_refined_polish(rp["readings"])
    except AssertionError as e:   # reported, not enforced
        print(f"[refinedpolish] {card()} (a) bars: {e}", flush=True)
    t0 = time.perf_counter()
    rows, twins, k9 = cs.check_big(rp["problem"], rp["cfg"], device)
    rows["pcg_solve_big_w8"] = cs.check_pcg(rp["problem"], rp["cfg"], device, "refined polish",
                                            x_steps=cs.PCG_X_STEPS)
    print(f"[refinedpolish] {card()} (b) kernel checks {time.perf_counter() - t0:.1f}s", flush=True)
    cs.log_results(f"{card()} refined polish", rows)
    cs.log_shapes("cam_segment_sum", k9)
    print(f"[refinedpolish] {card()} twins (ms): {json.dumps(twins)}", flush=True)
    if sharded:
        import torch.distributed as dist

        mesh = cs.join_group(device)
        try:
            r = cs.check_sharded_ba(rp["problem"], rp["cfg"], device, mesh, "refined polish",
                                    cs.DIST_POLISH_ITERATIONS)
            print(f"[refinedpolish] {card()} (c) sharded BA: " + json.dumps(r), flush=True)
        finally:
            dist.destroy_process_group()


def ringfeatures_cmd(device, offsets, out_dir: str):
    import numpy as np

    from sfm_tpu_torch.config import PipelineConfig
    from sfm_tpu_torch.pipeline import ingest, stages

    os.makedirs(out_dir, exist_ok=True)
    cfg = PipelineConfig(verbose=False)
    for offset in offsets:
        focal = (1.0 + offset) * cs.INC_FOCAL
        t0 = time.perf_counter()
        imgs, scene = cs.render_ring(cs.REFINED_IMAGES, cs.INC_BLOBS, cs.REFINED_ARC, focal)
        batch = ingest.load_images(list(imgs), cfg.sift)
        feats = stages.extract_stage(batch, cfg, device)
        graph = stages.match_and_verify_stage(feats, stages.exhaustive_pairs(len(imgs)), batch.intrinsics, cfg,
                                              device, seed=cfg.seed)
        path = os.path.join(out_dir, f"ring46_{offset:g}.npz")
        np.savez_compressed(path, xy=feats.xy, valid=feats.valid, intrinsics=batch.intrinsics,
                            **{f"graph_{k}": getattr(graph, k) for k in ("pairs", "idx_i", "idx_j", "inlier",
                                                                        "num_inliers", "num_h_inliers", "rvec",
                                                                        "tvec", "ok", "pose_ok")},
                            true_rvecs=scene.rvecs, true_tvecs=scene.tvecs, rendered_focal=focal,
                            radius=cs.INC_RADIUS)
        print(f"[ringfeatures] {card()} offset {offset:g}: {len(imgs)} views, {int(feats.valid.sum())} keypoints, "
              f"{int(graph.ok.sum())} of {len(graph.pairs)} pairs verified, {time.perf_counter() - t0:.1f}s "
              f"-> {path} ({os.path.getsize(path) / 2 ** 20:.1f} MiB)", flush=True)


def _gloo_probe(mesh) -> dict:
    """Which of the collectives the multi-device routes use gloo runs on
    CUDA tensors (this process's card): each tried in turn, its result
    checked; an exception is reported, not raised."""
    import torch

    from sfm_tpu_torch.dist.mesh import all_gather_rows, ring_shift

    D, r = mesh.size, mesh.rank
    t = torch.full((4,), float(r + 1), device=mesh.device)
    checks = {
        "all_reduce": (lambda: _reduced(t.clone(), mesh), float(D * (D + 1) // 2)),
        "all_gather": (lambda: float(all_gather_rows(t, mesh).sum()), float(4 * D * (D + 1) // 2)),
        "send_recv": (lambda: float(ring_shift((t,), mesh)[0][0]), float((r - 1) % D + 1)),
    }
    out = {}
    for name, (fn, want) in checks.items():
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if got == want else f"wrong value {got}, expected {want}"
        except Exception as e:  # reported, not raised: the probe asks what works
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def _reduced(t, mesh) -> float:
    import torch.distributed as dist

    dist.all_reduce(t, group=mesh.group)
    return float(t[0])


def phase12_cmd(device):
    t0 = time.perf_counter()
    ring, _ = cs.render_ring(cs.INC_IMAGES, cs.INC_BLOBS, cs.INC_ARC)
    rec, _, ba_log, _, _ = cs.run_reconstruct(device, ring)
    del ring
    final = ba_log[-1]
    polish = cs.run_polish(device)
    first = polish["ba_log"][0]
    views, _ = cs.render_ring(cs.REFINED_IMAGES, cs.INC_BLOBS, cs.REFINED_ARC,
                              (1.0 + cs.REFINED_FOCAL_OFFSET) * cs.INC_FOCAL)
    print(f"[dist] {card()} phase 12's inputs made in {time.perf_counter() - t0:.1f}s", flush=True)
    t0 = time.perf_counter()
    out = cs.run_sharded(views, (final["problem"], final["cfg"], rec), (first["problem"], first["cfg"]), device)
    cs.log_results(f"{card()} sharded BA", out["results"])
    for k in cs.SHARDED_KERNELS:
        cs.log_shapes(k, out["results"][k]["shapes"])
    print(f"[dist] {card()} phase 12 {time.perf_counter() - t0:.1f}s; launches {json.dumps(out['launches'])}",
          flush=True)


def dist_cmd(device, polish: bool):
    import tempfile

    import torch.distributed as dist

    from sfm_tpu_torch.ba import build_problem
    from sfm_tpu_torch.config import BAConfig
    from sfm_tpu_torch.dist.launch import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        try:
            probe = run_ranks(_gloo_probe, 2, init_file=os.path.join(tmp, "init"), device="cuda:0",
                              backend="gloo", timeout=180)
        except Exception as e:  # a process that died is the answer too
            probe = f"{type(e).__name__}: {str(e)[-600:]}"
    print(f"[dist] {card()} gloo, two processes on the one card, CUDA tensors: {json.dumps(probe)}", flush=True)

    mesh = cs.join_group(device)
    try:
        cfg = BAConfig()
        prob = cs.schur_problem(device)
        prob8, _, _ = build_problem(cs.orbit_reconstruction(100, 500), refine_intrinsics=True, device=device)
        cases = [(prob, cfg, "orbit"), (prob8, cs.refine_config(cfg), "orbit, 8 wide")]
        for p, c, what in cases:
            cs.log_results(f"{card()} {what}", cs.check_sharded_kernels(p, c, device, what))
            print(f"[dist] {card()} sharded BA: " + json.dumps(cs.check_sharded_ba(p, c, device, mesh, what)),
                  flush=True)
        print(f"[lm] {card()} sharded LM, orbit: " + json.dumps(cs.sharded_lm_report(prob, cfg, device, mesh)),
              flush=True)
        if polish:
            rec, _ = cs.arc_ring_reconstruction(cs.POLISH_CAMERAS, cs.POLISH_POINTS, cs.POLISH_TRACKS, seed=3,
                                                centre_noise=cs.POLISH_CENTRE_NOISE)
            big, _, _ = build_problem(rec, device=device)
            cs.log_results(f"{card()} merged model", cs.check_sharded_kernels(big, cfg, device, "merged model"))
            print(f"[dist] {card()} sharded BA: " + json.dumps(cs.check_sharded_ba(
                big, cfg, device, mesh, "merged model", iterations=cs.DIST_POLISH_ITERATIONS)), flush=True)
    finally:
        dist.destroy_process_group()


def config4_cmd(device, images: int, mode: str, kernels: bool):
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="config4_")
    try:
        run = cs.run_config4(workdir, images, mode)
        r = cs.config4_readings(run)
        failed = cs.check_config4(run, r)
        for i, b in enumerate(run["ba_log"]):
            cs.log(f"[config4] BA {i}: C={b['C']} O={b['O']} {b['solver']} {b['iterations']} LM iterations "
                   f"{b['seconds']:.3f}s, cost {b['initial_cost']:.4f} -> {b['final_cost']:.4f}")
        print(f"[config4] {card()} {json.dumps({**r, 'failed': failed})}", flush=True)
        if kernels:
            rows = cs.config4_kernels(run, device)
            for k, v in rows.items():
                cs.log_shapes(k, v)
            print(f"[config4] {card()} idle " + json.dumps(cs.config4_idle(run, device)), flush=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("scene")
    p.add_argument("specs", nargs="+")
    p = sub.add_parser("slice")
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--save-problem", metavar="PATH")
    p.add_argument("--root", metavar="DIR", help="import sfm_tpu_torch from this tree")
    p = sub.add_parser("lm")
    p.add_argument("problem", metavar="PATH")
    p.add_argument("--root", metavar="DIR", help="import sfm_tpu_torch from this tree")
    sub.add_parser("crossover")
    p = sub.add_parser("polish")
    p.add_argument("--iterations", type=int, default=5)
    p.add_argument("--root", metavar="DIR", help="import sfm_tpu_torch from this tree")
    p = sub.add_parser("partition")
    p.add_argument("--variants", nargs="+", default=["default", "no_straighten"],
                   choices=list(PARTITION_VARIANTS))
    p.add_argument("--dump", metavar="DIR")
    p = sub.add_parser("global")
    p.add_argument("sizes", nargs="+", type=int)
    p = sub.add_parser("pcg")
    p.add_argument("--cameras", type=int, default=100)
    p.add_argument("--points", type=int, default=500)
    p.add_argument("--blocks", type=int, help="also check on a grid of this many blocks")
    p.add_argument("--root", metavar="DIR", help="import sfm_tpu_torch from this tree")
    sub.add_parser("phases")
    p = sub.add_parser("profiler")
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--sessions", type=int, default=3)
    sub.add_parser("dogsweep")
    p = sub.add_parser("features")
    p.add_argument("--images", type=int, default=cs.INC_IMAGES)
    p.add_argument("--root", metavar="DIR", help="import sfm_tpu_torch from this tree")
    p = sub.add_parser("kernels")
    p.add_argument("--pairs", type=int, default=32)
    p.add_argument("--keypoints", type=int, default=4096)
    sub.add_parser("ptxas")
    p = sub.add_parser("refined")
    p.add_argument("--source", choices=("ring", "orbit"), default="ring")
    p.add_argument("--offsets", type=float, nargs="*", default=[cs.REFINED_FOCAL_OFFSET])
    p.add_argument("--baseline", action="store_true", help="each offset also without refinement")
    p = sub.add_parser("refinedpolish")
    p.add_argument("--sharded", action="store_true", help="also the sharded LM (phase 13 (c))")
    p = sub.add_parser("ringfeatures")
    p.add_argument("--offsets", type=float, nargs="+", default=[0.0, cs.REFINED_FOCAL_OFFSET])
    p.add_argument("--out", default="chiprun_out")
    p = sub.add_parser("dist")
    p.add_argument("--polish", action="store_true", help="also on the merged model (C = 10,240)")
    p.add_argument("--phase12", action="store_true", help="chip_smoke.py's phase 12 alone")
    p = sub.add_parser("config4")
    p.add_argument("images", type=int, nargs="?", default=cs.CONFIG4_IMAGES)
    p.add_argument("mode", nargs="?", choices=("global", "incremental"), default="global")
    p.add_argument("--kernels", action="store_true", help="also the kernels at the run's shapes")
    args = parser.parse_args()
    if getattr(args, "root", None):
        sys.path.insert(0, os.path.abspath(args.root))
    if not torch.cuda.is_available():
        print("torch_perf: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.cmd == "scene":
        scene_cmd(device, args.specs)
    elif args.cmd == "slice":
        slice_cmd(device, args.runs, args.save_problem)
    elif args.cmd == "lm":
        lm_cmd(device, args.problem)
    elif args.cmd == "dogsweep":
        dogsweep_cmd(device)
    elif args.cmd == "features":
        features_cmd(device, args.images)
    elif args.cmd == "kernels":
        kernels_cmd(device, args.pairs, args.keypoints)
    elif args.cmd == "profiler":
        profiler_cmd(device, args.calls, args.sessions)
    elif args.cmd == "phases":
        phases_cmd(device)
    elif args.cmd == "pcg":
        pcg_cmd(device, args.cameras, args.points, args.blocks)
    elif args.cmd == "polish":
        polish_cmd(device, args.iterations)
    elif args.cmd == "partition":
        partition_cmd(device, args.variants, args.dump)
    elif args.cmd == "global":
        global_cmd(device, args.sizes)
    elif args.cmd == "ptxas":
        ptxas_cmd()
    elif args.cmd == "refined":
        refined_cmd(device, args.source, args.offsets, args.baseline)
    elif args.cmd == "refinedpolish":
        refinedpolish_cmd(device, args.sharded)
    elif args.cmd == "ringfeatures":
        ringfeatures_cmd(device, args.offsets, args.out)
    elif args.cmd == "config4":
        config4_cmd(device, args.images, args.mode, args.kernels)
    elif args.cmd == "dist":
        if args.phase12:
            phase12_cmd(device)
        else:
            dist_cmd(device, args.polish)
    else:
        crossover_cmd(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
