#!/usr/bin/env python3
"""Measurements of the PyTorch + CUDA port (sfm_tpu_torch) on one GPU.

    python3 tools/torch_perf.py scene N:BLOBS:ARC[:FOCAL[:RADIUS]] [...]
        reconstruct rendered rings of N 1024^2 views of the blob scene
        (chip_smoke.py's incremental slice) and report observations,
        accuracy, the bundle adjustments' sizes and solvers, and the stages;
    python3 tools/torch_perf.py slice [--runs 2]
        chip_smoke.py's incremental slice several times in one process
        (cold, then warm): stage and engine-phase seconds; then the last
        run's final global BA once more under torch.profiler: device busy
        time, idle share, kernel time by name; and that BA's seconds per LM
        iteration with the dense and with the PCG reduced solve;
    python3 tools/torch_perf.py crossover
        dense Cholesky vs PCG reduced solve on the same problems, seconds
        per LM iteration across padded (C, O).

Every line names the card and its power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
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


def _device_time_ms(prof) -> tuple[float, list]:
    """Sum of device (kernel + memcpy/memset) self time, and the top kernels."""
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / 1e3
    top = sorted(rows, key=lambda e: -e.self_device_time_total)[:12]
    return total, [(e.key[:60], e.count, e.self_device_time_total / 1e3) for e in top]


def slice_cmd(device, runs: int):
    import torch

    from sfm_tpu_torch import reconstruct
    from sfm_tpu_torch.ba import bundle_adjust
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
    solver = "dense" if uses_dense_solver(prob, cfg) else "pcg"
    bundle_adjust(prob, cfg)                                   # warm
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _, stats = bundle_adjust(prob, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, top = _device_time_ms(prof)
    print(f"[profile] {card()} global BA C={prob.num_cameras} O={prob.obs_w.shape[0]} {solver} "
          f"{stats.iterations} LM iterations: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for name, count, ms in top:
        print(f"[profile]   {ms:9.3f} ms  {count:6d}x  {name}", flush=True)
    row = {s: per_iteration(prob, s) for s in ("dense", "pcg")}
    print(f"[crossover] {card()} final global BA C={prob.num_cameras} O={prob.obs_w.shape[0]} "
          f"gate={solver} " + json.dumps(row), flush=True)


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


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("scene")
    p.add_argument("specs", nargs="+")
    p = sub.add_parser("slice")
    p.add_argument("--runs", type=int, default=2)
    sub.add_parser("crossover")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_perf: no CUDA device available", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.cmd == "scene":
        scene_cmd(device, args.specs)
    elif args.cmd == "slice":
        slice_cmd(device, args.runs)
    else:
        crossover_cmd(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
