"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Needs the CUDA cards the cell asks for: with
fewer it exits 2 and prints no result. With --trace 0 the result carries
the cell's end-to-end metrics, with --trace 1 its per-layer metrics and the
device's busy time. The window's answers are compared with the plain
reference after the window; each number compared is printed beside its
limit, last on standard error and under "checks", the last key of the line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CACHES = ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR")


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    from portbench import harness, nojax

    for var in CACHES:   # build caches live inside the checkout, at fixed paths
        os.environ.setdefault(var, str(harness.ROOT / ".bench_cache" / var.lower()))
    cell = harness.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # The configurations state float32 with TF32 off (the port sets the same on import).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    name, limit = torch.cuda.get_device_name(0), harness.power_limit(0)
    print(f"portbench: {args.workload} seed {args.seed} on {name}, power limit {limit}", file=sys.stderr)

    run = harness.execute(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    if not any(run.counts.values()):
        print("portbench: the window completed no work", file=sys.stderr)
        return 3
    if run.traced and not (run.trace.device and run.trace.busy_s > 0):
        print("portbench: the profiler recorded no device events", file=sys.stderr)
        return 3
    bad = nojax.forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4

    checks, failed = harness.judge(run)
    device_rec = dict(platform="gpu", kind=name, count=cell.chips, memory_peak_bytes=run.memory_peak_bytes,
                      power_limit=limit)
    result = dict(correct=failed == 0, attempted=len(run.answers), failed=failed,
                  metrics=harness.metrics(run), device=device_rec)
    if run.traced:
        device_rec.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = dict(device_ops=run.trace.device_ops(), idle_gaps=run.trace.idle_gaps())
    result["checks"] = checks
    print(f"portbench: setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, {run.counts}, "
          f"comparison {run.compare_s:.3f} s",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
