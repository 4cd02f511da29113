"""The benchmark's runner: finds a cell's configuration, traffic, limits and
metric readers by the names in BENCHMARK.json, sets the cell up, measures
its window, compares the window's answers with the plain reference and
assembles the result line.

Files by name (a later cell or metric adds files, and edits none):
  portbench/configs/<config>.json   the deployment's sizes and settings
                                    (BENCHMARK.json's `file`)
  portbench/traffic/<traffic>.json  the traffic mix; its `kind` names the
                                    module in portbench/kinds/
  portbench/limits/<workload>.json  the limit of each number compared
  portbench/metrics/<metric>.py     read(run) -> value or None
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

from portbench import trace as tracing

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (has {sorted(cells)})")
    w = cells[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((BENCH / "limits" / f"{workload}.json").read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
    )


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kind_module(cell: Cell):
    return importlib.import_module(f"portbench.kinds.{cell.traffic['kind']}")


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: Cell
    seed: int
    traced: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    counts: dict = field(default_factory=dict)     # the window's work, by unit; all 0: none done
    calls: list = field(default_factory=list)      # the program calls of the window, with their shapes
    launches: dict = field(default_factory=dict)   # the port's launch counters over the window
    trace: tracing.Trace | None = None
    memory_peak_bytes: int = 0
    answers: list = field(default_factory=list)
    compare_s: float = 0.0


def power_limit(index: int = 0) -> str:
    """The card's power limit as nvidia-smi reads it ("unknown" without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", str(index)], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip() or "unknown"


def execute(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float) -> Run:
    """Set up, measure the window (under the profiler when traced: a window
    of the traffic's trace_seconds, at most `seconds`), then compare."""
    import torch

    from sfm_tpu_torch import kernels

    kind = kind_module(cell)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell=cell, seed=seed, traced=traced)
    state = kind.setup(cell, seed, device)
    if cuda:
        torch.cuda.synchronize(device)
    run.setup_s = time.perf_counter() - t_start
    length = min(seconds, cell.traffic.get("trace_seconds") or seconds) if traced else seconds
    before = dict(kernels.LAUNCHES)
    if traced:
        with tracing.profiled() as tr:
            tr.mark()
            run.counts, run.calls, run.window_s = kind.window(state, length)
            tr.mark()
        run.trace = tr
    else:
        run.counts, run.calls, run.window_s = kind.window(state, length)
    run.launches = {k: v - before.get(k, 0) for k, v in kernels.LAUNCHES.items()}
    if cuda:
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(device))
    t0 = time.perf_counter()
    run.answers = kind.answers(state)
    run.compare_s = time.perf_counter() - t0
    return run


def judge(run: Run) -> tuple[dict, int]:
    """Each number's worst reading over the answers beside its limit, and
    the answers that broke a limit. A number that is not finite breaks it."""
    limits = run.cell.limits
    checks = {}
    failed = 0
    for row in run.answers:
        if any(not (math.isfinite(row[k]) and row[k] <= limits[k]) for k in limits):
            failed += 1
    for k, limit in limits.items():
        vals = [row[k] for row in run.answers]
        worst = max(vals, key=lambda v: v if math.isfinite(v) else math.inf) if vals else math.nan
        checks[k] = dict(value=worst, limit=limit)
    return checks, failed


def metrics(run: Run) -> dict:
    """The cell's end-to-end metrics, or its per-layer ones in a traced run;
    a reader that finds nothing leaves its metric out."""
    out = {}
    for m in (run.cell.per_layer if run.traced else run.cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out
