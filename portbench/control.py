"""Readings that set the limits of a cell's numbers, on the chip.

    python3 -m portbench.control --workload NAME --seeds S1 S2 ... [--control-seeds K]

For each seed, in one process: the cell's set-up (its inputs, made from
the seed, and the program's warm-up), then one answer of the program to
each input (the lower readings); on the first K seeds also the control:
the plain reference in the program's place, one precision below the
configuration's (float32 with TF32 on) (the upper readings). Each side's
answers are judged as a run's are, by harness.judge against the cell's
limits. Prints one JSON line per seed: for each side each number's worst
reading, and `correct`, `attempted` and `failed` as a run would report
them. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def judged(cell, seed: int, answers: list) -> dict:
    from portbench import harness

    run = harness.Run(cell=cell, seed=seed, traced=False, answers=answers)
    checks, failed = harness.judge(run)
    return dict(correct=failed == 0, attempted=len(answers), failed=failed,
                worst={k: c["value"] for k, c in checks.items()})


def readings(cell, seed: int, device, control: bool) -> dict:
    from portbench import harness

    kind = harness.kind_module(cell)
    t0 = time.perf_counter()
    state = kind.setup(cell, seed, device)
    rec = dict(seed=seed, program=judged(cell, seed, kind.answers(state, kind.program_outputs(state))))
    if control:
        rec["control"] = judged(cell, seed, kind.answers(state, kind.control_outputs(state)))
    rec["seconds"] = time.perf_counter() - t0
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    device = torch.device("cuda", 0)
    print(json.dumps(dict(workload=args.workload, limits=cell.limits)), flush=True)
    for i, seed in enumerate(args.seeds):
        print(json.dumps(dict(workload=args.workload,
                              **readings(cell, seed, device, i < args.control_seeds))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
