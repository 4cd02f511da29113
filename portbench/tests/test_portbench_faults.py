"""A run on the CPU (past the look for a card), with the timed path broken
underneath, must come out not correct; the same run unbroken, correct.
Faults a cell can have: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced. (The cells
run on one chip: there is no exchange between chips to leave out.)"""

import time

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench import harness

CPU = torch.device("cpu")


def _run(cell, seconds, seed=2**32 + 1):
    run = harness.execute(cell, seed, seconds, False, CPU, time.perf_counter())
    assert run.answers
    return run


def _correct(run) -> bool:
    return harness.judge(run)[1] == 0


def _features_fault(monkeypatch, fault):
    import sfm_tpu_torch.pipeline.stages as stages

    real = stages.extract_stage
    last = {}

    def broken(batch, cfg, device, mesh=None):
        fs = real(batch, cfg, device, mesh)
        if fault == "unchanged":   # the previous call's answer handed back
            prev, last["fs"] = last.get("fs", fs), fs
            return prev
        if fault == "half":
            fs.valid[1::2] = False
            return fs
        fs.desc[0, 0] = np.roll(fs.desc[0, 0], 1)
        return fs

    monkeypatch.setattr(stages, "extract_stage", broken)


def test_features_cell_sound():
    assert _correct(_run(tiny_cell("r16k-features"), 0.2))


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_features_cell_broken(fault, monkeypatch):
    _features_fault(monkeypatch, fault)
    # long enough for both batches to be extracted after the warm-up, so
    # that an answer handed back from the call before is another batch's
    run = _run(tiny_cell("r16k-features"), 6.0)
    assert run.counts["calls"] >= 2
    assert not _correct(run)
