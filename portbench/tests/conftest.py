"""Fixtures of the benchmark's own tests (python3 -m pytest portbench/tests).

Tests that need a CUDA card carry the `card` marker and take the
`card_device` fixture, which skips when no card is found: the decision is
made inside the fixture, never while a module is imported. The others run
on the CPU through the port's plain versions, at tiny sizes.
"""

import copy
import json
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the H100")
    return torch.device("cuda", 0)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_cell(workload: str):
    """The workload's cell with its sizes cut to what a CPU test holds:
    eight 128^2 views with a small SIFT budget. Settings, traffic kind and
    limits are the cell's own."""
    from portbench import harness

    tiny = copy.deepcopy(harness.load_cell(workload))
    cfg = tiny.config
    cfg["views"].update(image_size=128, focal=153.6, blobs=200)
    cfg["sift"].update(max_keypoints=512, max_candidates=2048, desc_per_octave=256, num_octaves=3)
    tiny.traffic.update(views=8, views_per_call=4)
    return tiny
