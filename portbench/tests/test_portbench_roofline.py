"""Each roofline count against a hand count at a tiny shape, and each
reader's share against a trace made up for it."""

import types

import pytest

from portbench import harness, peaks
from portbench.trace import Trace

HBM, F32 = peaks.HBM_BYTES_PER_S, peaks.FP32_OPS_PER_S


def _run(calls, launches, device, counts=None, cell=None):
    tr = Trace(device=device, window=(0, 10**9))
    return types.SimpleNamespace(trace=tr, calls=calls, launches=launches, counts=counts or {}, cell=cell)


def test_k1_count_by_hand():
    read = harness.reader("k1_roofline")
    call = dict(images=10, chunk=8, image_size=16, octaves=2, levels=6, upsample=False)
    # chunks of 8 and 2 views; octaves of 16^2 and 8^2; a stack [b, 6, H, W]
    # read once, the maps [b, 5, H, W] written once; 5 + 3 * 53 ops a pixel.
    hand = 0.0
    for b in (8, 2):
        for H in (16, 8):
            px = b * H * H
            hand += max(4 * px * 11 / HBM, px * 164 / F32)
    least = _module("k1_roofline").least(call)
    assert least == pytest.approx(hand, rel=1e-12)
    dur = 2 * int(hand * 1e9)
    run = _run([call], {"dog_extrema_scores": 4}, [("void dog_extrema_kernel<16, 64, true>(...)", 0, dur)])
    assert read(run) == pytest.approx(100 * hand / (dur * 1e-9))


def _module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location("m", harness.BENCH / "metrics" / f"{name}.py")
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def test_device_readers():
    dev = [("a", 0, 2 * 10**8), ("b", 10**8, 3 * 10**8), ("c", 5 * 10**8, 6 * 10**8)]
    run = _run([], {}, dev, counts={"images": 2})
    assert run.trace.busy_s == pytest.approx(0.4)
    assert harness.reader("device_idle_pct.features")(run) == pytest.approx(60.0)
    assert harness.reader("sift.device_ms_per_image")(run) == pytest.approx((0.2 + 0.2 + 0.1) * 1e3 / 2)
    assert harness.reader("sift.launches_per_image")(run) == pytest.approx(1.5)
    gaps = dict(run.trace.idle_gaps())
    assert gaps["before c"] == pytest.approx(0.2) and gaps["end of window"] == pytest.approx(0.4)
    run.trace = None
    assert harness.reader("sift.launches_per_image")(run) is None
    assert harness.reader("k1_roofline")(run) is None
