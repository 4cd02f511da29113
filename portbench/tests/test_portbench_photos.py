"""The "photos" traffic kind (c3200-features) on the CPU at a tiny size:
its views (a 4:3 photo at the top-left of a square zero canvas, the same
for a seed), a run through the harness that comes out correct, and one
with an altered answer that does not; the reader of the selection's span
(None on a program without it). On the card: the control fails the cell's
limits and the program passes them."""

import time
import types

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from portbench import harness, spans
from portbench.kinds import photos
from portbench.trace import Trace
from sfm_tpu_torch.utils.logging import Span

CPU = torch.device("cpu")
SEED = 2**33 + 17


def tiny_photos():
    """c3200-features at 128 px: a 128 x 96 photo in a 128^2 canvas, the
    first octave upsampled to 256^2; fewer blobs, their cubes and orbits a
    tenth the size, so that splats keep a few pixels at the smaller focal."""
    cell = tiny_cell("c3200-features")
    views = cell.config["views"]
    views.update(content_height=96)
    views["layers"] = [dict(layer, blobs=b, extent=layer["extent"] / 10, radius=layer["radius"] / 10)
                       for layer, b in zip(views["layers"], (300, 60))]
    return cell


def test_views_are_photos_in_square_canvases():
    views = tiny_photos().config["views"]
    spec = dict(views, views=2)
    a = photos.render(spec, SEED, CPU)
    assert a.shape == (2, 128, 128) and a.dtype == np.float32
    assert np.array_equal(a, photos.render(spec, SEED, CPU))
    assert not np.array_equal(a, photos.render(spec, SEED + 1, CPU))
    assert not a[:, 96:].any() and a[:, :96].std() > 0.01
    assert a.min() >= 0.0 and a.max() <= 1.0
    state = photos.setup(tiny_photos(), SEED, CPU)
    for b, fs in photos.program_outputs(state).items():
        assert (state.batches[b].valid_hw == [96, 128]).all()
        assert (fs.valid.sum(1) > 20).all() and (fs.xy[..., 1][fs.valid] < 95).all()


def test_photos_cell_sound():
    cell = tiny_photos()
    run = harness.execute(cell, SEED, 0.2, False, CPU, time.perf_counter())
    assert run.answers and run.counts["images"] >= 4
    assert run.calls[0]["upsample"] and run.calls[0]["image_size"] == 128
    checks, failed = harness.judge(run)
    assert failed == 0, checks


def test_photos_cell_altered_is_not_correct(monkeypatch):
    import sfm_tpu_torch.pipeline.stages as stages

    real = stages.extract_stage

    def altered(batch, cfg, device, mesh=None):
        fs = real(batch, cfg, device, mesh)
        fs.desc[0, 0] = np.roll(fs.desc[0, 0], 1)
        return fs

    monkeypatch.setattr(stages, "extract_stage", altered)
    run = harness.execute(tiny_photos(), SEED, 0.2, False, CPU, time.perf_counter())
    assert harness.judge(run)[1] > 0


def _span(sid, name, parent, t0, t1, **attrs):
    return Span(name=name, id=sid, parent=parent, thread=1, attrs=attrs, host_ns=(t0, t1), device_ns=(t0, t1))


def test_select_reader(monkeypatch):
    chunk = _span(1, "features.chunk", None, 0, 900)
    det = _span(2, "sift.detect", 1, 100, 500)
    sel = _span(3, "sift.detect.select", 2, 200, 300)
    down = _span(4, "features.download", 1, 700, 800, d2h_bytes=64)
    device = [("k1", 100, 200), ("nonzero", 200, 260), ("k14", 310, 350), ("Memcpy DtoH", 700, 750)]
    run = types.SimpleNamespace(trace=Trace(device=device, window=(0, 1000)), counts={"images": 2})
    read = harness.reader("sift.detect.select.device_ms_per_image")
    monkeypatch.setattr(spans, "program_spans", lambda: [chunk, det, sel, down])
    assert read(run) == pytest.approx(60 * 1e-6 / 2)
    assert harness.reader("sift.detect.device_ms_per_image")(run) == pytest.approx(200 * 1e-6 / 2)
    run = types.SimpleNamespace(trace=Trace(device=device, window=(0, 1000)), counts={"images": 2})
    monkeypatch.setattr(spans, "program_spans", lambda: [chunk, det, down])   # the parent: no such span
    assert read(run) is None


@pytest.mark.card
def test_control_fails_and_program_passes(card_device):
    cell = tiny_photos()
    kind = harness.kind_module(cell)
    state = kind.setup(cell, 2**35 + 3, card_device)
    program = kind.answers(state, kind.program_outputs(state))
    control = kind.answers(state, kind.control_outputs(state))
    assert all(row[k] <= lim for row in program for k, lim in cell.limits.items())
    assert all(any(row[k] > lim for k, lim in cell.limits.items()) for row in control)


def test_k15_count_by_hand():
    import importlib.util

    from portbench import peaks

    spec = importlib.util.spec_from_file_location("k15", harness.BENCH / "metrics" / "k15_roofline.py")
    k15 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k15)
    call = dict(images=10, chunk=8, image_size=16, octaves=2, levels=6, upsample=True)
    # chunks of 8 and 2 views; upsampled octaves of 32^2 and 16^2; the maps
    # [b, 5, H, W] read once, k = min(4096 // 2, 5 H W) keys a map written
    # once (8 bytes)
    hand = sum((4 * b * 5 * H * H + 8 * b * min(2048, 5 * H * H)) / peaks.HBM_BYTES_PER_S
               for b in (8, 2) for H in (32, 16))
    assert k15.least(call, 4096) == pytest.approx(hand, rel=1e-12)
    dur = 4 * int(hand * 1e9)
    cell = types.SimpleNamespace(config={"sift": {"max_candidates": 4096}})
    names = ("select_histogram_kernel", "select_find_kernel", "select_write_kernel")
    device = [(f"(anonymous namespace)::{name}(...)", j * dur // 3, (j + 1) * dur // 3) for j, name in enumerate(names)]
    run = types.SimpleNamespace(trace=Trace(device=device, window=(0, 10**9)), calls=[call],
                                launches={"select_keys": 4}, cell=cell)
    read = harness.reader("k15_roofline")
    assert read(run) == pytest.approx(100 * hand / (dur * 1e-9), rel=1e-6)
    run.launches = {}   # a program without K15
    assert read(run) is None
