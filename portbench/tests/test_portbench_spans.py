"""portbench/spans.py on hand-made device events and spans: containment,
the innermost span winning, unattributed events, the idle gaps split by the
host spans they overlap, "none" where no span is open, the alignment to the
trace's clock by the downloads' copies, and the readers of the eight span
metrics (None on a program without spans, and where the alignment or the
attribution does not hold)."""

import types

import pytest

from portbench import harness, spans
from portbench.trace import Trace
from sfm_tpu_torch.utils.logging import Span


def _span(sid, name, parent, host, device=None, **attrs):
    return Span(name=name, id=sid, parent=parent, thread=1, attrs=attrs, host_ns=host, device_ns=device)


def test_innermost_containing_span_wins():
    outer = _span(1, "outer", None, (0, 100), (10, 90))
    inner = _span(2, "inner", 1, (20, 40), (30, 50))
    late = _span(3, "late", 1, (60, 70), (60, 80))
    device = [
        ("a", 12, 20),    # outer only
        ("b", 30, 45),    # inner and outer: inner
        ("c", 50, 55),    # inner's end is inclusive
        ("d", 51, 52),    # after inner: outer
        ("e", 79, 85),    # late, though it runs past late's end
        ("f", 95, 99),    # no span: unattributed
        ("g", 5, 8),      # before every span: unattributed
        ("h", 200, 210),  # outside the window: left out
    ]
    got = spans.attribute(device, [late, outer, inner], (0, 150))
    assert got == {1: 8 + 1, 2: 15 + 5, 3: 6, None: 4 + 3}


def test_spans_without_device_times_hold_nothing():
    host_only = _span(1, "x", None, (0, 100))
    assert spans.attribute([("a", 10, 20)], [host_only], (0, 100)) == {None: 10}


def test_gaps_are_the_window_minus_busy():
    assert spans.gaps([[10, 20], [30, 35]], (0, 50)) == [(0, 10), (20, 30), (35, 50)]
    assert spans.gaps([[0, 50]], (0, 50)) == []


def test_idle_split_by_innermost_host_span_and_none():
    outer = _span(1, "outer", None, (10, 80))
    inner = _span(2, "inner", 1, (20, 40))
    other = _span(3, "other", None, (90, 95))
    seg = spans.host_segments([outer, inner, other], (0, 100))
    assert seg == [(0, 10, "none"), (10, 20, "outer"), (20, 40, "inner"), (40, 80, "outer"),
                   (80, 90, "none"), (90, 95, "other"), (95, 100, "none")]
    idle = [(5, 25), (35, 45), (85, 100)]
    assert spans.idle_by_span(idle, seg) == {"none": 5 + 5 + 5, "outer": 10 + 5, "inner": 5 + 5, "other": 5}


def test_idle_split_across_threads_goes_to_the_latest_open_span():
    a = _span(1, "a", None, (0, 60))
    b = _span(2, "b", None, (20, 40))    # another thread's span, opened later
    assert spans.idle_by_span([(0, 60)], spans.host_segments([a, b], (0, 60))) == {"a": 40, "b": 20}


def _run(device, program, views=2, window=(0, 1000)):
    return types.SimpleNamespace(trace=Trace(device=device, window=window), counts={"images": views}), program


def test_readers(monkeypatch):
    ext = _span(1, "features.extract", None, (0, 1000), (0, 1000))
    chunk = _span(2, "features.chunk", 1, (0, 900), (0, 900))
    up = _span(3, "features.upload", 2, (0, 100), (0, 100), h2d_bytes=4_000_000)
    pyr = _span(4, "sift.pyramid", 2, (100, 400), (100, 400))
    const = _span(5, "sift.pyramid.constants", 4, (100, 300), (100, 300), h2d_bytes=2_000_000)
    det = _span(6, "sift.detect", 2, (400, 500), (400, 500))
    ori = _span(7, "sift.orientation", 2, (500, 600), (500, 600))
    desc = _span(8, "sift.descriptors", 2, (600, 700), (600, 700))
    dconst = _span(9, "sift.descriptors.constants", 8, (600, 650), (600, 650), h2d_bytes=10_000)
    down = _span(10, "features.download", 2, (700, 800), (700, 800), d2h_bytes=64)
    program = [ext, chunk, up, pyr, const, det, ori, desc, dconst, down]
    device = [("up", 50, 100), ("blur", 250, 300), ("grad", 350, 400), ("k1", 400, 450), ("ori", 500, 560),
              ("tab", 620, 630), ("desc", 660, 700), ("Memcpy DtoH", 700, 750), ("stray", 950, 960)]
    run, program = _run(device, program)
    monkeypatch.setattr(spans, "program_spans", lambda: program)
    read = {n: harness.reader(n)(run) for n in (
        "sift.pyramid.device_ms_per_image", "sift.detect.device_ms_per_image",
        "sift.orientation.device_ms_per_image", "sift.descriptors.device_ms_per_image",
        "device_idle_pct.features.upload", "device_idle_pct.features.constants",
        "device_idle_pct.features.download", "features.h2d_mb_per_image")}
    ms = 1e-6 / 2
    assert read["sift.pyramid.device_ms_per_image"] == pytest.approx((50 + 50) * ms)
    assert read["sift.detect.device_ms_per_image"] == pytest.approx(50 * ms)
    assert read["sift.orientation.device_ms_per_image"] == pytest.approx(60 * ms)
    assert read["sift.descriptors.device_ms_per_image"] == pytest.approx((10 + 40) * ms)
    # idle: upload 0-50; constants 100-250, 600-620 and 630-650; download
    # 750-800 (the window is 1000 ns)
    assert read["device_idle_pct.features.upload"] == pytest.approx(5.0)
    assert read["device_idle_pct.features.constants"] == pytest.approx(15.0 + 2.0 + 2.0)
    assert read["device_idle_pct.features.download"] == pytest.approx(5.0)
    assert read["features.h2d_mb_per_image"] == pytest.approx(6.01 / 2)
    split = spans.split(run)
    assert None not in split.device_ns and split.device_ns[1] == 10   # "stray": the call's own
    total_idle = 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
    assert sum(split.idle_ns.values()) == pytest.approx(total_idle * 10)   # ns of a 1000 ns window


def test_readers_without_spans_or_trace(monkeypatch):
    run, _ = _run([("a", 0, 10)], [])
    monkeypatch.setattr(spans, "program_spans", lambda: None)     # a program older than its spans
    assert harness.reader("sift.detect.device_ms_per_image")(run) is None
    assert harness.reader("features.h2d_mb_per_image")(run) is None
    run2, _ = _run([("a", 0, 10)], [])
    monkeypatch.setattr(spans, "program_spans", lambda: [])
    assert harness.reader("device_idle_pct.features.upload")(run2) is None
    run2.trace = None
    assert harness.reader("sift.pyramid.device_ms_per_image")(run2) is None


COPY = "Memcpy DtoH (Device -> Pageable)"


def _downloads():
    """Two downloads and a span between them. Device times count from the
    session's first event; the trace's clock is 1101 ns ahead of them at the
    first download and 5301 - 4000 = 1301 ns at the second. The host's clock
    is 100 ns behind the trace at the first download's end (its end event at
    200 + 1111 on the trace's clock) and 300 ns at the second's. Each
    download makes three copies."""
    d1 = _span(1, "features.download", None, (1000, 1211), (0, 200), d2h_bytes=8)
    d2 = _span(2, "features.download", None, (5000, 5201), (4000, 4200), d2h_bytes=8)
    mid = _span(3, "sift.detect", None, (3000, 3100), (2000, 2100))
    device = [(COPY, t, t + 20) for t in (1101, 1130, 1160, 5301, 5330, 5360)] + [("k", 3250, 3260)]
    return [mid, d2, d1], device


def test_copies_split_into_runs_at_the_largest_gaps():
    _, device = _downloads()
    assert spans.copy_runs(device, 2) == [[(1101, 1121), (1130, 1150), (1160, 1180)],
                                          [(5301, 5321), (5330, 5350), (5360, 5380)]]
    assert spans.copy_runs(device, 7) is None and spans.copy_runs(device, 0) is None


def test_align_puts_device_and_host_times_on_the_trace_clock():
    program, device = _downloads()
    moved = {s.id: s for s in spans.align(device, program)}
    assert moved[1].device_ns == (1101, 200 + 1101 + 200 * 200 / 4000)
    assert moved[2].device_ns == (5301, 5501)                      # constant past the last landmark
    assert moved[3].device_ns == pytest.approx((3201, 2100 + 1101 + 200 * 2100 / 4000))
    # host: each download's end is its end event's time on the trace's clock
    assert moved[1].host_ns == pytest.approx((1000 + 100, 1211 + 100)) and moved[1].host_ns[1] == moved[1].device_ns[1]
    assert moved[2].host_ns == pytest.approx((5000 + 100 + 200 * 3789 / 3990, 5201 + 300))
    assert moved[3].host_ns == pytest.approx((3000 + 100 + 200 * 1789 / 3990, 3100 + 100 + 200 * 1889 / 3990))
    assert spans.attribute(device, list(moved.values()), (0, 10000))[3] == 10     # "k" on the trace's clock
    assert spans.attribute(device, program, (0, 10000)).get(3) is None            # missed without the shift


def test_align_refuses_what_the_landmarks_cannot_hold():
    program, device = _downloads()
    assert spans.align(device[:2], program) is None                # fewer copies than downloads
    no_downloads = [s for s in program if s.name != "features.download"]
    assert spans.align(device, no_downloads) is None               # nothing to pair
    late = device[:2] + [(COPY, 1160, 1400)] + device[3:]         # a copy ends after its download
    assert spans.align(late, program) is None
    stray = device + [(COPY, 3000, 3010)]                          # another copy enters: runs mispaired
    assert spans.align(stray, program) is None


def test_split_is_none_when_too_much_is_unattributed(monkeypatch):
    program, device = _downloads()
    busy = [("k", 3220, 3300)]                                     # inside the mid span
    run, _ = _run(device + busy, program, window=(0, 10000))
    monkeypatch.setattr(spans, "program_spans", lambda: program)
    assert spans._split(run) is not None
    run2, _ = _run(device + busy + [("stray", 9000, 9004)], program, window=(0, 10000))
    assert spans._split(run2) is not None                          # 4 of 214 ns: under 2%
    run3, _ = _run(device + busy + [("stray", 9000, 9010)], program, window=(0, 10000))
    assert spans._split(run3) is None                              # 10 of 220 ns: over 2%
