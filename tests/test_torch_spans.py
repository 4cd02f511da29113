"""The span recorder of utils/logging.py and the feature stage's spans, on
the CPU: off it is one shared object that records nothing, makes no CUDA
call and allocates nothing; under a torch.profiler session it records
names, ids, parents per thread, attributes and host times, and resolves
device times from the session's first event; the feature stage yields the
documented spans with their byte counts; StageTimer keeps its stage seconds
and opens a span, each of its profiled stages is a session of its own, and
its profile_dir trace shows the spans."""

import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from sfm_tpu_torch.config import PipelineConfig, SiftConfig
from sfm_tpu_torch.ops.sift import extract_features
from sfm_tpu_torch.pipeline import stages
from sfm_tpu_torch.pipeline.ingest import ImageBatch
from sfm_tpu_torch.utils import logging as lg

CPU = torch.device("cpu")
SIFT = SiftConfig(max_keypoints=128, max_candidates=512, desc_per_octave=64, num_octaves=2, image_max_dim=64)
PARTS = ("sift.pyramid", "sift.detect", "sift.orientation", "sift.descriptors")


def _session():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _batch(n=3, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return ImageBatch(canvases=rng.random((n, size, size), dtype=np.float32),
                      valid_hw=np.full((n, 2), size, np.int32), scales=np.ones(n, np.float32),
                      intrinsics=np.zeros((n, 6), np.float32), names=[f"v{i}" for i in range(n)])


def test_off_is_one_shared_object_and_records_nothing(monkeypatch):
    with _session():
        with lg.span("before"):
            pass
    assert [s.name for s in lg.spans()] == ["before"]

    def no_cuda(*a, **k):
        raise AssertionError("a span off called CUDA")

    monkeypatch.setattr(torch.cuda, "Event", no_cuda)
    monkeypatch.setattr(torch.cuda, "synchronize", no_cuda)
    monkeypatch.setattr(torch.cuda, "is_initialized", no_cuda)
    first = lg.span("a", chunk=1)
    with first as inner:
        assert inner is first
        with lg.span("b") as nested:
            assert nested is first
    assert lg.span("c", octave=2) is first
    assert [s.name for s in lg.spans()] == ["before"]

    tracemalloc.start()
    try:
        for _ in range(100):     # warm any lazily made state
            with lg.span("warm", octave=1):
                pass
        before = tracemalloc.take_snapshot()
        for _ in range(2000):
            with lg.span("off", octave=1, h2d_bytes=8):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert [s.name for s in lg.spans()] == ["before"]
    mine = [d for d in after.compare_to(before, "filename")
            if d.traceback[0].filename == lg.__file__ and (d.size_diff or d.count_diff)]
    assert mine == []


def test_nesting_parents_attributes_and_host_times():
    with _session():
        with lg.span("outer"):
            with lg.span("chunk"):
                with lg.span("leaf", h2d_bytes=16):
                    pass
            with lg.span("sibling"):
                pass
    got = {s.name: s for s in lg.spans()}
    assert set(got) == {"outer", "chunk", "leaf", "sibling"}
    o, c, leaf, sib = got["outer"], got["chunk"], got["leaf"], got["sibling"]
    assert o.parent is None and c.parent == o.id and leaf.parent == c.id and sib.parent == o.id
    assert len({o.id, c.id, leaf.id, sib.id}) == 4
    assert leaf.attrs == {"h2d_bytes": 16} and o.attrs == c.attrs == sib.attrs == {}
    for s in got.values():
        assert s.host_ns[0] <= s.host_ns[1] and s.device_ns is None
        assert s.thread == threading.get_ident()
    assert o.host_ns[0] <= c.host_ns[0] <= leaf.host_ns[0] <= leaf.host_ns[1] <= c.host_ns[1] <= o.host_ns[1]


def test_stacks_are_per_thread():
    gate = threading.Barrier(2, timeout=30)
    ids = {}

    def work(tag):
        with lg.span(f"{tag}.outer"):
            gate.wait()             # both outer spans are open at once
            with lg.span(f"{tag}.inner"):
                gate.wait()
        ids[tag] = threading.get_ident()

    with _session():
        threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in lg.spans()}
    for tag in ("a", "b"):
        outer, inner = got[f"{tag}.outer"], got[f"{tag}.inner"]
        assert outer.parent is None and inner.parent == outer.id
        assert outer.thread == inner.thread == ids[tag]


def test_a_new_session_clears_the_buffer():
    with _session():
        with lg.span("first"):
            pass
    with lg.span("between"):       # the profiler is off: the session is over
        pass
    with _session():
        with lg.span("second"):
            pass
    assert [s.name for s in lg.spans()] == ["second"]
    assert [s.name for s in lg.spans()] == ["second"]   # reading again gives the same
    with _session():                # after a read, the next session starts afresh
        with lg.span("third"):
            pass
    assert [s.name for s in lg.spans()] == ["third"]


def test_extract_features_spans():
    imgs = torch.from_numpy(_batch(2).canvases)
    with _session():
        extract_features(imgs, SIFT, torch.full((2, 2), 64, dtype=torch.int32))
    got = lg.spans()
    names = {s.name for s in got}
    assert names == {*PARTS, "sift.pyramid.constants", "sift.descriptors.constants", "sift.detect.select"}
    # one of each part an octave, the candidate selection in a child span of
    # each octave's detection; the pyramid's build and the final selection
    # besides
    counts = {part: sum(1 for s in got if s.name == part) for part in (*PARTS, "sift.detect.select")}
    assert counts == {"sift.pyramid": 3, "sift.detect": 3, "sift.orientation": 2, "sift.descriptors": 2,
                      "sift.detect.select": 2}
    assert all(s.attrs == {} for s in got if s.name in PARTS)
    by_id = {s.id: s for s in got}
    for s in got:
        if s.name.endswith((".constants", ".select")):
            assert by_id[s.parent].name == s.name.rsplit(".", 1)[0]


def test_feature_stage_spans_and_bytes():
    batch = _batch(11)                  # chunks of 8 and 3
    cfg = PipelineConfig(sift=SIFT, verbose=False)
    with _session():
        feats = stages.extract_stage(batch, cfg, CPU)
    got = lg.spans()
    by_id = {s.id: s for s in got}
    (call,) = [s for s in got if s.name == "features.extract"]
    chunks = sorted((s for s in got if s.name == "features.chunk"), key=lambda s: s.host_ns[0])
    assert len(chunks) == 2 and all(c.parent == call.id for c in chunks)
    for c, (lo, hi) in zip(chunks, ((0, 8), (8, 11))):
        kids = [s for s in got if s.parent == c.id]
        assert [s.name for s in kids if s.name.startswith("features.")] == ["features.upload", "features.download"]
        (up,) = [s for s in kids if s.name == "features.upload"]
        assert up.attrs["h2d_bytes"] == batch.canvases[lo:hi].nbytes + batch.valid_hw[lo:hi].nbytes
        (down,) = [s for s in kids if s.name == "features.download"]
        assert down.attrs["d2h_bytes"] == sum(a[lo:hi].nbytes for a in
                                              (feats.xy, feats.sigma, feats.angle, feats.response,
                                               feats.desc, feats.valid))
        under = [s for s in got if s.name == "sift.pyramid.constants" and by_id[by_id[s.parent].parent].id == c.id]
        sizes = [64 * 64, 32 * 32]
        assert [s.attrs["h2d_bytes"] for s in under] == [(SIFT.scales_per_octave + 3) * n * 4 for n in sizes]
        for s in (s for s in got if s.name == "sift.descriptors.constants"):
            assert s.attrs["h2d_bytes"] == 16 * 16 * (2 + 1 + 16) * 4


def test_stage_timer_keeps_its_seconds_and_opens_a_span():
    timer = lg.StageTimer(verbose=False)
    with _session():
        with timer.stage("features"):
            with lg.span("inside"):
                pass
    assert set(timer.durations) == {"features"} and timer.durations["features"] >= 0.0
    got = {s.name: s for s in lg.spans()}
    assert got["inside"].parent == got["features"].id
    with timer.stage("features"):    # off: still timed
        pass
    assert timer.durations["features"] >= 0.0 and len(timer.durations) == 1


def test_stage_timer_profiles_each_stage_as_a_session(tmp_path):
    timer = lg.StageTimer(verbose=False, profile_dir=str(tmp_path))
    with timer.stage("features"):
        with lg.span("first"):
            pass
    with timer.stage("matching"):        # no span runs between the two profilers
        with lg.span("second"):
            pass
    got = {s.name: s for s in lg.spans()}
    assert set(got) == {"matching", "second"} and got["second"].parent == got["matching"].id
    assert set(timer.durations) == {"features", "matching"}


class _FakeEvent:
    """A CUDA timing event on a made-up device timer: each record reads the
    next tick of 0.25 ms."""

    ticks = iter(range(10**6))

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None

    def record(self, stream=None):
        self.t = 0.25 * next(self.ticks)

    def elapsed_time(self, other):
        return other.t - self.t


def test_device_times_count_from_the_sessions_first_event(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    with _session():
        with lg.span("outer"):           # events at ticks 0 and 3
            with lg.span("inner"):       # ticks 1 and 2
                assert synced == []      # nothing waits for the device inside the session
    got = {s.name: s for s in lg.spans()}
    assert synced == [0]
    assert got["outer"].device_ns == (0.0, 0.75e6) and got["inner"].device_ns == (0.25e6, 0.5e6)
    with _session():                     # a new session: a new origin
        with lg.span("later"):
            pass
    (later,) = lg.spans()
    assert later.device_ns == (0.0, 0.25e6)


def test_stage_timer_profile_dir_trace_shows_spans(tmp_path):
    timer = lg.StageTimer(verbose=False, profile_dir=str(tmp_path))
    imgs = torch.from_numpy(_batch(1).canvases)
    with timer.stage("features"):
        extract_features(imgs, SIFT)
    trace = json.loads((tmp_path / "features.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"features", "sift.descriptors", "sift.pyramid.constants"} <= names
    assert "features" in timer.durations


@pytest.fixture(autouse=True)
def _fresh_session():
    """Each test starts with no session of an earlier one pending."""
    lg.spans()
    yield
    lg.spans()
