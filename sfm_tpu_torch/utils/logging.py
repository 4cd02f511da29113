"""Observability: stage timers and spans (port of sfm_tpu/utils/logging.py).

Each stage records its wall-clock duration into a manifest dict. PyTorch
returns before the GPU finishes, so on a CUDA device the timer synchronises
before reading the clock at both ends of a stage. With ``profile_dir`` each
stage is traced with ``torch.profiler`` and written as a Chrome trace.

Spans mark the parts of the work below a stage (``span(name, **attrs)``).
They are recorded only while a ``torch.profiler`` session is recording;
otherwise ``span`` returns one shared object that does nothing. A recorded
span keeps its name, id, parent (per thread), thread, attributes, the host's
``time.time_ns()`` at its start and end and, once CUDA is in use, where the
current stream reached its start and end: two timing events, resolved when
``spans()`` is read after the session (never inside it) as ns since the
session's first event on that device. The device times are thus on the
device's own timer; a reader that needs them on another clock sets the
offset from landmarks it sees on both. While on, a span also opens
``torch.profiler.record_function(name)``, so a profiler's own trace shows
it.

A session is over once a span finds the profiler off, ``spans()`` is read
or a StageTimer opens its profiler; the first span recorded after that
clears the spans before it. The recorder is one per process, as the
profiler is.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass

import torch
import torch.autograd.profiler as _profiler

@dataclass
class Span:
    """A finished span. host_ns is on ``time.time_ns()``'s clock; device_ns
    is ns since the session's first event on the device, None for a span
    that recorded no CUDA event."""

    name: str
    id: int
    parent: int | None
    thread: int
    attrs: dict
    host_ns: tuple[int, int]
    device_ns: tuple[float, float] | None = None


class _Off:
    """What ``span`` returns while no profiler session is recording."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


class _Stack(threading.local):
    def __init__(self):
        self.open: list = []       # this thread's open spans, innermost last


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.live = False          # a session's spans are being recorded
        self.ids = itertools.count(1)
        self.stack = _Stack()
        self.done: list = []       # (Span, start event, end event, device index) of this session
        self.origins: dict = {}    # device index -> the session's first event on it
        self.resolved: list | None = None

    def begin_session(self):
        with self.lock:
            if not self.live:
                self.done, self.origins, self.resolved, self.live = [], {}, None, True

    def event(self, device: int):
        """A timing event recorded now on the device's current stream."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        if device not in self.origins:
            with self.lock:
                self.origins.setdefault(device, ev)
        return ev

    def read(self) -> list:
        with self.lock:
            self.live = False
            if self.resolved is None:
                for d in self.origins:
                    torch.cuda.synchronize(d)
                out = []
                for s, e0, e1, d in self.done:
                    if e0 is not None:
                        origin = self.origins[d]
                        s.device_ns = (origin.elapsed_time(e0) * 1e6, origin.elapsed_time(e1) * 1e6)
                    out.append(s)
                self.resolved = out
            return list(self.resolved)


_REC = _Recorder()


class _Live:
    __slots__ = ("name", "attrs", "span", "record", "ev0", "device")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = _REC
        if not rec.live:
            rec.begin_session()
        stack = rec.stack.open
        parent = stack[-1].span if stack else None
        self.span = Span(self.name, next(rec.ids), parent.id if parent is not None else None,
                         threading.get_ident(), self.attrs, (0, 0))
        stack.append(self)
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.device, self.ev0 = None, None
        if torch.cuda.is_initialized():
            self.device = torch.cuda.current_device()
            self.ev0 = rec.event(self.device)
        self.span.host_ns = (time.time_ns(), 0)
        return self

    def __exit__(self, typ, value, tb):
        rec = _REC
        ev1 = rec.event(self.device) if self.ev0 is not None else None
        self.span.host_ns = (self.span.host_ns[0], time.time_ns())
        self.record.__exit__(typ, value, tb)
        rec.stack.open.pop()
        rec.done.append((self.span, self.ev0, ev1, self.device))
        return False


def span(name: str, **attrs):
    """Context manager marking a part of the work; see the module's text."""
    # Process-wide (torch's own fast check), so threads' spans record too;
    # torch._C._autograd._profiler_enabled() reads False on other threads.
    if not _profiler._is_profiler_enabled:
        _REC.live = False
        return _OFF
    return _Live(name, attrs)


def spans() -> list[Span]:
    """The last session's spans, finished ones only, in the order they
    ended, with their device times resolved. Read it after the session."""
    return _REC.read()


class StageTimer:
    def __init__(self, verbose: bool = True, profile_dir: str | None = None,
                 device: torch.device | str = "cpu"):
        self.verbose = verbose
        self.profile_dir = profile_dir
        self.device = torch.device(device)
        self.durations: dict[str, float] = {}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        prof = None
        if self.profile_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            _REC.live = False      # its profiler starts a session of its own
        self._sync()
        t0 = time.perf_counter()
        with prof if prof is not None else contextlib.nullcontext(), span(name):
            yield
            self._sync()
        dt = time.perf_counter() - t0
        if prof is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.profile_dir, f"{name}.json"))
        self.durations[name] = self.durations.get(name, 0.0) + dt
        if self.verbose:
            print(f"[sfm_tpu_torch] stage {name}: {dt:.2f}s")

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.durations, f, indent=2)
