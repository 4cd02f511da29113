"""Reduction of a torch.profiler trace of the measured window to what the
per-layer readers take: the device's events (kernels, copies, fills), the
time the device was busy inside the window, and the breakdown line of the
result.

Only the device's activity is traced: recording every host op as well
slowed the host-paced cells by a quarter to a third and so inflated the
idle share it was to measure. The window's bounds are read from the host's
system clock, the clock the profiler's timestamps are on; an idle gap is
named by the device op that ended it (what the host was preparing)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_ns, end_ns), by start
    window: tuple = (0, 0)                      # (start_ns, end_ns) of the window
    marks: list = field(default_factory=list)

    def mark(self) -> None:
        """Called at the window's start and at its end."""
        self.marks.append(time.time_ns())

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the device events' intervals inside the window."""
        lo, hi = self.window
        merged = []
        for _, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, match) -> float:
        """Device seconds of the events whose name satisfies match(name)."""
        return sum(e - s for name, s, e in self.device if match(name)) * 1e-9

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0) + (e - s)
        return [[name[:120], ns * 1e-9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time inside the window, summed by the device op that
        ended each gap ("end of window" for the last)."""
        lo, hi = self.window
        by, t = {}, lo
        for name, s, e in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if s > t:
                key = f"before {name[:100]}"
                by[key] = by.get(key, 0) + (s - t)
            t = max(t, e)
        if hi > t:
            by["end of window"] = by.get("end of window", 0) + (hi - t)
        return [[k, ns * 1e-9] for k, ns in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


@contextlib.contextmanager
def profiled():
    """Trace the device inside the block. Yields a Trace whose `mark()`
    the block calls at the window's start and end; filled on exit."""
    import torch

    tr = Trace()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        yield tr
    if len(tr.marks) != 2:
        raise RuntimeError("trace: the window was not marked at its start and end")
    tr.window = tuple(tr.marks)
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and not _annotation(ev):
            s = ev.start_ns()
            tr.device.append((ev.name(), s, s + ev.duration_ns()))
    tr.device.sort(key=lambda d: d[1])


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False
