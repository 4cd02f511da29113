"""The program's spans against a traced run: device time by span and idle
time by what the host was doing.

The program records its spans while a profiler session is recording
(`sfm_tpu_torch.utils.logging.spans`, read after the window), each with its
host interval and, on the card, its device interval. Two rules:

- device events: an event of `run.trace.device` that starts inside the
  window belongs to the innermost span whose device interval contains the
  event's start (of the spans that contain it, the one that started last);
  an event that no span contains is unattributed (key None);
- idle gaps: the window minus the union of the device events, as
  `Trace.idle_gaps` has it. Each instant of a gap goes to the innermost span
  open on the host at that instant (of the open spans, the one that started
  last), or to "none" when no span is open.

The trace's clock is neither of the program's: its device times drift from
the host's clock by up to a few hundred microseconds over a window, with
steps where the profiler recalibrates (H100, 700 W: 575 us over 4.2 s, then
a step back), and the spans' device times count from the session's first
event on the device's own timer. So both are put on the trace's clock by
landmarks that all three see: the spans carrying `d2h_bytes` (the feature
stage's downloads). The k-th such span is paired with the k-th run of the
trace's "Memcpy DtoH" copies (the runs split at the largest gaps between
copies). Its device start is the run's first copy start (the span's start
event runs right before its first copy); its host end is the device time
of its end event (the copies leave the device idle, so the end event runs
as soon as it is recorded, just before the host's clock is read). Each
offset is interpolated linearly between landmarks. Where no landmark forms,
or a run of copies does not lie inside its span once moved, or more than 2%
of the window's device time falls in no span, the split is None: a reading
the landmarks cannot hold is left out rather than printed.

A program without spans (one older than them) gives None, and so does an
untraced run: the readers then leave their metric out.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
from dataclasses import dataclass


@dataclass
class Split:
    spans: dict        # span id -> span, the spans that began in the window
    device_ns: dict    # span id (None: unattributed) -> device ns of the events it holds
    idle_ns: dict      # span name ("none": no span open) -> idle ns
    window_ns: int
    views: int

    def chain(self, sid) -> list:
        """The names of the span and of its ancestors in the window."""
        names = []
        while sid in self.spans:
            names.append(self.spans[sid].name)
            sid = self.spans[sid].parent
        return names

    def device_ms_per_image(self, name: str) -> float:
        """Device ms a view of the events held by spans of this name or by
        their descendants."""
        ns = sum(v for sid, v in self.device_ns.items() if sid is not None and name in self.chain(sid))
        return ns * 1e-6 / self.views

    def idle_pct(self, match) -> float:
        """Idle share of the window, in %, while the innermost host span's
        name satisfies match(name)."""
        return 100.0 * sum(v for k, v in self.idle_ns.items() if match(k)) / self.window_ns

    def bytes_per_image(self, attr: str) -> float:
        return sum(s.attrs.get(attr, 0) for s in self.spans.values()) / self.views


def copy_runs(device: list, n: int) -> list | None:
    """The trace's DtoH copies as (start, end), split into n runs at the n - 1
    largest gaps between copies; None with fewer than n copies."""
    copies = sorted((start, end) for name, start, end in device if "DtoH" in name)
    if n < 1 or len(copies) < n:
        return None
    cuts = sorted(sorted(range(1, len(copies)), key=lambda i: copies[i][0] - copies[i - 1][0])[len(copies) - n:])
    return [copies[a:b] for a, b in zip([0, *cuts], [*cuts, len(copies)])]


def offset_map(xs: list, ys: list):
    """x -> x plus the offset ys[i] - xs[i], linear between the xs (sorted)
    and constant beyond the first and last."""
    offs = [y - x for x, y in zip(xs, ys)]

    def shift(x: float) -> float:
        i = bisect.bisect_right(xs, x)
        if i == 0 or i == len(xs) or xs[i] == xs[i - 1]:
            return x + offs[min(i, len(xs) - 1)]
        f = (x - xs[i - 1]) / (xs[i] - xs[i - 1])
        return x + offs[i - 1] + f * (offs[i] - offs[i - 1])

    return shift


def align(device: list, spans: list) -> list | None:
    """The spans with their host and device times on the trace's clock, or
    None where the landmarks do not hold (see the module's text)."""
    downs = sorted((s for s in spans if s.device_ns is not None and "d2h_bytes" in s.attrs),
                   key=lambda s: s.device_ns[0])
    runs = copy_runs(device, len(downs))
    if runs is None:
        return None
    dev = offset_map([s.device_ns[0] for s in downs], [run[0][0] for run in runs])
    if any(run[-1][1] > dev(s.device_ns[1]) for s, run in zip(downs, runs)):
        return None
    host = offset_map([s.host_ns[1] for s in downs], [dev(s.device_ns[1]) for s in downs])
    return [dataclasses.replace(s, host_ns=tuple(map(host, s.host_ns)),
                                device_ns=None if s.device_ns is None else tuple(map(dev, s.device_ns)))
            for s in spans]


def attribute(device: list, spans: list, window: tuple) -> dict:
    """Device ns by innermost span id (None: no span contains the event's
    start). device: (name, start_ns, end_ns); spans with device_ns."""
    lo, hi = window
    timed = sorted((s for s in spans if s.device_ns is not None), key=lambda s: s.device_ns[0])
    out, heap, i = {}, [], 0
    for _, start, end in sorted(device, key=lambda d: d[1]):
        if not lo <= start <= hi:
            continue
        while i < len(timed) and timed[i].device_ns[0] <= start:
            heapq.heappush(heap, (-timed[i].device_ns[0], -i, timed[i]))
            i += 1
        while heap and heap[0][2].device_ns[1] < start:   # ended: contains no later event either
            heapq.heappop(heap)
        key = heap[0][2].id if heap else None
        out[key] = out.get(key, 0) + (end - start)
    return out


def gaps(busy: list, window: tuple) -> list:
    """The window minus the merged busy intervals [[start, end], ...]."""
    out, t = [], window[0]
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def host_segments(spans: list, window: tuple) -> list:
    """(start, end, name) pieces of the window, each under one innermost open
    host span ("none" where no span is open)."""
    lo, hi = window
    bounds = sorted({lo, hi, *(t for s in spans for t in s.host_ns if lo < t < hi)})
    by_start = sorted(spans, key=lambda s: s.host_ns[0])
    out, heap, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(by_start) and by_start[i].host_ns[0] <= a:
            heapq.heappush(heap, (-by_start[i].host_ns[0], -i, by_start[i]))
            i += 1
        while heap and heap[0][2].host_ns[1] <= a:
            heapq.heappop(heap)
        out.append((a, b, heap[0][2].name if heap else "none"))
    return out


def idle_by_span(idle: list, segments: list) -> dict:
    """Idle ns by span name: each gap split over the host segments it overlaps."""
    out, j = {}, 0
    for a, b in idle:
        while j < len(segments) and segments[j][1] <= a:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < b:
            s, e, name = segments[k]
            out[name] = out.get(name, 0) + (min(b, e) - max(a, s))
            k += 1
    return out


def program_spans():
    """The program's spans of the last profiler session, or None where the
    program has no span recorder."""
    try:
        from sfm_tpu_torch.utils.logging import spans
    except ImportError:
        return None
    return spans()


_MEMO: dict = {}


def split(run) -> Split | None:
    """The run's split, computed once (every reader asks for it)."""
    key = id(run)
    if key not in _MEMO:
        _MEMO.clear()
        _MEMO[key] = (run, _split(run))
    return _MEMO[key][1]


def _split(run) -> Split | None:
    views = run.counts.get("images")
    if run.trace is None or not run.trace.device or not views or run.trace.window_s <= 0:
        return None
    spans = program_spans()
    if not spans:
        return None
    lo, hi = window = run.trace.window
    inside = [s for s in spans if lo <= s.host_ns[0] <= hi]
    if not inside:
        return None
    moved = align(run.trace.device, inside)
    if moved is None:
        return None
    device_ns = attribute(run.trace.device, moved, window)
    if device_ns.get(None, 0) > 0.02 * sum(device_ns.values()):
        return None
    return Split(spans={s.id: s for s in moved}, device_ns=device_ns,
                 idle_ns=idle_by_span(gaps(run.trace.busy_intervals(), window), host_segments(moved, window)),
                 window_ns=hi - lo, views=views)
