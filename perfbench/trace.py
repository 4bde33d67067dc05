"""Host spans and the device trace of a run.

``Spans`` records the benchmark's own host spans (``search``, ``submit``,
``pump``, ``readback``, ...) around its calls into the program: their
durations on the host clock always, and, in a traced run, as
``torch.profiler.record_function`` ranges in the profiler's trace, on the
clock of the device events. ``read_trace`` turns the profiler's events
into device intervals and host ranges; ``busy`` merges device intervals;
``breakdown`` gives the device operations that took most time and the
longest idle gaps, each named by the innermost host span over it.
"""
from __future__ import annotations

import bisect
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

WINDOW = "window"


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.durations: dict = {}

    @contextmanager
    def span(self, name: str):
        rf = nullcontext()
        if self.traced:
            from torch.profiler import record_function
            rf = record_function(name)
        t0 = time.perf_counter()
        with rf:
            yield
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.durations.setdefault(name, []).append(seconds)


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_ns, end_ns)
    host: list = field(default_factory=list)     # (name, start_ns, end_ns)
    window: tuple = (0, 0)                       # ns


def _ns(e, what: str) -> int:
    f = getattr(e, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, what + "_us")() * 1000)


def read_trace(prof, span_names) -> Trace:
    """Device operations (kernels, copies, sets) and the benchmark's host
    spans of a finished ``torch.profiler.profile``."""
    names = set(span_names) | {WINDOW}
    out = Trace()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        dev = str(e.device_type()).endswith("CUDA")
        start = _ns(e, "start")
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") else \
            int(e.duration_us() * 1000)
        if dev:
            if name in names or getattr(e, "is_user_annotation",
                                        lambda: False)():
                continue
            out.device.append((name, start, start + dur))
        elif name in names:
            out.host.append((name, start, start + dur))
    win = [h for h in out.host if h[0] == WINDOW]
    if win:
        out.window = (win[0][1], win[0][2])
    return out


def merged(intervals, lo: int, hi: int) -> list:
    """Device intervals clipped to [lo, hi] and merged: [(start, end)]."""
    iv = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                if e > lo and s < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_s(tr: Trace) -> float:
    lo, hi = tr.window
    return sum(e - s for s, e in merged(tr.device, lo, hi)) / 1e9


def kernel_s(tr: Trace, patterns) -> float:
    """Seconds of the device operations whose names hold one of
    ``patterns``, within the window."""
    lo, hi = tr.window
    return sum(min(e, hi) - max(s, lo) for n, s, e in tr.device
               if e > lo and s < hi and any(p in n for p in patterns)) / 1e9


def gaps(tr: Trace) -> list:
    """Idle gaps of the device in the window: [(name, seconds)], longest
    first, each named by the innermost host span over its midpoint
    (``loop`` where only the window is)."""
    lo, hi = tr.window
    edges, t = [], lo
    for s, e in merged(tr.device, lo, hi):
        if s > t:
            edges.append((t, s))
        t = max(t, e)
    if hi > t:
        edges.append((t, hi))
    host = sorted(h for h in tr.host if h[0] != WINDOW)
    starts = [h[1] for h in host]
    out = []
    for s, e in edges:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = "loop"
        # spans of one thread nest: the latest started one over the
        # midpoint is the innermost
        for j in range(i, max(i - 8, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        out.append((name, (e - s) / 1e9))
    return sorted(out, key=lambda x: -x[1])


def breakdown(tr: Trace, n: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, with all their digits."""
    lo, hi = tr.window
    by = {}
    for name, s, e in tr.device:
        if e > lo and s < hi:
            by[name] = by.get(name, 0.0) + (min(e, hi) - max(s, lo)) / 1e9
    ops = sorted(by.items(), key=lambda x: -x[1])[:n]
    return {"device_ops": [[k[:200], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps(tr)[:n]]}


def idle_by_span(tr: Trace) -> dict:
    """Idle seconds of the window summed by the host span over them."""
    out = {}
    for name, s in gaps(tr):
        out[name] = out.get(name, 0.0) + s
    return out
