"""Host spans of the harness's own calls, and the reduction of a
``torch.profiler`` trace to device busy time, device ops and idle gaps.

A span is a named interval on the host clock around a call into one of the
port's layers (the plan, the compile, a job's ``run``, its synchronize).
Each span is also a ``record_function`` range, so a profiled stretch shows
it beside the device's ops, and an idle gap on the device is labelled by
what the host was doing when the gap ended.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

#: the prefix of every span the harness records
PREFIX = "portbench."


class Spans:
    """Host-clock spans: ``with spans("plan"): ...``.  ``seconds(name)`` is
    the total time of the spans of that name."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(PREFIX + name):
            try:
                yield
            finally:
                self.records.append((name, t0, time.perf_counter()))

    def seconds(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n == name)


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int
    device: bool


@dataclasses.dataclass
class DeviceTrace:
    """The device ops of a profiled stretch of ``jobs`` whole jobs, and
    the host's ranges over it, clipped to the window's span."""

    jobs: int
    window_ns: tuple[int, int]
    device_ops: list[Event]
    host: list[Event]

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device ops' intervals inside the window."""
        lo, hi = self.window_ns
        spans = sorted((max(e.start_ns, lo), min(e.end_ns, hi))
                       for e in self.device_ops)
        out: list[list[int]] = []
        for a, b in spans:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def device_s(self) -> float:
        """The summed time of the device ops (overlaps counted twice)."""
        return sum(e.end_ns - e.start_ns for e in self.device_ops) * 1e-9

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for e in self.device_ops:
            by[e.name] = by.get(e.name, 0.0) + (e.end_ns - e.start_ns) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time inside the window, summed by what the
        host was doing when each gap ended: the innermost harness span, and
        the innermost ATen op running on the host then (else the innermost
        other range, such as the runtime call that launched one of the
        port's own kernels)."""
        lo, hi = self.window_ns
        gaps, prev = [], lo
        for a, b in self.busy_intervals():
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        spans = _Nested([e for e in self.host if e.name.startswith(PREFIX)])
        aten = _Nested([e for e in self.host if e.name.startswith("aten::")])
        other = _Nested([e for e in self.host if not e.name.startswith(
            (PREFIX, "aten::"))])
        by: dict[str, float] = {}
        for g0, g1 in gaps:
            span = spans.innermost(g1 - 1)
            op = (aten.innermost(g1 - 1, limit=256)
                  or other.innermost(g1 - 1, limit=256))
            label = "window" if span is None else span.name[len(PREFIX):]
            if op is not None:
                label += "/" + op.name
            by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-9
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class _Nested:
    """Host ranges sorted by start, to find the innermost one running at a
    time: on one thread ranges nest, so it is the latest-started range that
    has not ended yet."""

    def __init__(self, events: list[Event]):
        self.events = sorted(events, key=lambda e: e.start_ns)
        self.starts = [e.start_ns for e in self.events]

    def innermost(self, at: int, limit: int | None = None) -> Event | None:
        i = bisect.bisect_right(self.starts, at) - 1
        stop = -1 if limit is None else max(-1, i - limit)
        for j in range(i, stop, -1):
            if self.events[j].end_ns > at:
                return self.events[j]
        return None


def _events(prof) -> list[Event]:
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = int(ev.start_ns())
        out.append(Event(ev.name(), start, start + int(ev.duration_ns()),
                         str(ev.device_type()).endswith("CUDA")))
    return out


def profile_jobs(job, spans: Spans, *, min_jobs: int, min_s: float
                 ) -> DeviceTrace:
    """Run whole jobs under ``torch.profiler`` until at least ``min_jobs``
    ran and ``min_s`` seconds passed, inside one ``window`` span; the
    device's ops and the host's ranges of that span.  Raises if the trace
    holds no device op: a traced run reports no zeros."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    jobs = 0
    with torch.profiler.profile(activities=acts) as prof:
        with spans("window"):
            t0 = time.perf_counter()
            while jobs < min_jobs or time.perf_counter() - t0 < min_s:
                job()
                jobs += 1
    events = _events(prof)
    win = [e for e in events if e.name == PREFIX + "window" and not e.device]
    if len(win) != 1:
        raise RuntimeError(f"the profiler recorded {len(win)} window spans")
    lo, hi = win[0].start_ns, win[0].end_ns
    # a span also shows on the device's timeline, under its own name
    dev = [e for e in events if e.device and not e.name.startswith(PREFIX)
           and e.end_ns > lo and e.start_ns < hi]
    if not dev:
        raise RuntimeError("the profiler recorded no device op in the traced "
                           "window")
    host = [e for e in events if not e.device and e.end_ns > lo
            and e.start_ns < hi and e.name != PREFIX + "window"]
    return DeviceTrace(jobs=jobs, window_ns=(lo, hi), device_ops=dev,
                       host=host)
