"""The port's spans and counters: where a job's time and work go.

``span(name)`` marks a stretch of the program (the plan, a chunk's map,
its fold), ``job()`` the outermost call of one job, and ``count(name, n)``
adds ``n`` to a counter.  ``recording()`` turns the recorder on for a
stretch of the program and yields a :class:`Recording`.

Off, the default, a span is one read of a module flag that returns a
shared null context: nothing is recorded and no profiler range opened.
Counters are process totals and always counted (one dict add); the
kernels' launch counts (``kernels/_build.py``) are counters of this
registry.

On, each span keeps one :class:`Record` in memory (its name, id, parent
span, the job it belongs to, its start and end, and the counters added
while it was open, its children's included) and opens a profiler range
``repro_torch.<name>`` (a ``record_function`` range, in its light form
``_RecordFunctionFast``), so that a profiled stretch shows it beside the
device's ops.  The stamps are Unix nanoseconds (``time.time_ns``), the
clock to which kineto converts the host's and the device's events, taken
inside the range, so that a record and its range agree to a microsecond
or so.  The recorder never synchronizes the device.

A stream run whose chunk loop is captured as a CUDA graph
(``core/engine.py``, :class:`~repro_torch.core.engine.CapturedLoop`) runs
its Python once, in the ``graph.capture`` span, which records the eager
loop's spans and counts (``init``, ``chunk``, ``map``, ``premap``,
``fold``) but launches nothing: the graph runs in a ``graph.replay`` span
after it, and in one in each later job.  So the device ops of a captured
or replayed job fall under ``graph.replay``, not under ``chunk``, ``map``
or ``fold``: a by-span device split (``portbench/program.py``) shows that
split on an eager job only (a first run of an item count, or a run the
loop cannot be captured in).  What the capture counted (:func:`tally`) is
added again on each later replay (:func:`credit`), so the counters of
every job are the eager loop's.
The capture's own counters: ``loop_captures``, ``loop_replays``,
``loop_fallbacks`` (a capture that raised, after which the run is eager)
and ``graph_pool_bytes`` (the bytes ``torch.cuda.memory_reserved`` grew by
over each capture: its graph's memory pool, summed over captures).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time

from torch._C import _profiler

#: the prefix of every span's profiler range
PREFIX = "repro_torch."

_totals: collections.Counter = collections.Counter()
_keyed: collections.defaultdict = collections.defaultdict(collections.Counter)
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
#: the open spans of each thread, innermost last
_local = threading.local()
#: the recording in progress, None while the recorder is off
_recording: Recording | None = None


@dataclasses.dataclass
class Record:
    """One closed span: ``job`` is the id of the job span it lies in
    (None outside a job); stamps are Unix nanoseconds."""

    name: str
    id: int
    parent: int | None
    job: int | None
    start_ns: int
    end_ns: int
    counters: dict[str, int]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Recording:
    """The spans closed, and the counts added, while the recorder was on,
    in the order they closed."""

    records: list[Record] = dataclasses.field(default_factory=list)
    counters: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def named(self, name: str) -> list[Record]:
        return [r for r in self.records if r.name == name]

    def seconds(self, name: str) -> float:
        return sum(r.seconds for r in self.named(name))


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("recording", "name", "is_job", "id", "parent", "job",
                 "start", "counters", "_range")

    def __init__(self, recording: Recording, name: str, is_job: bool):
        self.recording = recording
        self.name = name
        self.is_job = is_job

    def __enter__(self):
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.job = self.id if self.is_job else (
            None if outer is None else outer.job)
        self.counters = collections.Counter()
        self._range = _profiler._RecordFunctionFast(PREFIX + self.name)
        self._range.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        stack = _stack()
        stack.pop()
        if stack:
            stack[-1].counters.update(self.counters)
        # a span still open when its recording ended is dropped
        if self.recording is _recording:
            self.recording.records.append(Record(
                self.name, self.id, self.parent, self.job, self.start, end,
                dict(self.counters)))
        return False


def span(name: str):
    """A context manager around one stretch of the program, recorded as
    ``name`` while the recorder is on."""
    rec = _recording
    if rec is None:
        return _NULL
    return _Span(rec, name, False)


def job():
    """The ``job`` span around one job's call; a job inside a job (a
    ``MapReduce.run`` that calls its ``Compiled``) is the outer one."""
    rec = _recording
    if rec is None:
        return _NULL
    stack = _stack()
    if any(s.is_job for s in stack):
        return _NULL
    return _Span(rec, "job", True)


def count(name: str, n: int = 1, key=None) -> None:
    """Add ``n`` to counter ``name`` (and, with ``key``, to its count by
    that key); while recording, to the recording and the innermost open
    span too."""
    _totals[name] += n
    if key is not None:
        _keyed[name][key] += n
    for t in getattr(_local, "tallies", ()):
        t[name, key] += n
    rec = _recording
    if rec is not None:
        rec.counters[name] += n
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].counters[name] += n


@contextlib.contextmanager
def tally():
    """Yield a ``Counter`` of every count this thread adds in the ``with``
    block, by ``(name, key)`` (``key`` None for a count made with none);
    other threads' counts meanwhile are not in it."""
    t: collections.Counter = collections.Counter()
    open_ = _local.__dict__.setdefault("tallies", [])
    open_.append(t)
    try:
        yield t
    finally:
        open_[:] = [u for u in open_ if u is not t]


def credit(counts: collections.Counter, sign: int = 1) -> None:
    """Count a :func:`tally` again (a replayed graph's work), or take it
    back with ``sign`` -1 (a capture that failed)."""
    for (name, key), n in counts.items():
        count(name, sign * n, key)


def total(name: str) -> int:
    """Counter ``name``'s process total since its last :func:`reset`."""
    return _totals[name]


def by_key(name: str) -> dict:
    """Counter ``name``'s process total split by the keys counted with it
    (counts made with no key are left out)."""
    return dict(_keyed[name])


def reset(names) -> None:
    """Set the process totals of ``names`` back to zero."""
    for name in names:
        _totals.pop(name, None)
        _keyed.pop(name, None)


@contextlib.contextmanager
def recording():
    """Turn the recorder on for the ``with`` block; yields the
    :class:`Recording`."""
    global _recording
    if _recording is not None:
        raise RuntimeError("the span recorder is already on")
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
