"""The program's own spans and counters (``repro_torch.spans``) read
against a profiled stretch: each device op attributed to the program span
that launched it, the device's idle gaps labelled by the program span in
which each ended, and the per-layer readings they give.

    python3 portbench/program.py --workload <cell> --seed <n>

from the root of a checkout, on the card the cell asks for, runs the
cell's set-up with the recorder on from before the plan to the warm job,
times ten jobs with the recorder off and ten with it on, then profiles
three whole jobs with it on.  Its last line is one JSON object: the six
readings below, the device time a job by program span, the idle gaps,
and the set-up by span.  It compares no result with the reference
(``run.py`` does).

The readings: ``chunks_per_job`` (the ``chunks`` counter of each job
span), ``fold_scans_per_pair`` (``fold_scans`` over ``fold_pairs``: the
times a fold reads each pair), ``fold_device_ms_per_job`` and
``map_device_ms_per_job`` (the device time of the ops launched inside
``fold``, and inside ``map`` and ``premap``), ``warmup_ms`` (the
compile's warm-up job less the kernels' build and load inside it) and
``plan_key_ms`` (the plan key's trace of the reduce).

``run.py`` turns the recorder on nowhere: it reads the two counter
readings from the program's process totals (:func:`counter_ratio`), and a
program with no ``repro_torch.spans`` gives it nothing.
"""

from __future__ import annotations

import dataclasses

#: the prefix of the program's spans (``repro_torch.spans.PREFIX``)
PROGRAM = "repro_torch."
#: the prefixes of the ranges that the profiler also shows on the
#: device's timeline (user annotations): the harness's and the program's
ANNOTATIONS = ("portbench.", PROGRAM)
#: the host events that launch device work: CUDA runtime and driver calls
LAUNCH_PREFIX = "cu"


def counter_ratio(num: str, den: str) -> float | None:
    """The program's process totals of counter ``num`` over counter
    ``den``; None where the program counts neither (it has no
    ``repro_torch.spans``) or ``den`` is 0.  Every run of a benchmark
    process folds the cell's items, so a ratio of two totals is a job's."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    d = spans.total(den)
    return spans.total(num) / d if d else None


@dataclasses.dataclass
class Event:
    """A profiler event; ``correlation`` links a device op to the runtime
    call that launched it (0 where the profiler gave none)."""

    name: str
    start_ns: int
    end_ns: int
    device: bool
    correlation: int = 0


def events(prof) -> list[Event]:
    out = []
    for ev in prof.profiler.kineto_results.events():
        start = int(ev.start_ns())
        out.append(Event(ev.name(), start, start + int(ev.duration_ns()),
                         str(ev.device_type()).endswith("CUDA"),
                         int(ev.correlation_id())))
    return out


def device_ops(evs: list[Event], lo: int, hi: int) -> list[Event]:
    """The device ops in ``[lo, hi)``: device events less the ranges of
    the harness and the program, which the profiler also shows on the
    device's timeline."""
    return [e for e in evs if e.device and not e.name.startswith(ANNOTATIONS)
            and e.end_ns > lo and e.start_ns < hi]


class _Ranges:
    """Nested ranges of one thread, to find those running at a time."""

    def __init__(self, evs: list[Event]):
        self.evs = sorted(evs, key=lambda e: e.start_ns)

    def around(self, at: int) -> list[Event]:
        """The ranges holding ``at``, outermost first."""
        return [e for e in self.evs if e.start_ns <= at < e.end_ns]

    def innermost(self, at: int) -> Event | None:
        held = self.around(at)
        return held[-1] if held else None


class Attribution:
    """Each device op of a stretch and the program span it belongs to:
    the innermost ``repro_torch.*`` host range holding the runtime call
    that launched it (matched by correlation id); failing a launch, the
    innermost ``repro_torch.*`` range of the device's timeline holding
    the op; failing both, None."""

    def __init__(self, evs: list[Event], lo: int, hi: int):
        self.ops = device_ops(evs, lo, hi)
        self.host = _Ranges([e for e in evs if not e.device
                             and e.name.startswith(PROGRAM)])
        on_device = _Ranges([e for e in evs if e.device
                             and e.name.startswith(PROGRAM)])
        launches: dict[int, Event] = {}
        for e in evs:
            if (not e.device and e.correlation
                    and e.name.startswith(LAUNCH_PREFIX)):
                launches.setdefault(e.correlation, e)
        self.spans: list[str | None] = []
        for op in self.ops:
            launch = launches.get(op.correlation) if op.correlation else None
            rng = None if launch is None else self.host.innermost(
                launch.start_ns)
            if rng is None:
                rng = on_device.innermost(op.start_ns)
            self.spans.append(None if rng is None
                              else rng.name[len(PROGRAM):])

    def device_s(self) -> dict[str | None, float]:
        """Device seconds by program span (None: no span)."""
        by: dict[str | None, float] = {}
        for op, name in zip(self.ops, self.spans):
            by[name] = by.get(name, 0.0) + (op.end_ns - op.start_ns) * 1e-9
        return by

    def path(self, at: int) -> str | None:
        """The program spans running at ``at`` inside the job, outermost
        first, joined by ``.`` (``chunk.map``); None outside every span."""
        names = [e.name[len(PROGRAM):] for e in self.host.around(at)]
        names = [n for n in names if n != "job"]
        return ".".join(names) if names else None


def idle_gaps(trace, attribution: Attribution, n: int = 10) -> list[list]:
    """``trace.idle_gaps`` with the program's spans running when each gap
    ended put between the harness span and the host op:
    ``run/chunk.map/aten::cat``."""
    from portbench import tracing

    lo, hi = trace.window_ns
    gaps, prev = [], lo
    for a, b in trace.busy_intervals():
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    harness = tracing._Nested([e for e in trace.host
                               if e.name.startswith(tracing.PREFIX)])
    aten = tracing._Nested([e for e in trace.host
                            if e.name.startswith("aten::")])
    other = tracing._Nested([e for e in trace.host
                             if not e.name.startswith(
                                 ("aten::",) + ANNOTATIONS)])
    by: dict[str, float] = {}
    for g0, g1 in gaps:
        span = harness.innermost(g1 - 1)
        label = ("window" if span is None
                 else span.name[len(tracing.PREFIX):])
        prog = attribution.path(g1 - 1)
        if prog is not None:
            label += "/" + prog
        op = (aten.innermost(g1 - 1, limit=256)
              or other.innermost(g1 - 1, limit=256))
        if op is not None:
            label += "/" + op.name
        by[label] = by.get(label, 0.0) + (g1 - g0) * 1e-9
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _inside(records, rec, ancestor_id: int) -> bool:
    """Whether record ``rec`` lies under the span ``ancestor_id``."""
    by_id = {r.id: r for r in records}
    parent = rec.parent
    while parent is not None:
        if parent == ancestor_id:
            return True
        parent = by_id[parent].parent if parent in by_id else None
    return False


def readings(setup, stretch, attribution: Attribution) -> dict:
    """The six per-layer readings of a set-up's and a profiled stretch's
    recordings (``repro_torch.spans.Recording``) and the stretch's
    attribution; a reading with nothing to read is left out."""
    out = {}
    jobs = stretch.named("job")
    if jobs:
        out["chunks_per_job"] = (sum(j.counters.get("chunks", 0)
                                     for j in jobs) / len(jobs))
        dev = attribution.device_s()
        out["fold_device_ms_per_job"] = dev.get("fold", 0.0) / len(jobs) * 1e3
        out["map_device_ms_per_job"] = ((dev.get("map", 0.0)
                                         + dev.get("premap", 0.0))
                                        / len(jobs) * 1e3)
    pairs = stretch.counters.get("fold_pairs", 0)
    if pairs:
        out["fold_scans_per_pair"] = stretch.counters["fold_scans"] / pairs
    warm = setup.named("compile.warmup")
    if warm:
        loads = sum(r.seconds for r in setup.named("kernels.load")
                    if any(_inside(setup.records, r, w.id) for w in warm))
        out["warmup_ms"] = (sum(w.seconds for w in warm) - loads) * 1e3
    if setup.named("plan.key"):
        out["plan_key_ms"] = setup.seconds("plan.key") * 1e3
    return out


def profile(job, *, jobs: int):
    """Run ``jobs`` whole jobs under ``torch.profiler`` with the recorder
    on, inside one harness ``window`` span: the stretch's recording, its
    events, and a ``tracing.DeviceTrace`` of its device ops (less the
    harness's and the program's ranges) and host ranges."""
    import torch

    from portbench import tracing
    from repro_torch import spans

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    marks = tracing.Spans()
    with torch.profiler.profile(activities=acts) as prof:
        with spans.recording() as rec, marks("window"):
            for _ in range(jobs):
                job(marks)
    evs = events(prof)
    win = [e for e in evs if e.name == tracing.PREFIX + "window"
           and not e.device]
    if len(win) != 1:
        raise RuntimeError(f"the profiler recorded {len(win)} window spans")
    lo, hi = win[0].start_ns, win[0].end_ns
    host = [tracing.Event(e.name, e.start_ns, e.end_ns, False) for e in evs
            if not e.device and e.end_ns > lo and e.start_ns < hi
            and e.name != tracing.PREFIX + "window"]
    trace = tracing.DeviceTrace(
        jobs=jobs, window_ns=(lo, hi),
        device_ops=[tracing.Event(e.name, e.start_ns, e.end_ns, True)
                    for e in device_ops(evs, lo, hi)], host=host)
    return rec, evs, trace


def run(bench: dict, name: str, *, seed: int, jobs: int = 3,
        timed_jobs: int = 10, device: str = "cuda",
        sizes: dict | None = None) -> dict:
    """One run of cell ``name`` with the program's recorder on (see the
    module's docstring); ``sizes`` replaces the configuration's sizes."""
    import time

    import torch

    from portbench import gen, harness
    from repro_torch import spans

    wl = harness.workload(bench, name)
    cfg, tr = harness.config(wl["config"]), harness.traffic(wl["traffic"])
    sizes = dict(cfg["sizes"], **(sizes or {}))
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    from repro_torch.core import MapReduce

    app = harness.build_app(tr, sizes)
    cols = gen.columns(cfg, seed, device, sizes)
    items = gen.items(tr, cols)
    sync()
    with spans.recording() as setup:
        mr = MapReduce(app, device=device, **tr["mapreduce"])
        mr.lower(items).compile()
        sync()
        mr.run(items)  # the warm job
        sync()

    def timed(n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            mr.run(items)
            sync()
        return (time.perf_counter() - t0) / n * 1e3

    job_ms_off = timed(timed_jobs)
    with spans.recording():
        job_ms_on = timed(timed_jobs)

    def job(marks):
        with marks("run"):
            mr.run(items)
        with marks("sync"):
            sync()

    stretch, evs, trace = profile(job, jobs=jobs)
    att = Attribution(evs, *trace.window_ns)
    dev = att.device_s()
    total = sum(dev.values())
    return {
        "device": torch.cuda.get_device_name(0) if cuda else "cpu",
        "power_limit": harness.power_limit() if cuda else None,
        "metrics": readings(setup, stretch, att),
        "jobs": jobs,
        "device_ms_per_job": {str(k): v / jobs * 1e3
                              for k, v in sorted(dev.items(), key=str)},
        "unattributed_share": dev.get(None, 0.0) / total if total else None,
        "device_ops_per_job": len(trace.device_ops) / jobs,
        "device_idle_pct": (100.0 * (1.0 - trace.busy_s() / trace.window_s)
                            if trace.device_ops else None),
        "idle_gaps": idle_gaps(trace, att) if trace.device_ops else [],
        "setup_s_by_span": {n: setup.seconds(n) for n in (
            "plan", "plan.key", "plan.derive", "plan.tune", "compile",
            "compile.warmup", "kernels.load", "job")},
        "recorder": {"job_ms_off": job_ms_off, "job_ms_on": job_ms_on,
                     "timed_jobs": timed_jobs},
        "stretch_counters": dict(stretch.counters),
    }


def main(argv=None) -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    for path in (root / "src", root):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    import torch

    from portbench import harness

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("program: no CUDA device; no result", file=sys.stderr)
        return 2
    out = run(harness.benchmark(root), args.workload, seed=args.seed)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
