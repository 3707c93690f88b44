"""The program's spans read against a profiled stretch (``program.py``):
the counter readers, the attribution of device ops to program spans, the
idle gaps labelled by program span, the six readings, and the guard that
keeps the program's ranges out of the device's ops."""

from __future__ import annotations

import sys

import pytest

from portbench import harness, program, tracing
from repro_torch import spans

MS = 1_000_000
E = program.Event


def _readings(trace) -> harness.Readings:
    return harness.Readings(
        setup_s=1.0, spans=tracing.Spans(), latencies_s=[0.01], window_s=0.0,
        least_bytes=int(3.35e9), device_name="NVIDIA H100 80GB HBM3",
        trace=trace)


def _stretch() -> list[E]:
    """Two jobs' events: in each, a fold kernel launched inside
    ``repro_torch.fold``, a copy launched inside ``repro_torch.map``, and
    in the first a fill with no launch in the trace, inside the device's
    ``repro_torch.init`` annotation; the harness's and the program's
    ranges on both timelines."""
    evs = [E("portbench.window", 0, 20 * MS, False)]
    for j, t in enumerate((0, 10 * MS)):
        c = 100 * (j + 1)
        evs += [
            E("portbench.run", t, t + 9 * MS, False),
            E("repro_torch.job", t, t + 9 * MS, False),
            E("repro_torch.chunk", t + 1 * MS, t + 8 * MS, False),
            E("repro_torch.map", t + 1 * MS, t + 2 * MS, False),
            E("aten::cat", t + 1 * MS, t + 2 * MS, False),
            E("cudaLaunchKernel", t + 1 * MS, t + 1 * MS + 10, False, c + 1),
            E("repro_torch.fold", t + 2 * MS, t + 3 * MS, False),
            E("cudaLaunchKernel", t + 2 * MS, t + 2 * MS + 10, False, c + 2),
            E("copy", t + 2 * MS, t + 3 * MS, True, c + 1),
            E("fold_segments", t + 3 * MS, t + 7 * MS, True, c + 2),
            E("repro_torch.fold", t + 3 * MS, t + 7 * MS, True),
            E("repro_torch.map", t + 2 * MS, t + 3 * MS, True),
            E("portbench.run", t + 2 * MS, t + 7 * MS, True),
        ]
    evs += [E("repro_torch.init", 500, 900_000, True),
            E("fill", 600, 900_000, True, 77)]  # correlation 77: no launch
    return evs


def _device_trace(evs, ops) -> tracing.DeviceTrace:
    return tracing.DeviceTrace(
        jobs=2, window_ns=(0, 20 * MS),
        device_ops=[tracing.Event(e.name, e.start_ns, e.end_ns, True)
                    for e in ops],
        host=[tracing.Event(e.name, e.start_ns, e.end_ns, False)
              for e in evs if not e.device
              and e.name != "portbench.window"])


def test_each_device_op_goes_to_the_span_that_launched_it():
    evs = _stretch()
    att = program.Attribution(evs, 0, 20 * MS)
    assert [op.name for op in att.ops] == ["copy", "fold_segments", "copy",
                                           "fold_segments", "fill"]
    assert att.spans == ["map", "fold", "map", "fold", "init"]
    dev = att.device_s()
    assert dev == {"map": pytest.approx(2e-3), "fold": pytest.approx(8e-3),
                   "init": pytest.approx(0.8994e-3)}
    assert att.path(1 * MS + 5) == "chunk.map"
    assert att.path(9 * MS + 5) is None


def test_an_op_with_neither_launch_nor_annotation_belongs_to_no_span():
    evs = [E("repro_torch.fold", 0, MS, False),
           E("k", 2 * MS, 3 * MS, True, 5)]
    att = program.Attribution(evs, 0, 4 * MS)
    assert att.spans == [None]
    assert att.device_s() == {None: pytest.approx(1e-3)}


def test_the_programs_ranges_on_the_device_are_not_device_ops():
    """The guard: a trace whose device timeline also shows the program's
    ``repro_torch.*`` ranges reads as the same trace without them."""
    evs = _stretch()
    ops = program.device_ops(evs, 0, 20 * MS)
    bare = [e for e in evs if not (e.device and e.name.startswith(
        program.ANNOTATIONS))]
    assert program.device_ops(bare, 0, 20 * MS) == ops
    assert not any(e.name.startswith(program.ANNOTATIONS) for e in ops)
    with_ranges = _readings(_device_trace(evs, ops))
    without = _readings(_device_trace(bare, [e for e in bare if e.device]))
    # unguarded, the ranges would count as device ops and fill the gaps
    unguarded = _readings(_device_trace(evs, [e for e in evs if e.device]))
    for name in ("device_ops_per_job", "device_idle_pct", "job_roofline"):
        reader = harness.metric_reader(name)
        assert reader.read(with_ranges) == pytest.approx(
            reader.read(without)), name
        assert reader.read(unguarded) != pytest.approx(
            reader.read(without)), name


def test_idle_gaps_name_the_program_span_each_ended_in():
    evs = _stretch()
    ops = program.device_ops(evs, 0, 20 * MS)
    trace = _device_trace(evs, ops)
    gaps = dict(program.idle_gaps(trace, program.Attribution(
        evs, 0, 20 * MS)))
    # each job's copy waits on its map's cat (the second also on the gap
    # after the first job); the fill starts late; the window ends idle
    assert gaps == {"run/chunk.map/aten::cat": pytest.approx(6.1e-3),
                    "run": pytest.approx(600e-9),
                    "window": pytest.approx(3e-3)}
    assert sum(gaps.values()) == pytest.approx(
        trace.window_s - trace.busy_s())


def _recorded(build):
    with spans.recording() as rec:
        build()
    return rec


def test_the_six_readings():
    def setup():
        with spans.span("plan"):
            with spans.span("plan.key"):
                pass
        with spans.span("compile"):
            with spans.span("compile.warmup"):
                with spans.span("kernels.load"):
                    pass
        with spans.span("kernels.load"):  # outside the warm-up: kept
            pass

    def stretch():
        for _ in range(2):
            with spans.job():
                for _ in range(3):
                    with spans.span("chunk"):
                        spans.count("chunks")
                        spans.count("fold_pairs", 10)
                        spans.count("fold_scans", 1540)

    s, t = _recorded(setup), _recorded(stretch)
    att = program.Attribution(_stretch(), 0, 20 * MS)
    got = program.readings(s, t, att)
    assert set(got) == {"chunks_per_job", "fold_scans_per_pair",
                        "fold_device_ms_per_job", "map_device_ms_per_job",
                        "warmup_ms", "plan_key_ms"}
    assert got["chunks_per_job"] == 3.0
    assert got["fold_scans_per_pair"] == 154.0
    assert got["fold_device_ms_per_job"] == pytest.approx(4.0)
    assert got["map_device_ms_per_job"] == pytest.approx(1.0)
    (warm,) = s.named("compile.warmup")
    inner = [r for r in s.named("kernels.load") if r.parent == warm.id]
    assert got["warmup_ms"] == pytest.approx(
        (warm.seconds - inner[0].seconds) * 1e3)
    assert got["plan_key_ms"] == pytest.approx(s.seconds("plan.key") * 1e3)
    assert program.readings(_recorded(lambda: None),
                            _recorded(lambda: None),
                            program.Attribution([], 0, 1)) == {}


def test_the_counter_readers_read_the_programs_totals():
    names = ["chunks", "runs", "fold_pairs", "fold_scans"]
    saved = {n: spans.total(n) for n in names}
    try:
        spans.reset(names)
        for _ in range(2):
            spans.count("runs")
            spans.count("chunks", 37)
        spans.count("fold_pairs", 4)
        spans.count("fold_scans", 616)
        r = _readings(None)
        assert harness.metric_reader("chunks_per_job").read(r) == 37.0
        assert harness.metric_reader("fold_scans_per_pair").read(r) == 154.0
        spans.reset(["runs"])
        assert harness.metric_reader("chunks_per_job").read(r) is None
    finally:
        spans.reset(names)
        for n, v in saved.items():
            spans.count(n, v)


def test_a_program_without_spans_gives_the_counter_readers_nothing(
        monkeypatch):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans")
    r = _readings(None)
    for name in ("chunks_per_job", "fold_scans_per_pair"):
        assert harness.metric_reader(name).read(r) is None


@pytest.mark.parametrize("cell", ["uv.sourceip"])
def test_a_cpu_run_with_the_recorder_on(cell):
    """The whole tool on the CPU at small sizes: no device ops there, so
    only the program's own readings."""
    out = program.run(harness.benchmark(), cell, seed=2**31 + 5, jobs=2,
                      timed_jobs=1, device="cpu",
                      sizes={"records": 3 * 65_536, "groups": 1000})
    m = out["metrics"]
    assert m["chunks_per_job"] == 3.0
    assert m["fold_scans_per_pair"] >= 1.0
    assert {"plan_key_ms", "fold_device_ms_per_job",
            "map_device_ms_per_job"} <= set(m)
    assert out["setup_s_by_span"]["plan"] > 0
    assert out["stretch_counters"]["chunks"] == 6
    assert out["device_ops_per_job"] == 0
