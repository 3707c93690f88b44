"""The port's span and counter recorder (``repro_torch.spans``): spans nest
with their parent and job, counts reach the open spans, the recorder off
records nothing and opens no profiler range, the records agree with the
profiler's ``repro_torch.*`` ranges, and a chunked run records a span a
chunk with its map, premap and fold, and counts its chunks and scans."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch import apps, spans  # noqa: E402
from repro_torch.core import ExecutionOptions, MapReduce  # noqa: E402

K = 1000  # KeyedSum's key space
ITEMS = 300  # of 8 pairs: 2400 pairs
CHUNK_PAIRS = 800  # 3 chunks
KEY_BLOCK = 256  # the plain contraction's key blocks: 4


def _items(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, K, (ITEMS, 8), generator=g, dtype=torch.int32),
            torch.rand(ITEMS, 8, generator=g))


def _mapreduce(flow: str, cache: bool = True) -> MapReduce:
    return MapReduce(apps.KeyedSum(K), flow=flow, device="cpu",
                     stream_chunk_pairs=CHUNK_PAIRS,
                     stream_key_block=KEY_BLOCK, cache=cache)


def test_spans_nest_with_their_parent_and_job():
    with spans.recording() as rec:
        with spans.span("outside"):
            pass
        with spans.job():
            with spans.span("a"):
                with spans.job():  # a job inside a job is the outer one
                    with spans.span("b"):
                        pass
        with spans.job():
            pass
    by = {r.name: r for r in rec.records}
    assert [r.name for r in rec.records] == ["outside", "b", "a", "job",
                                             "job"]
    jobs = rec.named("job")
    assert by["outside"].parent is None and by["outside"].job is None
    assert jobs[0].parent is None and jobs[0].job == jobs[0].id
    assert by["a"].parent == jobs[0].id and by["a"].job == jobs[0].id
    assert by["b"].parent == by["a"].id and by["b"].job == jobs[0].id
    assert jobs[1].job == jobs[1].id != jobs[0].id
    for r in rec.records:
        assert r.start_ns <= r.end_ns
    assert jobs[0].start_ns <= by["a"].start_ns <= by["b"].start_ns
    assert by["b"].end_ns <= by["a"].end_ns <= jobs[0].end_ns


def test_counters_go_to_the_open_spans_and_the_process_totals():
    before = spans.total("test.things")
    spans.count("test.things", 2)  # the recorder off: the total alone
    with spans.recording() as rec:
        with spans.span("outer"):
            spans.count("test.things")
            with spans.span("inner"):
                spans.count("test.things", 5)
                spans.count("test.keyed", key="x")
        spans.count("test.things", 7)  # outside every span
    by = {r.name: r for r in rec.records}
    assert by["inner"].counters == {"test.things": 5, "test.keyed": 1}
    assert by["outer"].counters == {"test.things": 6, "test.keyed": 1}
    assert rec.counters == {"test.things": 13, "test.keyed": 1}
    assert spans.total("test.things") == before + 15
    assert spans.by_key("test.keyed")["x"] >= 1
    spans.reset(["test.things", "test.keyed"])
    assert spans.total("test.things") == 0
    assert spans.by_key("test.keyed") == {}


def test_recorder_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name))
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name: opened.append(name))
    assert spans.span("plan") is spans.span("fold") is spans.job()
    chunks = spans.total("chunks")
    mr = _mapreduce("stream")
    mr.run(_items())
    assert opened == []
    assert spans.total("chunks") == chunks + 3  # counters still count
    with spans.recording() as rec:
        pass
    assert rec.records == [] and not rec.counters


def test_recording_refuses_to_nest():
    with spans.recording():
        with pytest.raises(RuntimeError):
            with spans.recording():
                pass


def _gaps_to_the_profilers_ranges(mr, items) -> list[tuple]:
    """(name, start gap, end gap) in ns of each span of one job recorded
    under a CPU profile, against its ``repro_torch.*`` range."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with spans.recording() as rec:
            mr.run(items)
    ranges = sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.name().startswith(spans.PREFIX)), key=lambda e: e.start_ns())
    records = sorted(rec.records, key=lambda r: r.start_ns)
    assert [e.name() for e in ranges] == [spans.PREFIX + r.name
                                          for r in records]
    assert len(records) == 1 + 1 + 3 * 4 + 1  # job, init, chunks, finalize
    return [(r.name, r.start_ns - e.start_ns(),
             r.end_ns - e.start_ns() - e.duration_ns())
            for e, r in zip(ranges, records)]


def test_records_agree_with_the_profilers_ranges():
    """Within 50 us.  A stamp is taken inside its range, a few bytecodes
    from its edge; an attempt in which the OS preempted the process at
    one of those edges reads late by the time it lost, so the best of
    three attempts is held to the bound."""
    mr = _mapreduce("stream")
    items = _items()
    with spans.recording():
        mr.run(items)  # the first ranges of a process start slowly
    attempts = [_gaps_to_the_profilers_ranges(mr, items) for _ in range(3)]
    worst = [max(max(abs(a), abs(b)) for _, a, b in gaps)
             for gaps in attempts]
    assert min(worst) < 50_000, attempts


def _below(rec, rid: int) -> set[str]:
    """Names of the spans under span ``rid``, at any depth."""
    kids = [r for r in rec.records if r.parent == rid]
    return {r.name for r in kids}.union(*(_below(rec, r.id) for r in kids))


@pytest.mark.parametrize("flow", ["stream", "sort"])
def test_a_chunked_run_records_each_chunk(flow):
    mr = _mapreduce(flow)
    items = _items(1)
    with spans.recording() as rec:
        mr.run(items)
    (job,) = rec.named("job")
    chunks = rec.named("chunk")
    assert len(chunks) == 3
    for c in chunks:
        assert c.parent == job.id and c.job == job.id
        assert {"map", "premap", "fold"} <= _below(rec, c.id)
        assert c.counters["chunks"] == 1
        assert c.counters["pairs"] == CHUNK_PAIRS
    assert {"init", "finalize"} <= _below(rec, job.id)
    assert job.counters["chunks"] == 3 and job.counters["runs"] == 1
    assert job.counters["pairs"] == ITEMS * 8
    if flow == "stream":
        # the plain route: the one-hot contraction reads every pair once
        # a key block, and the counts' int_fold once
        blocks = -(-K // KEY_BLOCK)
        assert [r.name for r in rec.records
                if r.parent in {c.id for c in chunks}] == [
            "map", "premap", "fold"] * 3
        assert job.counters["fold_pairs"] == 2 * ITEMS * 8
        assert job.counters["fold_scans"] == (blocks + 1) * ITEMS * 8


def test_the_plan_and_compile_spans():
    items = _items()
    with spans.recording() as rec:
        mr = _mapreduce("stream", cache=False)
        mr.lower(items, options=ExecutionOptions(cache=False)).compile()
    (plan,) = rec.named("plan")
    (comp,) = rec.named("compile")
    assert {"plan.key", "plan.derive", "plan.tune"} == _below(rec, plan.id)
    assert comp.parent is None and comp.job is None
    # a plan taken from the cache derives and tunes nothing
    with spans.recording() as rec:
        _mapreduce("stream")
        _mapreduce("stream")
    assert len(rec.named("plan")) == 2 and len(rec.named("plan.key")) == 2
    assert len(rec.named("plan.derive")) <= 1


def test_the_instrumented_chunk_loop_frees_each_chunks_pairs(monkeypatch):
    """A chunk's pairs are gone before the next chunk is mapped, as in a
    loop with no spans: a job's memory peak holds one chunk's pairs."""
    import weakref

    from repro_torch.core import engine

    real = engine.map_phase
    seen = []

    def map_phase(app, items, device):
        assert all(ref() is None for ref in seen), "a chunk's pairs live on"
        stream = real(app, items, device)
        seen.append(weakref.ref(stream.keys))
        return stream

    monkeypatch.setattr(engine, "map_phase", map_phase)
    for on in (False, True):
        seen.clear()
        with spans.recording() if on else contextlib.nullcontext():
            _mapreduce("stream").run(_items())
        assert len(seen) == 3
