"""The stream flow's chunk loop captured as one CUDA graph
(``engine.CapturedLoop``), held to the eager loop on the CPU.

The CPU has no CUDA graph, so the graph path is switched in here by a
stand-in (:class:`FakeGraph`): its capture runs the loop's Python once,
counting, and its replay runs it again into the capture's output tensors
with those counts taken back, as a replay writes the graph's pool and runs
no Python.  That holds the run's bookkeeping to the eager loop: the
capture key, the rule that only repeated items capture, the rules of one
held graph a run and of the process's bound on pools, the copy of the
result out of the pool, the counters a replay credits, the fallback when a
capture raises, and the paths that stay eager.  ``tests/test_torch_chunk_graph_card.py``
holds the real graph to the eager loop bit for bit on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import apps, spans  # noqa: E402
from repro_torch.core import ExecutionOptions, MapReduce  # noqa: E402
from repro_torch.core import api  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.roofline import op_trace  # noqa: E402

K = 1000  # KeyedSum's key space
ITEMS = 300  # of 8 pairs: 2400 pairs
CHUNK_PAIRS = 800  # 3 chunks
SCALE = 0.01  # the ported apps' inputs (apps.build)
APP_CHUNK_PAIRS = 1 << 10

#: the counters a job's chunk loop adds
LOOP_COUNTERS = ("chunks", "pairs", "fold_pairs", "fold_scans",
                 "fold_partitioned", "launches.onehot_fold",
                 "launches.chunk_monoid_fold", "launches.int_fold")
GRAPH_COUNTERS = ("loop_captures", "loop_replays", "loop_fallbacks",
                  "graph_pool_bytes")


class FakeGraph:
    """A CUDA graph's stand-in on the CPU: ``replay`` runs the captured
    fold again, with the recorder off and its counts taken back (a replay
    runs no Python), and writes its result into the capture's output
    tensors."""

    def __init__(self, fold):
        self.fold = fold
        self.out = fold()

    def replay(self):
        rec, spans._recording = spans._recording, None
        try:
            with spans.tally() as made:
                fresh = self.fold()
            spans.credit(made, -1)
        finally:
            spans._recording = rec
        for dst, src in zip(pytree.tree_leaves(self.out),
                            pytree.tree_leaves(fresh)):
            dst.copy_(src)


POOL_BYTES = 4096


def fake_capture(fold, device):
    graph = FakeGraph(fold)
    return graph, graph.out, None, POOL_BYTES


@pytest.fixture
def graphs(monkeypatch):
    """Switch the graph path in on the CPU."""
    monkeypatch.setattr(eng, "graph_capturable", lambda device: True)
    monkeypatch.setattr(eng, "capture", fake_capture)


def _items(seed: int = 0, n: int = ITEMS):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, K, (n, 8), generator=g, dtype=torch.int32),
            torch.rand(n, 8, generator=g))


def _run(flow: str = "stream", use_kernels: bool = True,
         eager: bool = False) -> eng.LocalRun:
    """A KeyedSum run on the CPU; ``eager`` holds it to the eager loop."""
    mr = MapReduce(apps.KeyedSum(K), flow=flow, device="cpu",
                   use_kernels=use_kernels, stream_chunk_pairs=CHUNK_PAIRS,
                   cache=False)
    run = eng.LocalRun(mr.app, flow, mr.plan.spec, device="cpu",
                       plan=mr.plan, **mr._knobs(ExecutionOptions()))
    if eager:
        run._no_capture = "held eager by the test"
    return run


def _totals(names=LOOP_COUNTERS + GRAPH_COUNTERS + ("runs",)) -> dict:
    return {n: spans.total(n) for n in names}


def _delta(before: dict) -> dict:
    return {n: spans.total(n) - v for n, v in before.items()}


def _same(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# -- the capture key ---------------------------------------------------------


class Scaled(apps.KeyedSum):
    """KeyedSum whose map reads two attributes of its app: a number and a
    tensor."""

    def __init__(self):
        super().__init__(K)
        self.scale = 2.0
        self.shift = torch.zeros(8)

    def map(self, item, emit):
        keys, weights = item
        emit(keys, weights * self.scale + self.shift)


def _variants():
    """The base call ``(app, base, ITEMS)``, and calls each of which
    differs from it in one thing the captured loop reads."""
    buf = torch.zeros(ITEMS * 16 + 8, dtype=torch.int32)
    keys = buf[:ITEMS * 8].view(ITEMS, 8)
    vals = torch.zeros(ITEMS, 8)
    base = (keys, vals)
    app = Scaled()
    scaled, shifted = Scaled(), Scaled()
    scaled.scale = 3.0
    shifted.shift = torch.zeros(8)  # the same values at another address
    boxed = [torch.zeros(8)]
    closure = api.make_app(lambda item, emit: emit(item[0], item[1] + boxed[0]),
                           app.reduce, key_space=K, value_spec=app.value_spec,
                           emit_capacity=8)
    return (app, base, ITEMS), [
        ("storage", app, (keys.clone(), vals), ITEMS),
        ("offset", app, (buf[8:8 + ITEMS * 8].view(ITEMS, 8), vals), ITEMS),
        ("shape", app, (buf[:ITEMS * 8].view(ITEMS * 2, 4), vals), ITEMS),
        ("stride", app, (buf[:ITEMS * 16].view(ITEMS, 16)[:, :8], vals),
         ITEMS),
        ("dtype", app, (keys.view(torch.float32), vals), ITEMS),
        ("n_valid", app, base, ITEMS - 1),
        ("app number", scaled, base, ITEMS),
        ("app tensor", shifted, base, ITEMS),
        ("closure tensor", (closure, boxed), base, ITEMS),
    ]


@pytest.mark.parametrize("what", ["storage", "offset", "shape", "stride",
                                  "dtype", "n_valid", "app number",
                                  "app tensor", "closure tensor"])
def test_the_capture_key_tells_apart(what):
    (app, base, n0), variants = _variants()
    (other, items, n), = [(a, i, n) for name, a, i, n in variants
                          if name == what]
    if what == "closure tensor":  # one app, its closure's tensor replaced
        app, boxed = other
        key = eng.loop_key(app, base, n0)
        boxed[0] = torch.zeros(8)
        assert eng.loop_key(app, items, n) != key
        return
    key = eng.loop_key(app, base, n0)
    assert eng.loop_key(app, base, n0) == key  # the same call: one key
    assert eng.loop_key(app, tuple(base), n0) == key
    assert eng.loop_key(other, items, n) != key


def test_the_capture_key_is_the_address_not_the_contents():
    keys, vals = _items()
    app = Scaled()
    key = eng.loop_key(app, (keys, vals), ITEMS)
    keys[0, 0] += 1  # changed in place: a replay reads it
    app.shift.add_(1)
    assert eng.loop_key(app, (keys, vals), ITEMS) == key


# -- the paths that stay eager -----------------------------------------------


def _ingest(run: eng.LocalRun, items):
    """A seeded fold (the streaming service's ingest)."""
    ci = eng.chunk_items_of(run.app, ITEMS, run.chunk_pairs)
    comb = run.combiner(ci)
    seed = eng.fold_items_chunked(run.app, comb, items, ci)
    return eng.fold_items_chunked(run.app, comb, items, ci, state=seed)


@pytest.mark.parametrize("case", ["cpu", "kernels off", "sort flow",
                                  "seeded fold", "op trace", "tables",
                                  "items in turn", "one-shot runs"])
def test_the_eager_path_runs_where_capture_is_not_allowed(case, request):
    """Where the loop may not be captured, and where items do not repeat
    from one call to the next (two copies in turn; a new run a call), the
    loop is eager on every call: no capture, no pool."""
    if case != "cpu":
        request.getfixturevalue("graphs")
    run = _run(flow="sort" if case == "sort flow" else "stream",
               use_kernels=case != "kernels off")
    want = _run(flow=run.flow, use_kernels=run.use_kernels, eager=True)
    items = _items(1)
    copies = (items, tuple(t.clone() for t in items))
    before = _totals(GRAPH_COUNTERS)
    for i in range(4):
        if case == "seeded fold":
            assert _same(_ingest(run, items), _ingest(want, items))
        elif case == "op trace":
            got, _ = op_trace.trace(run, items)
            assert _same(got, want(items))
        elif case == "tables":
            assert _same(run.tables(items)[1:], want.tables(items)[1:])
        elif case == "items in turn":
            assert _same(run(copies[i % 2]), want(items))
        elif case == "one-shot runs":
            run = _run()
            assert _same(run(items), want(items))
        else:
            assert _same(run(items), want(items))
    assert _delta(before) == dict.fromkeys(GRAPH_COUNTERS, 0)
    assert run.captured is None
    if case in ("cpu", "kernels off", "sort flow", "op trace",
                "items in turn", "one-shot runs"):
        assert run.loop_path.startswith("eager (")
        assert f"loop: {run.loop_path}" in run.plan.explain().splitlines()
    reason = {"cpu": "on a cpu device, not a CUDA card",
              "kernels off": "kernels off", "sort flow": "the sort flow",
              "op trace": "under a dispatch mode",
              "items in turn": "other items than the call before",
              "one-shot runs": "other items than the call before"}
    if case in reason:
        assert reason[case] in run.loop_path


# -- the graph path against the eager loop -----------------------------------


def _app(name: str):
    if name == "KS":
        return apps.KeyedSum(K), _items(2)
    return apps.build(name, np.random.default_rng(0), scale=SCALE,
                      device="cpu")


@pytest.mark.parametrize("name", list(apps.ALL) + ["BB", "KS"])
def test_every_app_gives_the_eager_bits_and_counts(name, graphs):
    """Three calls of a compiled run with the graph path switched in (the
    eager first call, the capture, a replay) give the bits and the counter
    totals, call for call, of three calls of an eager run."""
    app, items = _app(name)
    mr = MapReduce(app, device="cpu", use_kernels=True,
                   stream_chunk_pairs=APP_CHUNK_PAIRS, cache=False)
    opts = ExecutionOptions(cache=False)
    comp = mr.lower(items, options=opts).compile()
    eager = MapReduce(app, device="cpu", use_kernels=True,
                      stream_chunk_pairs=APP_CHUNK_PAIRS, cache=False)
    ecomp = eager.lower(items, options=opts).compile()
    ecomp._entry.executable._no_capture = "held eager by the test"
    paths = []
    for _ in range(3):
        before = _totals()
        got = comp(items)
        counted = _delta(before)
        before = _totals()
        want = ecomp(items)
        assert _same((got.keys, got.values, got.counts),
                     (want.keys, want.values, want.counts))
        ecounted = _delta(before)
        for n in LOOP_COUNTERS + ("runs",):
            assert counted[n] == ecounted[n], n
        paths.append(comp._entry.executable.loop_path)
    if mr.plan.flow == "stream":
        assert paths[0].startswith("eager (other items than the call before")
        assert paths[1].startswith("cuda graph, captured")
        assert paths[2].startswith("cuda graph, replayed")
        assert f"loop: {paths[2]}" in comp.explain().splitlines()


def test_a_replay_credits_the_captured_counts_to_its_span(graphs):
    run = _run()
    items = _items(3)
    run(items)  # eager: the kernels' first run
    run(items)  # the capture
    with spans.recording() as rec:
        with spans.job():
            run(items)
    (job,) = rec.named("job")
    (replay,) = rec.named("graph.replay")
    assert replay.parent == job.id and not rec.named("chunk")
    assert replay.counters["chunks"] == 3
    assert replay.counters["loop_replays"] == 1
    assert job.counters["chunks"] == 3 and job.counters["runs"] == 1
    assert job.counters["pairs"] == ITEMS * 8


def test_a_kept_result_is_not_the_graphs_pool(graphs):
    """A replay writes the graph's output again: what a call returned is
    a copy, and stays as it was after a replay over items changed in
    place, which folds what the items hold then."""
    run = _run()
    keys, vals = _items(4)
    run((keys, vals))
    first = run((keys, vals))  # the capture
    kept = [t.clone() for t in pytree.tree_leaves(first)]
    held = {t.untyped_storage().data_ptr()
            for t in pytree.tree_leaves(run.captured.state)}
    for t in pytree.tree_leaves(first):
        assert t.untyped_storage().data_ptr() not in held
    keys[:, 0] = (keys[:, 0] + 7) % K
    vals.mul_(2)
    second = run((keys, vals))
    assert run.loop_path.startswith("cuda graph, replayed")
    assert _same(pytree.tree_leaves(first), kept)
    assert _same(second, _run(eager=True)((keys, vals)))
    for t in pytree.tree_leaves(second):
        assert t.untyped_storage().data_ptr() not in held


@pytest.mark.parametrize("values", [True, False])
@pytest.mark.parametrize("name", ["WC", "KS"])
def test_each_returned_tensor_is_copied_out_of_the_pool(name, values,
                                                        graphs):
    """The tables' counts (WordCount) and the fused accumulator's values
    column (KeyedSum) are views of the state: each leaves the pool, with
    or without values."""
    app, items = _app(name)
    mr = MapReduce(app, device="cpu", use_kernels=True,
                   stream_chunk_pairs=APP_CHUNK_PAIRS, cache=False)
    run = eng.LocalRun(mr.app, "stream", mr.plan.spec, device="cpu",
                       plan=mr.plan, **mr._knobs(ExecutionOptions()))
    for _ in range(3):
        out = run(items, values=values)
    assert run.loop_path.startswith("cuda graph, replayed")
    held = {t.untyped_storage().data_ptr()
            for t in pytree.tree_leaves(run.captured.state)}
    assert not [t for t in pytree.tree_leaves(out)
                if t.untyped_storage().data_ptr() in held]


def test_new_items_recapture_and_free_the_old_graph(graphs):
    """A run holds one captured loop: new items run eagerly once, keeping
    the old graph (a replay over the old items still finds it), and a
    repeat of them drops the old graph before it captures; the counters
    count each capture and each pool."""
    import weakref

    run = _run()
    a, b = _items(5), _items(6)
    before = _totals(GRAPH_COUNTERS)
    run(a)
    run(a)  # the capture
    old = weakref.ref(run.captured.graph)
    run(a)  # a replay
    run(b)  # new items: eager
    assert run.loop_path.startswith("eager (other items than the call before")
    assert old() is not None
    run(a)  # the old graph, still held
    assert run.loop_path.startswith("cuda graph, replayed")
    run(b)
    got = run(b)  # a repeat: the capture
    assert old() is None
    assert run.loop_path.startswith("cuda graph, captured")
    assert run.captured.key == eng.loop_key(run.app, b, ITEMS)
    assert _same(got, _run(eager=True)(b))
    assert _delta(before) == {"loop_captures": 2, "loop_replays": 2,
                              "loop_fallbacks": 0,
                              "graph_pool_bytes": 2 * POOL_BYTES}
    # a padded call folds fewer items: a key of its own
    run(b, n_valid=ITEMS - 10)
    assert run.loop_path.startswith("eager (other items than the call before")


def test_the_process_holds_at_most_its_bytes_of_pools(graphs, monkeypatch):
    """Over all runs the process holds at most ``GRAPH_POOL_BYTES`` of
    pools: a capture past them frees the least recently used loops, and a
    run whose loop was freed captures again on its next call."""
    import weakref

    monkeypatch.setattr(eng, "GRAPH_POOL_BYTES", 2 * POOL_BYTES)
    runs = [_run() for _ in range(3)]
    items = _items(8)
    graphs_of = []
    for run in runs:
        run(items)
        run(items)  # the capture
        graphs_of.append(weakref.ref(run.captured.graph))
    assert graphs_of[0]() is None and runs[0].captured is None
    assert all(r.captured is not None for r in runs[1:])
    assert sum(h.pool_bytes for h in eng._held.values()) <= 2 * POOL_BYTES
    runs[1](items)  # a replay: the most recently used
    got = runs[0](items)
    assert runs[0].loop_path.startswith("cuda graph, captured")
    assert _same(got, _run(eager=True)(items))
    assert graphs_of[2]() is None and graphs_of[1]() is not None
    monkeypatch.setattr(eng, "GRAPH_POOL_BYTES", 0)
    runs[2](items)  # a capture: the newest loop is held whatever its pool
    assert [r.captured is not None for r in runs] == [False, False, True]


def test_a_run_frees_its_loop_with_it(graphs, monkeypatch):
    """A run's captured loop is freed with the run.  (The stand-in graph
    here keeps no reference to the loop's Python, which would keep the run
    alive; a CUDA graph keeps none.)"""
    import gc
    import weakref

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(eng, "capture", lambda fold, device: (
        Graph(), fold(), None, POOL_BYTES))
    run = _run()
    items = _items(9)
    run(items)
    run(items)
    token, graph = run._token, weakref.ref(run.captured.graph)
    del run
    gc.collect()
    assert graph() is None and token not in eng._held


@pytest.mark.parametrize("what", ["number", "tensor"])
def test_an_app_attribute_set_between_calls_is_read(what, graphs):
    """A captured map freezes what it reads: setting an attribute of its
    app to another number or tensor makes another key, so the next call
    is eager and gives the new attribute's result, and a repeat captures
    anew."""
    app = Scaled()
    mr = MapReduce(app, device="cpu", use_kernels=True,
                   stream_chunk_pairs=CHUNK_PAIRS, cache=False)
    run = eng.LocalRun(app, "stream", mr.plan.spec, device="cpu",
                       plan=mr.plan, **mr._knobs(ExecutionOptions()))
    items = _items(10)
    run(items)
    run(items)
    run(items)
    assert run.loop_path.startswith("cuda graph, replayed")
    if what == "number":
        app.scale = 5.0
    else:
        app.shift = torch.full((8,), 0.25)
    fresh = Scaled()
    fresh.scale, fresh.shift = app.scale, app.shift
    want = _run(eager=True)
    want.app = fresh
    got = run(items)
    assert run.loop_path.startswith("eager (other items than the call before")
    assert _same(got, want(items))
    assert _same(run(items), want(items))
    assert run.loop_path.startswith("cuda graph, captured")


def test_a_capture_that_raises_falls_back_to_the_eager_loop(monkeypatch):
    """A capture that raises (a host sync inside the loop, say) leaves the
    run eager for good, says why, and counts what the eager loop counts:
    the failed capture's counts are taken back."""
    monkeypatch.setattr(eng, "graph_capturable", lambda device: True)

    def failing(fold, device):
        fold()  # counts, as a capture runs the loop's Python
        raise RuntimeError("operation not permitted when stream is "
                           "capturing\nmore")

    monkeypatch.setattr(eng, "capture", failing)
    run, want = _run(), _run(eager=True)
    items = _items(7)
    for i in range(3):
        before = _totals()
        got = run(items)
        counted = _delta(before)
        before = _totals()
        assert _same(got, want(items))
        ecounted = _delta(before)
        for n in LOOP_COUNTERS:
            assert counted[n] == ecounted[n], n
        assert counted["loop_fallbacks"] == (i == 1)
    assert run.captured is None
    assert run.loop_path == ("eager (capture failed: RuntimeError: operation "
                             "not permitted when stream is capturing)")


def test_threads_take_turns_on_one_run(monkeypatch):
    """Calls of one run from more threads than cores, over items that
    change from call to call, take turns: no capture overlaps another (a
    run's replay writes the pool its copy out reads, and a capture that
    raises leaves the run eager), and each call gets its items' bits."""
    import sys
    import threading
    import time

    capturing = []

    def exclusive_capture(fold, device):
        if capturing:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        capturing.append(1)
        try:
            time.sleep(0.002)
            return fake_capture(fold, device)
        finally:
            capturing.pop()

    monkeypatch.setattr(eng, "graph_capturable", lambda device: True)
    monkeypatch.setattr(eng, "capture", exclusive_capture)
    run = _run()
    # three item sets, one of them in 12 of the 16 calls: whatever order
    # the threads take, two calls over it follow each other and capture
    sets = [_items(20 + j) for j in range(3)]
    calls = [sets[0] if i % 4 else sets[1 + i // 8] for i in range(16)]
    want = [_run(eager=True)(items) for items in calls]
    run(calls[0])  # the eager first run
    got = [None] * len(calls)
    fallbacks = spans.total("loop_fallbacks")
    captures = spans.total("loop_captures")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda i=i: got.__setitem__(i, run(calls[i])))
            for i in range(len(calls))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert spans.total("loop_fallbacks") == fallbacks
    assert spans.total("loop_captures") > captures
    for g, w in zip(got, want):
        assert g is not None and _same(g, w)


def test_tally_and_credit():
    name = "test.tallied"
    before = spans.total(name)
    with spans.tally() as outer:
        spans.count(name, 2)
        with spans.tally() as inner:
            spans.count(name, 3, key="k")
    spans.count(name, 100)  # after both: in neither
    assert inner == {(name, "k"): 3}
    assert outer == {(name, None): 2, (name, "k"): 3}
    spans.credit(outer)
    assert spans.total(name) == before + 2 * 5 + 100
    spans.credit(outer, -1)
    assert spans.total(name) == before + 5 + 100
    spans.reset([name])


def test_a_tally_holds_only_its_threads_counts():
    """A capture's tally is added again on each replay: counts another
    thread makes meanwhile (another run's job) are not in it."""
    import threading

    name = "test.tallied_thread"
    with spans.tally() as mine:
        spans.count(name, 1)
        other = threading.Thread(target=lambda: spans.count(name, 10))
        other.start()
        other.join()
    assert mine == {(name, None): 1}
    assert spans.total(name) >= 11
    spans.reset([name])
