"""The stream flow's chunk loop captured as one CUDA graph, on the card:
a replayed job gives the eager loop's bits and counts, what a job returns
never lies in the graph's pool, new items recapture and free the old
pool, the process's pools stay within their bound, the profiler sees
every kernel of a replayed job, another thread's work does not spoil a
capture, and a capture that raises leaves the run eager, its pool freed
and the card sound.

A run's first call over its items is eager, the second captures, later
ones replay.  The eager loop is a compiled run held eager
(``_no_capture``), over the same items.  Skips where there is no CUDA card
(``tests/test_torch_chunk_graph.py`` holds the bookkeeping on the CPU).
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils import _pytree as pytree  # noqa: E402

from repro_torch import apps, spans  # noqa: E402
from repro_torch.core import ExecutionOptions, MapReduce  # noqa: E402
from repro_torch.core import combiner as C  # noqa: E402
from repro_torch.core import engine as eng  # noqa: E402
from repro_torch.core.api import make_app  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 2_500_000  # the uv.sourceip cell's groups
CHUNK_PAIRS = 1 << 22  # the cell's chunk
CHUNKS = 8  # the cell's 37 chunks cut to 8
ITEMS = CHUNKS * CHUNK_PAIRS // 8  # of 8 pairs
APP_CHUNK_PAIRS = 1 << 12  # the Phoenix apps' inputs: 4 to 96 chunks
COUNTERS = ("chunks", "pairs", "fold_pairs", "fold_scans",
            "fold_partitioned", "launches.onehot_fold",
            "launches.chunk_monoid_fold", "launches.int_fold", "runs")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: a CUDA graph is captured only there")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    return torch.device("cuda")


def _keyed(card, hot: bool = False, seed: int = 0):
    g = torch.Generator(device=card).manual_seed(seed)
    keys = torch.randint(0, K, (ITEMS, 8), device=card, generator=g,
                         dtype=torch.int32)
    if hot:  # half the pairs on one key: the route cuts its region
        keys[:, ::2] = 7
    return apps.KeyedSum(K), (keys, torch.rand((ITEMS, 8), device=card,
                                               generator=g))


def _case(name: str, card):
    if name in ("KeyedSum", "KeyedSum hot"):
        app, items = _keyed(card, hot=name.endswith("hot"))
        return app, items, CHUNK_PAIRS
    short = {"Histogram": "HG", "WordCount": "WC", "KMeans": "KM"}[name]
    app, items = apps.build(short, np.random.default_rng(0), device=card)
    return app, items, APP_CHUNK_PAIRS


def _compiled(app, items, chunk_pairs: int, *, eager: bool):
    """A compiled run of its own (warmed up on zeros); ``eager`` holds it
    to the eager loop."""
    mr = MapReduce(app, device="cuda", stream_chunk_pairs=chunk_pairs,
                   cache=False)
    comp = mr.lower(items, options=ExecutionOptions(cache=False)).compile()
    if eager:
        comp._entry.executable._no_capture = "held eager by the test"
    return comp


def _job(comp, items):
    res = comp(items)
    torch.cuda.synchronize()
    return res.keys, res.values, res.counts


def _totals() -> dict:
    return {n: spans.total(n) for n in COUNTERS}


def _counted(comp, items):
    before = _totals()
    out = _job(comp, items)
    return out, {n: spans.total(n) - v for n, v in before.items()}


def _same(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["KeyedSum", "KeyedSum hot", "Histogram",
                                  "WordCount", "KMeans"])
def test_a_replayed_job_gives_the_eager_bits_and_counts(name, card):
    app, items, chunk_pairs = _case(name, card)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    eager = _compiled(app, items, chunk_pairs, eager=True)
    run = comp._entry.executable
    want, ecounted = _counted(eager, items)
    for path in ("eager (other items than the call before",
                 "cuda graph, captured", "cuda graph, replayed",
                 "cuda graph, replayed"):
        got, counted = _counted(comp, items)
        assert run.loop_path.startswith(path), run.loop_path
        assert _same(got, want)
        assert counted == ecounted
    if name == "KeyedSum":
        assert ecounted["chunks"] == CHUNKS
    assert f"loop: {run.loop_path}" in comp.explain().splitlines()


@pytest.mark.cuda
def test_a_replayed_job_syncs_the_host_at_most_once(card):
    from portbench import syncs

    app, items, chunk_pairs = _case("KeyedSum", card)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    _job(comp, items)
    _job(comp, items)  # the capture
    got = syncs.host_syncs(lambda: comp(items))
    assert comp._entry.executable.loop_path.startswith("cuda graph, replayed")
    assert got["count"] <= 1, got


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["KeyedSum", "WordCount"])
def test_a_kept_result_survives_a_replay_over_changed_items(name, card):
    """What a job returned is not the graph's pool: a replay over items
    changed in place leaves it as it was, and folds what they hold."""
    app, items, chunk_pairs = _case(name, card)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    eager = _compiled(app, items, chunk_pairs, eager=True)
    _job(comp, items)
    first = _job(comp, items)  # the capture
    kept = [t.clone() for t in pytree.tree_leaves(first)]
    for leaf in pytree.tree_leaves(items):
        if leaf.is_floating_point():
            leaf.mul_(2).add_(1)
        else:
            leaf.copy_(leaf.flip(0))
    second = _job(comp, items)
    assert comp._entry.executable.loop_path.startswith(
        "cuda graph, replayed")
    assert _same(pytree.tree_leaves(first), kept)
    assert _same(second, _job(eager, items))
    held = {t.untyped_storage().data_ptr() for t in pytree.tree_leaves(
        comp._entry.executable.captured.state)}
    assert not [t for t in pytree.tree_leaves((first, second))
                if t.untyped_storage().data_ptr() in held]


@pytest.mark.cuda
def test_new_items_recapture_and_free_the_old_pool(card):
    """Two item tensors, each called twice in turn: each repeat captures,
    and the card's reserved memory does not grow from capture to capture
    (no cache emptied): each capture frees the pool of the one before."""
    app, items, chunk_pairs = _case("KeyedSum", card)
    _, other = _keyed(card, seed=1)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    eager = _compiled(app, items, chunk_pairs, eager=True)
    run = comp._entry.executable
    captures = spans.total("loop_captures")
    reserved = []
    for it in (items, other, items, other):
        _job(comp, it)
        got = _job(comp, it)
        assert run.loop_path.startswith("cuda graph, captured")
        assert _same(got, _job(eager, it))
        del got
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
    assert spans.total("loop_captures") == captures + 4
    assert reserved[3] <= reserved[1] + (16 << 20), reserved
    assert run.captured.pool_bytes < 2**30


@pytest.mark.cuda
def test_the_process_holds_one_pool_at_a_bound_of_one_byte(card,
                                                            monkeypatch):
    """Six item counts compiled in turn, each run capturing its loop, with
    the process's bound on pools at one byte: one loop is held, and the
    card's reserved memory, the unused cache emptied, stays flat: a loop
    past the bound is freed with its pool."""
    monkeypatch.setattr(eng, "GRAPH_POOL_BYTES", 1)
    app, items, chunk_pairs = _case("KeyedSum", card)
    runs, reserved = [], []
    for i in range(6):
        part = tuple(t[:ITEMS - 4096 * i] for t in items)
        comp = _compiled(app, part, chunk_pairs, eager=False)
        eager = _compiled(app, part, chunk_pairs, eager=True)
        _job(comp, part)
        got = _job(comp, part)  # the capture
        run = comp._entry.executable
        assert run.loop_path.startswith("cuda graph, captured")
        assert _same(got, _job(eager, part))
        runs.append(run)
        del got, comp, eager
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved())
    assert [r.captured is not None for r in runs] == [False] * 5 + [True]
    assert max(reserved[1:]) <= reserved[0] + (16 << 20), reserved


@pytest.mark.cuda
def test_another_threads_work_does_not_spoil_a_capture(card):
    """While a run captures, another thread allocates and synchronizes
    the card: neither raises (the capture is thread-local), and the
    replays give the eager bits."""
    import threading

    app, items, chunk_pairs = _case("KeyedSum", card)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    eager = _compiled(app, items, chunk_pairs, eager=True)
    _job(comp, items)
    stop, errors, done = threading.Event(), [], [0]

    def other():
        try:
            while not stop.is_set():
                x = torch.ones(1 << (18 + done[0] % 5), device=card)
                float(x.sum())
                done[0] += 1
        except Exception as exc:  # noqa: BLE001 - the test reports it
            errors.append(exc)

    worker = threading.Thread(target=other)
    worker.start()
    try:
        while done[0] == 0:
            pass
        got = _job(comp, items)  # the capture
    finally:
        stop.set()
        worker.join()
    assert not errors, errors
    assert comp._entry.executable.loop_path.startswith("cuda graph, captured")
    want = _job(eager, items)
    assert _same(got, want)
    assert _same(_job(comp, items), want)


@pytest.mark.cuda
def test_the_profiler_sees_every_kernel_of_a_replayed_job(card):
    """A replayed job's device ops, as the profiler records them: as many
    as the eager job's, and their summed time within 5 %."""
    from portbench import tracing

    app, items, chunk_pairs = _case("KeyedSum", card)
    comp = _compiled(app, items, chunk_pairs, eager=False)
    eager = _compiled(app, items, chunk_pairs, eager=True)
    _job(comp, items)
    _job(comp, items)  # the capture
    seen = {}
    for side, c in (("eager", eager), ("graph", comp)):
        tr = tracing.profile_jobs(lambda c=c: _job(c, items),
                                  tracing.Spans(), min_jobs=3, min_s=0.0)
        seen[side] = (len(tr.device_ops) / tr.jobs, tr.device_s() / tr.jobs)
    assert comp._entry.executable.loop_path.startswith("cuda graph, replayed")
    (e_ops, e_s), (g_ops, g_s) = seen["eager"], seen["graph"]
    assert abs(g_ops - e_ops) <= 0.05 * e_ops, seen
    assert abs(g_s - e_s) <= 0.05 * e_s, seen


@pytest.mark.cuda
def test_a_capture_that_raises_leaves_the_run_eager(card):
    """A map that copies a Python value to the card cannot be captured:
    the run falls back to the eager loop for good, says why, gives the
    eager bits, frees the failed capture's pool, and the card stays sound
    for the next capture."""
    vs = C.ValueSpec((), torch.float32)
    app = make_app(lambda item, emit: emit(item, 1.5),
                   lambda key, values, count: values.sum(0), key_space=1000,
                   value_spec=vs, emit_capacity=1)
    items = torch.randint(0, 1000, (1 << 16,), device=card,
                          dtype=torch.int32)
    comp = _compiled(app, items, 1 << 12, eager=False)
    eager = _compiled(app, items, 1 << 12, eager=True)
    fallbacks = spans.total("loop_fallbacks")
    reserved = []
    for _ in range(4):
        assert _same(_job(comp, items), _job(eager, items))
        reserved.append(torch.cuda.memory_reserved())
    run = comp._entry.executable
    assert run.loop_path.startswith("eager (capture failed: ")
    assert spans.total("loop_fallbacks") == fallbacks + 1
    assert run.captured is None
    assert reserved[3] <= reserved[0] + (16 << 20), reserved
    kapp, kitems, chunk_pairs = _case("KeyedSum", card)
    kcomp = _compiled(kapp, kitems, chunk_pairs, eager=False)
    keager = _compiled(kapp, kitems, chunk_pairs, eager=True)
    _job(kcomp, kitems)
    assert _same(_job(kcomp, kitems), _job(keager, kitems))
    assert kcomp._entry.executable.loop_path.startswith(
        "cuda graph, captured")
