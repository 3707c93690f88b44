"""The port's streaming service (``repro_torch.streaming``) on the CPU.

Three groups:

* each case of ``tests/streaming/test_service.py`` on the port (B = 64,
  VOCAB = 64): N ingests against the port's chunk-aligned batch run bit
  for bit, ragged batches, windows, the zero re-stage steady state,
  snapshots under an ``IngestionQueue``, poison batches, worker death,
  warm restarts and the staging guards;
* the same numpy batches through ``repro.streaming`` and the port's
  service, for the six SPECS, under windows and with ragged batches:
  counts, integer sums and max/min bit for bit, float sums within
  rtol = atol = 1e-6 (the packages add in other orders; integer tables
  are int64 in the port, C.5, so values are compared, not dtypes);
* the port's own guarantees: a held snapshot and a held state keep their
  bits while the service ingests on, in every collector mode, and
  ``engine.merge_partial_tables`` against the reference's on the monoid,
  ``spec.merge`` and reapply paths.
"""

import dataclasses
import tempfile
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
import repro.streaming as JS  # noqa: E402
from repro.core import collector as JCOL  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
from repro.core import engine as JENG  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core import engine as TENG  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.core.plan import plan_execution  # noqa: E402
from repro_torch.streaming import (IngestionQueue, MapReduceService,  # noqa: E402
                                   ServiceFailedError, WorkerDiedError,
                                   sliding, tumbling)

I32, F32 = torch.int32, torch.float32
VOCAB = 64
B = 64  # micro-batch capacity used throughout
FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


def kv_app(reduce_fn, value_spec, **attrs):
    """(key, value) items -> reduce over the values of each key."""
    return T.make_app(lambda item, emit: emit(item[0], item[1]), reduce_fn,
                      key_space=VOCAB, value_spec=value_spec,
                      emit_capacity=1, **attrs)


def wc_app():
    """Scalar token items -> (token, 1) word count."""
    return T.make_app(
        lambda item, emit: emit(item % VOCAB, torch.ones((), dtype=I32)),
        lambda k, v, c: v.sum(), key_space=VOCAB,
        value_spec=T.ValueSpec((), I32), emit_capacity=1)


def serve(app, **kw):
    return T.MapReduce(app, streaming=True, device="cpu").serve(**kw)


def kv_batches(rng, sizes, *, dtype=np.float32, width=()):
    out = []
    for n in sizes:
        keys = rng.integers(0, VOCAB, size=n).astype(np.int32)
        if np.issubdtype(dtype, np.integer):
            vals = rng.integers(-50, 50, size=(n,) + width).astype(dtype)
        else:
            vals = rng.standard_normal((n,) + width).astype(dtype)
        out.append((keys, vals))
    return out


def concat(batches):
    return tuple(np.concatenate(xs) for xs in zip(*batches))


def batch_reference(app, batches):
    """One port batch run over the concatenated items, its chunk the
    micro-batch: the bitwise reference of N ingests."""
    cap = max(app.emit_capacity, 1)
    return T.MapReduce(app, flow="stream", device="cpu").run(
        concat(batches), options=T.ExecutionOptions(chunk_pairs=B * cap))


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(want, got):
    w, g = host(want), host(got)
    assert w.shape == g.shape, (w.shape, g.shape)
    if w.dtype.kind == "f":
        np.testing.assert_array_equal(w.view(f"u{w.itemsize}"),
                                      g.view(f"u{g.itemsize}"))
    else:
        np.testing.assert_array_equal(w, g)


def assert_result_bits(want, got):
    assert_bits(want.keys, got.keys)
    assert_bits(want.values, got.values)
    assert_bits(want.counts, got.counts)


def count_of(res, key):
    keys, counts = host(res.keys), host(res.counts)
    (idx,) = np.nonzero(keys == key)
    return int(counts[idx[0]]) if idx.size else 0


# ---------------------------------------------------------------------------
# The reference's cases on the port
# ---------------------------------------------------------------------------

#: name -> (port reduce, JAX reduce, value dtype, value shape)
SPECS = {
    "sum_i32": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                "int32", ()),
    "sum_f32": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                "float32", ()),
    "max_f32": (lambda k, v, c: v.amax(0), lambda k, v, c: jnp.max(v),
                "float32", ()),
    "mean_f32": (lambda k, v, c: v.sum() / c.clamp(min=1).to(F32),
                 lambda k, v, c: jnp.sum(v) / jnp.maximum(c, 1).astype(
                     jnp.float32), "float32", ()),
    "count": (lambda k, v, c: c, lambda k, v, c: c, "int32", ()),
    "vecsum_f32": (lambda k, v, c: v.sum(0), lambda k, v, c: jnp.sum(v, 0),
                   "float32", (4,)),
}


def port_spec_app(name):
    fn, _, dt, width = SPECS[name]
    return kv_app(fn, T.ValueSpec(width, getattr(torch, dt)))


def ref_spec_app(name):
    _, fn, dt, width = SPECS[name]
    return J.make_app(
        map_fn=lambda item, emit: emit(item[0], item[1]), reduce_fn=fn,
        key_space=VOCAB,
        value_aval=jax.ShapeDtypeStruct(width, getattr(jnp, dt)),
        emit_capacity=1)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_incremental_parity_bitwise(name):
    """N sequential ingests == one batch run over the concatenation whose
    chunk is the micro-batch, bit for bit, for every derivable combiner
    strategy."""
    _, _, dt, width = SPECS[name]
    rng = np.random.default_rng(1 + sorted(SPECS).index(name))
    batches = kv_batches(rng, [B] * 6, dtype=getattr(np, dt), width=width)
    svc = serve(port_spec_app(name), batch_capacity=B)
    for b in batches:
        svc.ingest(b)
    assert_result_bits(batch_reference(port_spec_app(name), batches),
                       svc.snapshot())


def test_partial_batches_exact():
    """Micro-batches below capacity fold only their own items (nothing is
    padded): parity against the run over the same items."""
    rng = np.random.default_rng(5)
    svc = serve(wc_app(), batch_capacity=B)
    sizes = [B, 7, 1, 33, B, 12, 0]
    chunks = [rng.integers(0, VOCAB, size=s).astype(np.int32)
              for s in sizes]
    for c in chunks:
        svc.ingest(c)
    got = svc.snapshot()
    assert got.batch_id == len(sizes)
    assert svc.n_items == sum(sizes)
    want = T.MapReduce(wc_app(), flow="stream", device="cpu").run(
        np.concatenate(chunks))
    assert_bits(want.values, got.values)
    assert_bits(want.counts, got.counts)


def test_oversized_batch_rejected():
    svc = serve(wc_app(), batch_capacity=8)
    with pytest.raises(ValueError, match="batch_capacity"):
        svc.ingest(np.zeros((9,), np.int32))


def test_item_spec_mismatch_rejected():
    svc = serve(wc_app(), batch_capacity=8)
    svc.ingest(np.zeros((8,), np.int32))
    with pytest.raises(ValueError, match="staged item spec"):
        svc.ingest(np.zeros((8, 2), np.int32))


def test_zero_retrace_across_100_ingests():
    """After the first ingest stages the service, 100 more ingests (of
    varying sizes) and the snapshots among them run zero derives, tunes,
    probes and compiles."""
    rng = np.random.default_rng(7)
    svc = serve(wc_app(), batch_capacity=32)
    svc.ingest(rng.integers(0, VOCAB, size=32).astype(np.int32))
    s0 = pc.stats_snapshot()
    for i in range(100):
        n = 32 if i % 3 else 11
        svc.ingest(rng.integers(0, VOCAB, size=n).astype(np.int32))
        if i % 25 == 0:
            svc.snapshot()
    s1 = pc.stats_snapshot()
    for counter in ("derives", "autotunes", "probes", "compiles"):
        assert s1[counter] == s0[counter], (counter, s0, s1)
    assert svc.batch_id == 101


def test_second_service_hits_compiled_cache():
    rng = np.random.default_rng(8)
    items = rng.integers(0, VOCAB, size=B).astype(np.int32)
    serve(wc_app(), batch_capacity=B).ingest(items)
    s0 = pc.stats_snapshot()
    svc2 = serve(wc_app(), batch_capacity=B)
    svc2.ingest(items)
    s1 = pc.stats_snapshot()
    assert s1["compiles"] == s0["compiles"], (s0, s1)
    assert "compiled-cache: hit" in svc2.explain()


def sum_app():
    return port_spec_app("sum_i32")


def test_tumbling_window_covers_current_period_only():
    rng = np.random.default_rng(11)
    batches = kv_batches(rng, [B] * 10, dtype=np.int32)
    svc = serve(sum_app(), batch_capacity=B, window=tumbling(2))
    for b in batches:
        svc.ingest(b)
    got = svc.snapshot()
    want = batch_reference(sum_app(), batches[8:10])
    assert_bits(want.values, got.values)
    assert_bits(want.counts, got.counts)


def test_sliding_window_merges_live_slots():
    rng = np.random.default_rng(12)
    batches = kv_batches(rng, [B] * 9, dtype=np.int32)
    svc = serve(sum_app(), batch_capacity=B, window=sliding(4, 2))
    for b in batches:
        svc.ingest(b)
    got = svc.snapshot()
    # 9 batches, a size-4 / slide-2 ring: the last full period {6, 7} and
    # the one in progress {8}
    want = batch_reference(sum_app(), batches[6:9])
    assert_bits(want.values, got.values)
    assert_bits(want.counts, got.counts)


def test_window_expiry_drops_old_keys():
    svc = serve(wc_app(), batch_capacity=B, window=tumbling(2))
    hot = np.full((B,), 3, np.int32)
    cold = np.full((B,), 40, np.int32)
    svc.ingest(hot)
    svc.ingest(hot)
    assert count_of(svc.snapshot(), 3) == 2 * B
    svc.ingest(cold)  # a new period: the hot batches expire
    snap = svc.snapshot()
    assert count_of(snap, 3) == 0
    assert count_of(snap, 40) == B


def test_window_invalid_config():
    with pytest.raises(ValueError, match="multiple of slide"):
        sliding(5, 2)
    with pytest.raises(ValueError, match="positive"):
        tumbling(0)


def test_snapshot_consistent_under_concurrent_ingestion():
    """Snapshots taken while an IngestionQueue worker folds batches see a
    whole number of batches: counts.sum() == batch_id * B, generations
    monotone.  The switch interval is shortened so the threads interleave
    often (restored after)."""
    import sys

    rng = np.random.default_rng(13)
    svc = serve(wc_app(), batch_capacity=B, window=sliding(4, 1))
    q = IngestionQueue(svc, maxsize=4)
    n_batches = 30
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        producer = threading.Thread(target=lambda: [
            q.put(rng.integers(0, VOCAB, size=B).astype(np.int32),
                  timeout=60.0) for _ in range(n_batches)], daemon=True)
        producer.start()
        deadline = time.monotonic() + 60.0
        seen = []
        while svc.batch_id < n_batches and time.monotonic() < deadline:
            if svc.batch_id == 0:
                time.sleep(0.001)  # not staged yet: first ingest in flight
                continue
            snap = svc.snapshot()
            total = int(host(snap.counts).sum())
            assert total == min(snap.batch_id, 4) * B, (total,
                                                        snap.batch_id)
            seen.append(snap.batch_id)
        producer.join(timeout=60.0)
        assert not producer.is_alive()
        q.close()
    finally:
        sys.setswitchinterval(old)
    assert seen and seen == sorted(seen)
    final = svc.snapshot()
    assert final.batch_id == n_batches
    assert int(host(final.counts).sum()) == 4 * B


def test_ingestion_queue_surfaces_worker_errors():
    svc = serve(wc_app(), batch_capacity=4)
    q = IngestionQueue(svc, maxsize=2)
    q.put(np.zeros((16,), np.int32))  # oversized: the worker raises
    with pytest.raises(ValueError, match="batch_capacity"):
        q.join()
    q.close()


def test_ingestion_queue_quarantines_poison_batch():
    svc = serve(wc_app(), batch_capacity=8)
    q = IngestionQueue(svc, maxsize=4)
    q.put(np.zeros((8,), np.int32), timeout=30.0)        # seq 1: fine
    q.put(np.zeros((16,), np.int32), timeout=30.0)       # seq 2: poison
    q.put(np.full((8,), 5, np.int32), timeout=30.0)      # seq 3: folded
    with pytest.raises(ValueError, match="batch_capacity"):
        q.join()
    q.close()
    assert [p.seq for p in q.quarantined] == [2]
    assert "batch_capacity" in str(q.quarantined[0].error)
    snap = svc.snapshot()
    assert snap.batch_id == 2
    assert count_of(snap, 5) == 8
    assert not svc.failed


def test_ingestion_queue_worker_death_unstrands_producers():
    """A fatal worker death surfaces as WorkerDiedError on the next put()
    and on close() (no producer blocks forever), and marks the service
    failed; a failed service refuses ingests and keeps serving
    snapshots."""

    class Dying:
        batch_id = 0

        def __init__(self):
            self.failure = None

        def ingest(self, items):
            raise KeyboardInterrupt("simulated fatal worker death")

        def fail(self, exc):
            self.failure = exc

    svc = Dying()
    q = IngestionQueue(svc, maxsize=1)
    q.put(np.zeros((4,), np.int32))
    with pytest.raises(WorkerDiedError):
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:  # the death is asynchronous
            q.put(np.zeros((4,), np.int32), timeout=5.0)
    with pytest.raises(WorkerDiedError):
        q.close()
    assert not q._t.is_alive()
    assert isinstance(svc.failure, KeyboardInterrupt)

    real = serve(wc_app(), batch_capacity=8)
    real.ingest(np.full((8,), 7, np.int32))
    real.fail(RuntimeError("ingestion worker died"))
    assert real.failed
    with pytest.raises(ServiceFailedError, match="worker died"):
        real.ingest(np.zeros((8,), np.int32))
    snap = real.snapshot()
    assert snap.batch_id == 1 and count_of(snap, 7) == 8
    assert "FAILED" in real.explain()


def test_restore_resumes_bitwise():
    rng = np.random.default_rng(17)
    batches = kv_batches(rng, [B] * 12, dtype=np.int32)
    spec = (pc.TensorSpec((), I32), pc.TensorSpec((), I32))

    def build(d):
        return serve(sum_app(), batch_capacity=B, window=sliding(4, 2),
                     ckpt_dir=d, ckpt_every=4, item_spec=spec)

    with tempfile.TemporaryDirectory() as d:
        svc = build(d)
        for b in batches:
            svc.ingest(b)
        want = svc.snapshot()

        svc2 = build(d)  # a crash after batch 8: restore it, replay 8..12
        assert svc2.restore(step=8) == 8
        assert svc2.batch_id == 8 and svc2.n_items == 8 * B
        for b in batches[8:]:
            svc2.ingest(b)
        assert_result_bits(want, svc2.snapshot())

        svc3 = build(d)  # the newest checkpoint: the final tables
        assert svc3.restore() == 12
        assert_result_bits(want, svc3.snapshot())


def test_restore_requires_staging():
    with tempfile.TemporaryDirectory() as d:
        svc = serve(wc_app(), batch_capacity=B, ckpt_dir=d, ckpt_every=1)
        with pytest.raises(RuntimeError, match="item_spec"):
            svc.restore()


def test_streaming_pins_stream_flow():
    with pytest.raises(ValueError, match="stream"):
        T.MapReduce(wc_app(), streaming=True, flow="sort", device="cpu")
    with pytest.raises(ValueError, match="stream"):
        plan_execution(wc_app(), streaming=True, flow="reduce",
                       device="cpu")
    bad = T.make_app(  # order-dependent: no combiner, so no stream
        lambda item, emit: emit(item % 8, item.to(F32)),
        lambda k, v, c: v[0] - v[-1], key_space=8,
        value_spec=T.ValueSpec((), F32), emit_capacity=1)
    with pytest.raises(ValueError, match="derivation failed"):
        T.MapReduce(bad, streaming=True, device="cpu")
    mr = T.MapReduce(wc_app(), streaming=True, device="cpu",
                     n_pairs_hint=1 << 24)
    assert mr.plan.flow == "stream"
    assert mr.plan.reason.endswith("; streaming pins the stream flow")


def test_streaming_and_local_plans_never_share_an_entry():
    local = T.MapReduce(wc_app(), device="cpu")
    stream = T.MapReduce(wc_app(), streaming=True, device="cpu")
    assert local.plan.cache_key != stream.plan.cache_key
    assert "streaming pins" not in local.plan.reason


def test_service_rejects_non_stream_plan():
    mr = T.MapReduce(wc_app(), flow="combine", device="cpu")
    with pytest.raises(ValueError, match="stream"):
        MapReduceService(mr, batch_capacity=B)


def test_serve_defaults_to_the_card():
    """Without ``device="cpu"`` the service needs a card (this test is
    about a machine without one)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MapReduce(wc_app(), streaming=True).serve(batch_capacity=B)


def test_snapshot_returns_mapreduce_result():
    svc = serve(wc_app(), batch_capacity=B)
    svc.ingest(np.zeros((B,), np.int32))
    res = svc.snapshot()
    assert isinstance(res, T.MapReduceResult)
    assert res.plan is not None and res.plan.flow == "stream"
    assert isinstance(res.diagnostics, tuple)
    assert res.batch_id == 1
    assert T.MapReduce(wc_app(), device="cpu").run(
        np.zeros((B,), np.int32)).batch_id is None


def test_explain_reports_service_surface():
    with tempfile.TemporaryDirectory() as d:
        svc = serve(wc_app(), batch_capacity=B, window=sliding(6, 3),
                    ckpt_dir=d, ckpt_every=5)
        svc.ingest(np.zeros((B,), np.int32))
        text = svc.explain()
        for part in ("mode: streaming", "plan-cache:", "compiled-cache:",
                     "window: sliding size=6 slide=3",
                     "residency: holder tables", "int64", "every 5 batches",
                     f"batch_capacity={B}"):
            assert part in text, (part, text)


@pytest.mark.parametrize("fused", [True, False])
def test_global_service_count_bound_past_2_24(fused):
    """A global service folds one key past 2^24 pairs.  The fused f32
    accumulator (kernels on; here their plain versions) holds a count
    exactly only up to 2^24: ``counts_exact`` turns false once a slot
    can hold more, ``explain()`` says so, and the count is then the f32
    sum of the ingests' exact per-batch counts.  int32 counts (kernels
    off) stay exact and keep the flag."""
    n = (1 << 21) + 1  # odd per-batch counts: past 2^24 they round
    app = T.make_app(lambda item, emit: emit(item[0], item[1]),
                     lambda k, v, c: v.sum(), key_space=2,
                     value_spec=T.ValueSpec((), F32), emit_capacity=1)
    svc = T.MapReduce(app, streaming=True, device="cpu",
                      use_kernels=fused).serve(batch_capacity=n)
    batch = (np.zeros(n, np.int32), np.ones(n, np.float32))
    f32_count = np.float32(0)
    for i in range(9):
        svc.ingest(batch)
        f32_count = np.float32(f32_count + np.float32(n))
        assert svc.counts_exact == (not fused or (i + 1) * n <= 1 << 24)
    assert svc.collector.fused_acc == fused
    assert svc.count_limit() == ((1 << 24) if fused else (1 << 31) - 1)
    assert svc.slot_pairs_bound() == 9 * n
    text = svc.explain()
    assert ("PAST the bound" in text) == fused, text
    assert ("window=None never resets" in text) == fused, text
    got = int(host(svc.snapshot().counts)[0])
    assert got == (int(f32_count) if fused else 9 * n)
    if fused:
        assert got != 9 * n  # the bound is real, not only reported
    # a window bounds a slot at `slide` batches whatever was ingested
    win = T.MapReduce(app, streaming=True, device="cpu",
                      use_kernels=fused).serve(batch_capacity=n,
                                               window=sliding(4, 2))
    win.ingest(batch)
    assert win.slot_pairs_bound() == n and win.counts_exact


def test_streaming_compiled_rejects_batch_call():
    svc = serve(wc_app(), batch_capacity=B)
    svc.ingest(np.zeros((B,), np.int32))
    with pytest.raises(TypeError, match="MapReduceService"):
        svc._compiled(np.zeros((B,), np.int32))
    # its introspection describes one full micro-batch
    assert f"chunk loop: 1 chunk(s) of {B} pairs" in svc._compiled.as_text()
    mem = svc._compiled.memory_analysis()
    assert mem["warmup_peak_bytes"] is None and mem["model_peak_bytes"] > 0


def test_unwindowed_snapshot_before_ingest_is_empty():
    svc = serve(wc_app(), batch_capacity=B,
                item_spec=pc.TensorSpec((), I32))
    res = svc.snapshot()
    assert res.batch_id == 0
    assert int(host(res.counts).sum()) == 0
    win = serve(wc_app(), batch_capacity=B, window=sliding(4, 2),
                item_spec=torch.zeros((), dtype=I32))
    assert int(host(win.snapshot().counts).sum()) == 0


def test_field_access_emits_no_deprecation():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        svc = serve(wc_app(), batch_capacity=B)
        svc.ingest(np.zeros((B,), np.int32))
        res = svc.snapshot()
        res.keys, res.values, res.counts  # noqa: B018
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]


# ---------------------------------------------------------------------------
# The reference's service and the port's, on the same batches
# ---------------------------------------------------------------------------

SCENARIOS = {
    "global_ragged": (None, [B, 7, 0, 1, 33, B, B, 12]),
    "sliding_ragged": ((4, 2), [B, 7, 0, B, 1, 33, B, 12, B]),
    "tumbling": ((2, 2), [B] * 5),
}


def _window(pkg, cfg):
    if cfg is None:
        return None
    return pkg.sliding(*cfg)


def assert_matches_reference(name, want, got):
    """Counts, integer results and max/min bit for bit (values, not
    dtypes: C.5); float sums within FLOAT_TOL."""
    np.testing.assert_array_equal(host(got.counts), np.asarray(want.counts))
    w, g = np.asarray(want.values), host(got.values)
    if w.dtype.kind == "f" and name != "max_f32":
        np.testing.assert_allclose(g, w, **FLOAT_TOL)
    elif w.dtype.kind == "f":
        assert_bits(w, g)
    else:
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_service_matches_reference_service(name, scenario):
    """Every snapshot along the way, ragged and empty batches included."""
    _, _, dt, width = SPECS[name]
    cfg, sizes = SCENARIOS[scenario]
    rng = np.random.default_rng(100 + sorted(SPECS).index(name))
    batches = kv_batches(rng, sizes, dtype=getattr(np, dt), width=width)
    ref = J.MapReduce(ref_spec_app(name), streaming=True).serve(
        batch_capacity=B, window=_window(JS, cfg))
    svc = serve(port_spec_app(name), batch_capacity=B,
                window=_window(T.streaming, cfg))
    for keys, vals in batches:
        ref.ingest((jnp.asarray(keys), jnp.asarray(vals)))
        svc.ingest((keys, vals))
        want, got = ref.snapshot(), svc.snapshot()
        assert got.batch_id == want.batch_id
        assert_matches_reference(name, want, got)


# ---------------------------------------------------------------------------
# Held snapshots and states keep their bits
# ---------------------------------------------------------------------------

#: collector mode -> (reduce, value dtype, use_kernels, extra app attrs)
MODES = {
    "size": (lambda k, v, c: c, I32, False, {}),
    "fused": (lambda k, v, c: v.sum(), F32, True, {}),
    "additive": (lambda k, v, c: v.sum(), I32, False, {}),
    "dense": (lambda k, v, c: v.amax(0), F32, False, {}),
    "dense_kernel": (lambda k, v, c: v.amax(0), F32, True, {}),
    "scatter": (lambda k, v, c: v.amax(0), F32, False, {}),
    "first": (lambda k, v, c: v[0], F32, False, {}),
    "sequential": (lambda k, v, c: torch.logsumexp(v, 0), F32, False,
                   {"manual_combiner": TC.logsumexp_spec()}),
}


def _leaf_copies(tree):
    from repro_torch.checkpoint import ckpt

    leaves, _ = ckpt.flatten(tree)
    return leaves, [t.clone() for t in leaves]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_held_snapshot_and_state_keep_their_bits(mode, monkeypatch):
    """A snapshot and a whole generation of slot states held by a reader
    keep their bits while the service ingests five more batches (empty
    ones among them): no collector mode writes through a state."""
    fn, dtype, kern, attrs = MODES[mode]
    if mode == "scatter":  # no dense expansion fits: exact scatters
        monkeypatch.setattr(TCOL, "DENSE_FOLD_ELEMS_BUDGET", 1)
    app = kv_app(fn, T.ValueSpec((), dtype), **attrs)
    svc = T.MapReduce(app, streaming=True, device="cpu",
                      use_kernels=kern).serve(batch_capacity=B,
                                              window=sliding(4, 2))
    rng = np.random.default_rng(sorted(MODES).index(mode))
    np_dt = np.int32 if dtype == I32 else np.float32
    first, later = (kv_batches(rng, [B, 0, 9], dtype=np_dt),
                    kv_batches(rng, [B, 0, 17, 0, B], dtype=np_dt))
    for b in first:
        svc.ingest(b)
    comb = svc.collector
    want_mode = mode.split("_")[0]
    assert (("fused" if comb.fused_acc else comb.mode) == want_mode), (
        comb.mode, comb.fused_acc)
    snap = svc.snapshot()
    held = svc._state
    snap_leaves, snap_copy = _leaf_copies((snap.keys, snap.values,
                                           snap.counts))
    state_leaves, state_copy = _leaf_copies(list(held.slots))
    for b in later:
        svc.ingest(b)
    svc.snapshot()
    assert svc.batch_id == 8
    for got, want in zip(snap_leaves + state_leaves, snap_copy + state_copy):
        assert_bits(want, got)


# ---------------------------------------------------------------------------
# merge_partial_tables against the reference's
# ---------------------------------------------------------------------------

K = 29


def _manual_reapply(pkg):
    """A sum with no merge and the reapply contract."""
    return dataclasses.replace(pkg.sum_spec(), merge=None, reapply_ok=True)


#: path -> (port reduce, JAX reduce, dtype, shape, spec of each side)
MERGES = {
    "monoid_bbox": (lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
                    lambda k, v, c: jnp.concatenate([jnp.max(v, 0),
                                                     jnp.min(v, 0)]),
                    "float32", (2,), None),
    "monoid_int_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                       "int32", (), None),
    "monoid_centroid": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(F32),
                        lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1),
                        "float32", (3,), None),
    "merge_first": (lambda k, v, c: v[0], lambda k, v, c: v[0], "float32",
                    (), None),
    "reapply_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                    "int32", (), _manual_reapply),
}


@pytest.mark.parametrize("path", sorted(MERGES))
def test_merge_partial_tables_matches_reference(path):
    tfn, jfn, dt, shape, manual = MERGES[path]
    tv = TC.ValueSpec(shape, getattr(torch, dt))
    jv = jax.ShapeDtypeStruct(shape, getattr(jnp, dt))
    tattrs = ({"manual_combiner": manual(TC)} if manual else {})
    jattrs = ({"manual_combiner": manual(JC)} if manual else {})
    tapp = T.make_app(lambda item, emit: None, tfn, key_space=K,
                      value_spec=tv, emit_capacity=1, **tattrs)
    japp = J.make_app(map_fn=lambda item, emit: None, reduce_fn=jfn,
                      key_space=K, value_aval=jv, emit_capacity=1, **jattrs)
    tspec = T.MapReduce(tapp, flow="stream", device="cpu").plan.spec
    # uncached: the reference's plan key does not name a manual combiner
    jspec = J.MapReduce(japp, flow="stream", cache=False).plan.spec
    assert (tspec.monoids is None) == (jspec.monoids is None)
    assert (tspec.merge is None) == (jspec.merge is None)
    tc = TCOL.StreamCombiner(tspec, K, tv, device="cpu")
    jc = JCOL.StreamCombiner(jspec, K, jv)
    rng = np.random.default_rng(len(path))
    ttabs, tcnts, jtabs, jcnts = [], [], [], []
    for n in (60, 5, 7, 40):
        keys = rng.integers(0, K + 1, size=n).astype(np.int32)
        if n == 7:  # a partial with no valid pair (sentinel keys only)
            keys[:] = K
        if dt == "int32":
            vals = rng.integers(-9, 9, size=(n,) + shape).astype(np.int32)
        else:
            vals = rng.standard_normal((n,) + shape).astype(np.float32)
        ts = tc.fold_chunk(tc.init_state(), TCOL.PairStream(
            torch.from_numpy(keys), torch.from_numpy(vals), K))
        js = jc.fold_chunk(jc.init_state(), JCOL.PairStream(
            jnp.asarray(keys), jnp.asarray(vals), K))
        (t, c), (jt, jcn) = tc.tables_counts(ts), jc.tables_counts(js)
        ttabs.append(t)
        tcnts.append(c)
        jtabs.append(jt)
        jcnts.append(jcn)
    tk, tvals, tcount = TENG.merge_partial_tables(tapp, tspec, ttabs, tcnts)
    jk, jvals, jcount = JENG.merge_partial_tables(japp, jspec, jtabs, jcnts)
    np.testing.assert_array_equal(host(tk), np.asarray(jk))
    np.testing.assert_array_equal(host(tcount), np.asarray(jcount))
    w, g = np.asarray(jvals), host(tvals)
    if path == "monoid_centroid":
        np.testing.assert_allclose(g, w, **FLOAT_TOL)
    elif w.dtype.kind == "f":
        assert_bits(w, g)
    else:
        np.testing.assert_array_equal(g, w)
