"""Multi-job pipelines of the port, case by case as
``tests/core/test_pipeline.py``: the consumer map's semantics against the
reference's ``extract_semantics``, fused against unfused bit for bit and
against ``repro.core.Pipeline``, dead-column elimination, the ``where=``
pushdown, a three-stage chain, and the byte models: unfused exactly the
reference's, fused with the table still crossing device memory (ROADMAP
C.33), ``pipeline_handoff_bytes`` and the ``cpu`` ``pipeline_overhead_s``
exactly the reference's."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.roofline import analysis as jroof  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.core.pipeline import extract_semantics  # noqa: E402
from repro_torch.roofline import analysis as troof  # noqa: E402

VOCAB = 64
BUCKETS = 16
I32 = torch.int32
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def wordcount():
    return T.make_app(
        lambda item, emit: emit.emit(item % VOCAB, torch.ones((), dtype=I32)),
        lambda k, vs, n: vs.sum(), key_space=VOCAB,
        value_spec=T.ValueSpec((), I32))


def histogram():
    """A second job reading the VALUE column of the word-count table."""
    def hist_map(item, emit):
        count = item[1]
        emit.emit(torch.clamp(count // 8, 0, BUCKETS - 1).to(I32),
                  torch.ones((), dtype=I32))

    return T.make_app(hist_map, lambda k, vs, n: vs.sum(),
                      key_space=BUCKETS, value_spec=T.ValueSpec((), I32))


def key_presence():
    """A second job reading only the KEY column: the value column is
    dead."""
    def pres_map(item, emit):
        emit.emit(item[0] % 8, torch.ones((), dtype=I32))

    return T.make_app(pres_map, lambda k, vs, n: vs.sum(), key_space=8,
                      value_spec=T.ValueSpec((), I32))


def jwordcount():
    return J.make_app(
        lambda item, emit: emit.emit(item % VOCAB, jnp.ones((), jnp.int32)),
        lambda k, vs, n: vs.sum(), key_space=VOCAB,
        value_aval=jax.ShapeDtypeStruct((), jnp.int32))


def jhistogram():
    def hist_map(item, emit):
        emit.emit(jnp.clip(item[1] // 8, 0, BUCKETS - 1).astype(jnp.int32),
                  jnp.ones((), jnp.int32))

    return J.make_app(hist_map, lambda k, vs, n: vs.sum(),
                      key_space=BUCKETS,
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32))


def jkey_presence():
    return J.make_app(
        lambda item, emit: emit.emit(item[0] % 8, jnp.ones((), jnp.int32)),
        lambda k, vs, n: vs.sum(), key_space=8,
        value_aval=jax.ShapeDtypeStruct((), jnp.int32))


PAIRS = {"histogram": (histogram, jhistogram),
         "key_presence": (key_presence, jkey_presence)}


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(11)
    return (rng.integers(0, 5 * VOCAB, size=6000) % VOCAB).astype(np.int32)


def pipe(*jobs, where=None):
    p = T.Pipeline(jobs[0], device="cpu")
    for i, job in enumerate(jobs[1:]):
        p.then(job, where=where if i == 0 else None)
    return p


def bits(t):
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(a, b):
    for x, y in ((a.keys, b.keys), (a.values, b.values),
                 (a.counts, b.counts)):
        assert torch.equal(bits(x), bits(y))


def assert_reference(got, want, exact=True):
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    if exact:
        np.testing.assert_array_equal(got.values.numpy(),
                                      np.asarray(want.values))
    else:
        np.testing.assert_allclose(got.values.numpy(),
                                   np.asarray(want.values), **SUM_TOL)


# ---------------------------------------------------------------------------
# Semantics extraction
# ---------------------------------------------------------------------------

ROW = (pc.TensorSpec((), I32),) * 3
JROW = (jax.ShapeDtypeStruct((), jnp.int32),) * 3


@pytest.mark.parametrize("name", list(PAIRS))
def test_semantics_equal_the_reference(name):
    tapp, japp = PAIRS[name]
    got = extract_semantics(tapp(), ROW)
    want = jpipe.extract_semantics(japp(), JROW)
    assert dataclasses_fields(got) == dataclasses_fields(want)


def dataclasses_fields(sem):
    return (sem.reads_key, sem.reads_value, sem.reads_count,
            sem.key_passthrough, sem.select_guard)


def test_semantics_value_reader():
    sem = extract_semantics(histogram(), ROW)
    assert sem.reads_value and not sem.reads_key


def test_semantics_key_only_reader():
    sem = extract_semantics(key_presence(), ROW)
    assert sem.reads_key and not sem.reads_value and sem.key_passthrough


def test_semantics_masked_emission_reads_the_count():
    """A map that masks its emission on the count reads the count column
    and guards its key channel."""
    def masked_map(item, emit):
        emit.emit(item[0] % 8, torch.ones((), dtype=I32),
                  valid=item[2] > 1)

    app = T.make_app(masked_map, lambda k, vs, n: vs.sum(), key_space=8,
                     value_spec=T.ValueSpec((), I32))
    sem = extract_semantics(app, ROW)
    assert sem.select_guard and sem.reads_count and not sem.reads_value


# ---------------------------------------------------------------------------
# Fused execution
# ---------------------------------------------------------------------------


def test_fused_matches_unfused_value_consumer(items):
    p = pipe(wordcount(), histogram())
    got = p.run(items)
    assert_same(got, p.run_unfused(items))
    want = J.Pipeline(jwordcount()).then(jhistogram()).run(
        jnp.asarray(items))
    assert_reference(got, want)


def test_fused_matches_unfused_dead_value(items):
    p = pipe(wordcount(), key_presence())
    got = p.run(items)
    assert_same(got, p.run_unfused(items))
    assert p.stages[1].dead_value
    assert any("dead column eliminated" in line
               for line in p.fusion_report())
    want = J.Pipeline(jwordcount()).then(jkey_presence()).run(
        jnp.asarray(items))
    assert_reference(got, want)


def test_fused_matches_separate_jobs(items):
    """The fused run equals independent ``MapReduce`` runs of the port (the
    live rows of the first table fed to the second job), as the
    reference's test holds for its own."""
    stage1 = T.MapReduce(wordcount(), device="cpu").run(items)
    mask = stage1.counts > 0
    table = (stage1.keys[mask], stage1.values[mask].to(I32),
             stage1.counts[mask])
    want = T.MapReduce(histogram(), device="cpu").run(table)
    got = pipe(wordcount(), histogram()).run(items)
    assert torch.equal(got.values, want.values)
    assert torch.equal(got.counts, want.counts)


def test_filter_pushdown(items):
    p = pipe(wordcount(), histogram(),
             where=lambda key, value, count: value > 90)
    got = p.run(items)
    assert_same(got, p.run_unfused(items))
    assert any("filter pushed below the shuffle" in line
               for line in p.fusion_report())
    want = J.Pipeline(jwordcount()).then(
        jhistogram(), where=lambda key, value, count: value > 90).run(
        jnp.asarray(items))
    assert_reference(got, want)


def test_value_filter_disables_dead_column(items):
    """The edge predicate reads the value column even when the consumer's
    map does not: the column stays live, or ``where`` would read zeros."""
    p = pipe(wordcount(), key_presence(),
             where=lambda key, value, count: value > 90)
    assert not p.stages[1].dead_value
    assert not any("dead column eliminated" in line
                   for line in p.fusion_report())
    assert_same(p.run(items), p.run_unfused(items))


def test_three_stage_chain(items):
    p = pipe(wordcount(), histogram(), key_presence())
    got = p.run(items)
    assert_same(got, p.run_unfused(items))
    want = J.Pipeline(jwordcount()).then(jhistogram()).then(
        jkey_presence()).run(jnp.asarray(items))
    assert_reference(got, want)


@pytest.mark.parametrize("flow", ["stream", "sort", "combine", "reduce"])
def test_f32_sums_fused_equal_unfused(flow):
    """Per-key f32 sums, then a histogram weighted by each sum (it reads
    the value column), the first stage in each flow: fused and unfused
    give the same bits, and the reference's pipeline within the sums'
    tolerance."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 256, size=(800, 4)).astype(np.int32)
    weights = rng.standard_normal((800, 4)).astype(np.float32)

    def sums_app():
        return T.make_app(lambda item, emit: emit(item[0], item[1]),
                          lambda k, v, c: v.sum(0), key_space=256,
                          value_spec=T.ValueSpec((), torch.float32),
                          emit_capacity=4)

    def weighted():
        def m(item, emit):
            b = torch.clamp(((item[1] + 8.0) * 2.0).to(I32), 0, 31)
            emit(b, item[1])
        return T.make_app(m, lambda k, v, c: v.sum(0), key_space=32,
                          value_spec=T.ValueSpec((), torch.float32),
                          emit_capacity=1)

    p = T.Pipeline(T.MapReduce(sums_app(), flow=flow, device="cpu")
                   ).then(weighted())
    got = p.run((keys, weights))
    assert_same(got, p.run_unfused((keys, weights)))

    def jm(item, emit):
        b = jnp.clip(((item[1] + 8.0) * 2.0).astype(jnp.int32), 0, 31)
        emit(b, item[1])
    f32 = jax.ShapeDtypeStruct((), jnp.float32)
    jp = J.Pipeline(J.MapReduce(J.make_app(
        lambda item, emit: emit(item[0], item[1]), lambda k, v, c: v.sum(0),
        key_space=256, value_aval=f32, emit_capacity=4), flow=flow)).then(
        J.make_app(jm, lambda k, v, c: v.sum(0), key_space=32,
                   value_aval=f32, emit_capacity=1))
    want = jp.run((jnp.asarray(keys), jnp.asarray(weights)))
    assert_reference(got, want, exact=False)


# ---------------------------------------------------------------------------
# Byte models, explain, caching
# ---------------------------------------------------------------------------

PINNED = dict(stream_chunk_pairs=2048)  # the reference's tiling at K = 64


def _pipes(name, fused_fields=False):
    tapp, japp = PAIRS[name]
    tp = T.Pipeline(T.MapReduce(wordcount(), device="cpu", **PINNED)).then(
        T.MapReduce(tapp(), device="cpu", **PINNED))
    jp = J.Pipeline(J.MapReduce(jwordcount(), **PINNED)).then(
        J.MapReduce(japp(), **PINNED))
    return tp, jp


@pytest.mark.parametrize("name", list(PAIRS))
def test_model_bytes_unfused_equal_the_reference(name, items):
    """With the tiling pinned to the reference's (the port tiles the CPU
    by its own rule), the unfused count is the reference's exactly."""
    tp, jp = _pipes(name)
    n = items.shape[0]
    assert tp.model_bytes(n, fused=False) == jp.model_bytes(n, fused=False)


def test_model_bytes_fused_follow_c33(items):
    """The port's fused path still writes and reads the [K] table: a live
    edge costs what the unfused one does; a dead edge saves the value
    column's write and read, 2·K·value_bytes."""
    n = items.shape[0]
    live, _ = _pipes("histogram")
    dead, _ = _pipes("key_presence")
    assert live.model_bytes(n, fused=True) == live.model_bytes(n,
                                                               fused=False)
    gap = dead.model_bytes(n, fused=False) - dead.model_bytes(n, fused=True)
    assert gap == 2.0 * VOCAB * 4
    assert gap == (troof.pipeline_handoff_bytes(VOCAB, value_bytes=4)
                   - troof.pipeline_handoff_bytes(VOCAB, value_bytes=4,
                                                  dead_value=True))


def test_dead_column_widens_the_gap(items):
    n = items.shape[0]
    live, _ = _pipes("histogram")
    dead, _ = _pipes("key_presence")
    gap_live = live.model_bytes(n, fused=False) - live.model_bytes(n,
                                                                   fused=True)
    gap_dead = dead.model_bytes(n, fused=False) - dead.model_bytes(n,
                                                                   fused=True)
    assert gap_dead > gap_live == 0


@pytest.mark.parametrize("k,vb,dead", [(64, 4, False), (64, 4, True),
                                       (1 << 16, 12, False),
                                       (1 << 16, 12, True)])
def test_handoff_bytes_equal_the_reference(k, vb, dead):
    assert troof.pipeline_handoff_bytes(k, value_bytes=vb, dead_value=dead) \
        == jroof.pipeline_handoff_bytes(k, value_bytes=vb, dead_value=dead)


@pytest.mark.parametrize("n_stages,handoff,fused", [
    (2, 0.0, True), (2, 1e6, False), (3, 5e5, True), (3, 5e5, False)])
def test_pipeline_overhead_cpu_equals_the_reference(n_stages, handoff,
                                                    fused):
    assert tcm.pipeline_overhead_s(
        n_stages, handoff_bytes=handoff, fused=fused, backend="cpu") == \
        jcm.pipeline_overhead_s(n_stages, handoff_bytes=handoff,
                                fused=fused, backend="cpu")


def test_pipeline_overhead_cuda_profile():
    """``cuda``: a run's fitted host term a dispatch, and the handoff at the
    H100's HBM rate on both paths (C.33)."""
    c = tcm.CUDA_COEFF["dispatch"]
    bw = troof.H100_SXM_HBM_BYTES_PER_S
    assert tcm.pipeline_overhead_s(3, handoff_bytes=1e6, fused=True,
                                   backend="cuda") == c + 1e6 / bw
    assert tcm.pipeline_overhead_s(3, handoff_bytes=1e6, fused=False,
                                   backend="cuda") == 3 * c + 1e6 / bw
    with pytest.raises(ValueError, match="unknown backend"):
        tcm.pipeline_overhead_s(2, backend="tpu")


def test_pipeline_explain_reports_fusion(items):
    p = pipe(wordcount(), histogram())
    p.run(items)
    text = p.explain()
    assert "fused handoff" in text and "stage: pipeline" in text
    assert "not materialized" not in text
    assert "still crosses device memory" in text


def test_pipeline_compile_is_cached(items):
    pc.clear()
    s0 = pc.stats_snapshot()
    pipe(wordcount(), histogram()).run(items)
    s1 = pc.stats_snapshot()
    assert s1["compiles"] - s0["compiles"] == 1
    fresh = pipe(wordcount(), histogram())
    s2 = pc.stats_snapshot()
    fresh.run(items)
    s3 = pc.stats_snapshot()
    assert s3["compiles"] - s2["compiles"] == 0, \
        "an equal pipeline must reuse the prepared fused run"
    assert s3["hits"] - s2["hits"] >= 1
    assert s3["derives"] == s2["derives"]
    assert fresh.stages[-1].mr.plan.cache_event == "hit"


def test_single_stage_pipeline_rejected(items):
    with pytest.raises(ValueError, match="at least two stages"):
        pipe(wordcount()).compile(items)
