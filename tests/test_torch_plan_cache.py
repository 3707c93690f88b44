"""The port's content-keyed plan cache, case by case as
``tests/core/test_plan_cache.py``: keying, the counters that show a warm
repeat derives, tunes, probes and prepares nothing, the corrupt-safe file
layer (also against entries made on another card), cached runs bitwise
equal to cold ones in every flow, and the measured probe with its tune
cache.  Cached results are also held against ``repro.core``'s."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import autotune as tat  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402


def build_app(vocab=64, dtype=torch.int32):
    return T.make_app(
        lambda item, emit: emit.emit(item % vocab,
                                     torch.ones((), dtype=dtype)),
        lambda k, vs, n: vs.sum(), key_space=vocab,
        value_spec=T.ValueSpec((), dtype))


def jbuild_app(vocab=64):
    return J.make_app(
        lambda item, emit: emit.emit(item % vocab, jnp.ones((), jnp.int32)),
        lambda k, vs, n: vs.sum(), key_space=vocab,
        value_aval=jax.ShapeDtypeStruct((), jnp.int32))


@pytest.fixture(scope="module")
def items():
    rng = np.random.default_rng(3)
    return rng.integers(0, 64, size=2500).astype(np.int32)


def delta(fn):
    s0 = pc.stats_snapshot()
    out = fn()
    s1 = pc.stats_snapshot()
    return out, {k: s1[k] - s0[k] for k in s1}


def cpu_mr(app, **kw):
    return T.MapReduce(app, device="cpu", **kw)


def test_warm_repeat_zero_rederive_zero_autotune(items):
    pc.clear()
    cold = cpu_mr(build_app()).run(items)
    hot, d = delta(lambda: cpu_mr(build_app()).run(items))
    assert d["derives"] == 0, "a plan-cache hit must skip the optimizer"
    assert d["autotunes"] == 0, "a plan-cache hit must skip the tiling"
    assert d["probes"] == 0
    assert d["compiles"] == 0, "a compiled-cache hit prepares nothing"
    assert d["plan_hits"] == 1 and d["hits"] == 1
    assert torch.equal(cold.values, hot.values)
    want = J.MapReduce(jbuild_app()).run(jnp.asarray(items))
    np.testing.assert_array_equal(hot.values.numpy(), np.asarray(want.values))


def test_hit_is_recorded_on_the_plan(items):
    pc.clear()
    first = cpu_mr(build_app())
    assert first.plan.cache_event == "miss" and first.plan.stage == "planned"
    second = cpu_mr(build_app())
    assert second.plan.cache_event == "hit"
    assert second.plan is not first.plan
    assert f"plan-cache: hit key={second._plan_key}" in second.explain()


def test_changed_key_space_misses():
    pc.clear()
    cpu_mr(build_app(vocab=64))
    _, d = delta(lambda: cpu_mr(build_app(vocab=128)))
    assert d["plan_misses"] == 1 and d["plan_hits"] == 0


def test_changed_dtype_misses():
    pc.clear()
    cpu_mr(build_app(dtype=torch.int32))
    _, d = delta(lambda: cpu_mr(build_app(dtype=torch.float32)))
    assert d["plan_misses"] == 1 and d["plan_hits"] == 0


def test_changed_flow_misses():
    pc.clear()
    app = build_app()
    cpu_mr(app, flow="stream")
    _, d = delta(lambda: cpu_mr(app, flow="sort"))
    assert d["plan_misses"] == 1 and d["plan_hits"] == 0


def test_changed_use_kernels_misses():
    pc.clear()
    app = build_app()
    cpu_mr(app)
    _, d = delta(lambda: cpu_mr(app, use_kernels=True))
    assert d["plan_misses"] == 1 and d["plan_hits"] == 0


def test_plan_key_names_the_device_and_use_kernels():
    """The ``cpu`` and ``cuda`` profiles plan differently: a plan made for
    one device type never serves the other."""
    app = build_app()
    kw = dict(flow="auto", trust_semantics=False, n_pairs_hint=1 << 20,
              combine_impl="auto", chunk_pairs="auto", key_block="auto",
              autotune_probe=False)
    keys = {pc.plan_key(app, use_kernels=k, device=d, **kw)
            for k in (False, True) for d in ("cpu", "cuda")}
    assert len(keys) == 4


def test_compiled_key_distinguishes_shape_device_and_mode(items):
    app = build_app()
    spec = pc.items_spec_of(items)
    pk = pc.plan_key(app, flow="auto", trust_semantics=False,
                     n_pairs_hint=None, use_kernels=False,
                     combine_impl="auto", chunk_pairs="auto",
                     key_block="auto", autotune_probe=False, device="cpu")
    base = pc.compiled_key(app, spec, plan_key=pk, flow="stream",
                           n_bucket=2500, device="cpu")
    other_shape = pc.compiled_key(app, pc.items_spec_of(items[:-100]),
                                  plan_key=pk, flow="stream", n_bucket=2400,
                                  device="cpu")
    other_device = pc.compiled_key(app, spec, plan_key=pk, flow="stream",
                                   n_bucket=2500, device="cuda:0")
    other_mode = pc.compiled_key(app, spec, plan_key=pk, flow="stream",
                                 n_bucket=2500, device="cpu",
                                 mode="pipeline")
    assert len({base, other_shape, other_device, other_mode}) == 4


def test_closure_constants_are_part_of_the_key(items):
    """Two maps, and two reducers, that differ only in a captured tensor
    must not collide: the constants' bytes enter the signature."""
    def with_bias(bias):
        arr = torch.full((), bias, dtype=torch.int32)
        scale = torch.full((), bias + 1, dtype=torch.int32)
        return T.make_app(
            lambda item, emit: emit.emit((item + arr) % 64,
                                         torch.ones((), dtype=torch.int32)),
            lambda k, vs, n: vs.sum() * scale, key_space=64,
            value_spec=T.ValueSpec((), torch.int32))

    a, b, a2 = with_bias(0), with_bias(3), with_bias(0)
    spec = pc.item_spec_of(pc.items_spec_of(items))
    assert pc.map_fingerprint(a, spec) != pc.map_fingerprint(b, spec)
    assert pc.reduce_fingerprint(a) != pc.reduce_fingerprint(b)
    assert pc.map_fingerprint(a, spec) == pc.map_fingerprint(a2, spec)
    assert pc.reduce_fingerprint(a) == pc.reduce_fingerprint(a2)


def test_untraceable_fallback_keys_unique_and_stable(items):
    """A map or reduce the tracer refuses keys on a per-app uid: stable on
    one app, never shared between two."""
    def bad_map(item, emit):
        if int(item) > 0:  # a host branch on the item: untraceable
            emit.emit(item, torch.ones((), dtype=torch.int32))

    def bad_reduce(k, vs, n):
        return vs.sum() if int(n) > 0 else vs.sum()

    def build():
        return T.make_app(bad_map, bad_reduce, key_space=64,
                          value_spec=T.ValueSpec((), torch.int32))

    a, b = build(), build()
    spec = pc.item_spec_of(pc.items_spec_of(items))
    assert pc.reduce_fingerprint(a) == pc.reduce_fingerprint(a)
    assert pc.reduce_fingerprint(a) != pc.reduce_fingerprint(b)
    assert pc.map_fingerprint(a, spec) == pc.map_fingerprint(a, spec)
    assert pc.map_fingerprint(a, spec) != pc.map_fingerprint(b, spec)


def test_manual_combiner_is_part_of_the_plan_key():
    pc.clear()
    cpu_mr(build_app())
    app = build_app()
    app.manual_combiner = T.count_spec()
    mr = cpu_mr(app)
    assert mr.plan.cache_event == "miss"
    assert mr.plan.reason == "manual combiner"


def test_cache_false_bypasses(items):
    pc.clear()
    app = build_app()

    def cold():
        mr = cpu_mr(app, cache=False)
        return mr.run(items, options=T.ExecutionOptions(cache=False))

    _, d1 = delta(cold)
    _, d2 = delta(cold)
    assert d2["derives"] == d1["derives"] == 1 and d2["compiles"] == 1
    assert d2["hits"] == 0 and d2["plan_hits"] == 0
    assert pc.sizes() == (0, 0)


@pytest.mark.parametrize("flow", ["stream", "sort", "combine", "reduce"])
def test_cached_plan_bitwise_identical(flow, items):
    pc.clear()
    cold = cpu_mr(build_app(), flow=flow).run(items)
    hot, d = delta(lambda: cpu_mr(build_app(), flow=flow).run(items))
    assert d["derives"] == 0 and d["compiles"] == 0 and d["autotunes"] == 0
    for a, b in ((cold.keys, hot.keys), (cold.values, hot.values),
                 (cold.counts, hot.counts)):
        assert torch.equal(a, b)
    want = J.MapReduce(jbuild_app(), flow=flow).run(jnp.asarray(items))
    np.testing.assert_array_equal(hot.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(hot.counts.numpy(), np.asarray(want.counts))


# ---------------------------------------------------------------------------
# The file layer
# ---------------------------------------------------------------------------


def test_file_layer_round_trip(tmp_path, monkeypatch, items):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(pc.PLAN_CACHE_ENV, str(path))
    pc.clear()
    mr, d0 = delta(lambda: cpu_mr(build_app(), autotune_probe=True))
    mr.run(items)
    assert mr.plan.flow == "stream"
    assert d0["probes"] == 1, "a cold construction measures the probe"
    data = json.loads(path.read_text())
    entry = data[mr._plan_key]
    assert entry["flow"] == "stream" and isinstance(entry["chunk_pairs"], int)
    assert "card" not in entry  # made on the CPU
    pc.clear()  # a fresh process: the file stays
    fresh, d = delta(lambda: cpu_mr(build_app(), autotune_probe=True))
    assert d["file_hits"] == 1
    assert d["probes"] == 0, "a file-pinned tiling skips the probe"
    assert fresh.plan.cache_event == "file-hit"
    assert fresh.tiling.chunk_pairs == entry["chunk_pairs"]


def test_file_layer_corrupt_is_ignored(tmp_path, monkeypatch, items):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(pc.PLAN_CACHE_ENV, str(path))
    path.write_text("{this is not json")
    pc.clear()
    res = cpu_mr(build_app()).run(items)  # must not raise
    assert int(res.counts.sum()) == items.shape[0]


def _poisoned(tmp_path, monkeypatch, entry):
    path = tmp_path / "plans.json"
    monkeypatch.setenv(pc.PLAN_CACHE_ENV, str(path))
    pc.clear()
    mr = cpu_mr(build_app())
    path.write_text(json.dumps({mr._plan_key: entry}))
    pc.clear()
    return delta(lambda: cpu_mr(build_app()))


@pytest.mark.parametrize("entry", [
    {"flow": "stream", "chunk_pairs": "not-an-int"},  # a stale schema
    {"flow": "warp-drive", "chunk_pairs": 2048},  # an unknown flow
    {"flow": "stream", "chunk_pairs": 2048, "card": 7},  # a bad card field
])
def test_file_layer_malformed_entry_is_ignored(tmp_path, monkeypatch,
                                               entry):
    fresh, d = _poisoned(tmp_path, monkeypatch, entry)
    assert d["file_hits"] == 0, "a malformed entry reads as no entry"
    assert fresh.plan.cache_event == "miss"


def test_file_layer_other_card_entry_is_ignored(tmp_path, monkeypatch):
    """An entry measured on a card reads as no entry anywhere else."""
    fresh, d = _poisoned(tmp_path, monkeypatch, {
        "flow": "stream", "chunk_pairs": 2048,
        "card": "NVIDIA A100-SXM4-40GB, 400.00 W"})
    assert d["file_hits"] == 0
    assert fresh.plan.cache_event == "miss"
    assert fresh.tiling.chunk_pairs != 2048


# ---------------------------------------------------------------------------
# The measured probe and its tune cache
# ---------------------------------------------------------------------------


def test_probe_stores_its_choice_then_hits_it(tmp_path, monkeypatch, items):
    path = tmp_path / "tune.json"
    monkeypatch.setenv(tat.TUNE_CACHE_ENV, str(path))
    pc.clear()
    mr, d = delta(lambda: cpu_mr(build_app(), autotune_probe=True))
    assert d["probes"] == 1 and mr.tiling.source == "probe"
    assert any(n.startswith("probe: measured") for n in mr.tiling.notes)
    key = tat.tune_cache_key(mr.app, mr.plan.spec, use_kernels=False,
                             device="cpu")
    stored = json.loads(path.read_text())[key]
    assert stored["chunk_pairs"] == mr.tiling.chunk_pairs
    pc.clear()  # a fresh process: the tune cache file stays
    again, d = delta(lambda: cpu_mr(build_app(), autotune_probe=True))
    assert d["probes"] == 0 and again.tiling.source == "cache"
    assert again.tiling.chunk_pairs == stored["chunk_pairs"]
    assert torch.equal(mr.run(items).values, again.run(items).values)


def test_probe_notes_items_that_fit_no_map_shape():
    """The synthetic items are checked against the map before any run; a
    map none of their shapes fits keeps the model's choice, noted."""
    def picky(item, emit):
        a, b, c = item  # a three-field item: no synthetic shape fits
        emit.emit(a, b + c)

    app = T.make_app(picky, lambda k, vs, n: vs.sum(), key_space=8,
                     value_spec=T.ValueSpec((), torch.float32))
    pc.clear()
    mr = cpu_mr(app, autotune_probe=True)
    assert mr.tiling.source == "model"
    assert any("fit no item shape" in n for n in mr.tiling.notes)


def test_probe_propagates_a_failing_run(monkeypatch):
    """The reference swallows a candidate that fails; the port raises, so
    a failing kernel cannot hide behind the model's choice."""
    def broken(*a, **kw):
        raise RuntimeError("fold failed")

    monkeypatch.setattr(teng, "stream_local_tables", broken)
    pc.clear()
    with pytest.raises(RuntimeError, match="fold failed"):
        cpu_mr(build_app(), autotune_probe=True)


def test_probe_items_shape_kmeans():
    """KMeans items are ``(cid, point)`` pairs: the synthetic items take
    that shape, the probe measures three candidates."""
    from repro_torch import apps as tapps

    items, why = tat.synthetic_items(tapps.KMeans(), 16, "cpu")
    assert why == "" and isinstance(items, tuple)
    assert items[0].shape == (16,) and items[1].shape == (16, 3)
    pc.clear()
    notes = []
    best, t_us = tat._probe_chunk(tapps.KMeans(), cpu_mr(
        tapps.KMeans()).plan.spec, 256, device="cpu", use_kernels=False,
        key_block=None, probe_pairs=2048, notes=notes)
    assert best in (128, 256, 512) and t_us > 0
    assert notes[-1].startswith("probe: measured 128: ")
