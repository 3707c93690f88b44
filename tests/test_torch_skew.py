"""The port's skew planner (``repro_torch.core.skew``) against the
reference's ``repro.core.skew``, on the CPU.

The same histograms and items go through both planners: the sample
indices, the derived boundaries, hot keys, ways, imbalance and largest
destination share, the capacity envelope, ``ShufflePlan.epoch``,
``hot_split_ok`` over the reference's reducers and flows, the resolved
``ShuffleOptions`` (sampled through each package's own map phase) and
the ``explain()`` lines must be equal.  Then the port's own memo, tune
cache file and validation.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
from repro.core import skew as JSK  # noqa: E402
from repro.core.plan import plan_execution as j_plan  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import skew as TSK  # noqa: E402
from repro_torch.core.plan import plan_execution as t_plan  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402

I32, F32 = torch.int32, torch.float32


def histograms():
    """(name, hist) cases: uniform, zipf, one hot key, two hot keys, a
    sparse tail, empty."""
    rng = np.random.default_rng(0)
    out = {"uniform": np.full(64, 10, np.int64),
           "zipf": np.bincount(rng.zipf(1.1, 4096) % 256, minlength=256),
           "sparse": np.bincount(rng.integers(0, 16, 500), minlength=300),
           "empty": np.zeros(32, np.int64)}
    h = np.bincount(rng.integers(0, 128, 2000), minlength=128)
    h[5] += 3000
    out["one_hot"] = h
    h2 = h.copy()
    h2[77] += 1500
    out["two_hot"] = h2
    return out


HISTS = histograms()


@pytest.mark.parametrize("n_items,frac,emit", [
    (10, 0.25, 16), (1000, 0.25, 16), (1 << 20, 0.25, 1), (4096, 1.0, 4),
    (5000, 0.01, 8), (1, 0.5, 1), (777, 0.0, 2)])
def test_sample_indices_equal_reference(n_items, frac, emit):
    assert np.array_equal(TSK._sample_indices(n_items, frac, emit),
                          JSK._sample_indices(n_items, frac, emit))


@pytest.mark.parametrize("n_pairs", [None, 1 << 12, 1 << 20])
@pytest.mark.parametrize("mergeable", [False, True])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(HISTS))
def test_derive_equals_reference(name, shards, mergeable, n_pairs):
    kw = dict(hot_key_split_max=4, mergeable=mergeable, n_pairs=n_pairs)
    t = TSK.derive(HISTS[name], shards, **kw)
    j = JSK.derive(HISTS[name], shards, **kw)
    assert dataclasses.astuple(t) == dataclasses.astuple(j)
    if t.boundaries is None:
        return
    tp = TSK.ShufflePlan(key_space=len(HISTS[name]), num_shards=shards,
                         boundaries=t.boundaries, hot_keys=t.hot_keys,
                         hot_ways=t.hot_ways, imbalance=t.imbalance,
                         max_dest_frac=t.max_dest_frac)
    jp = JSK.ShufflePlan(key_space=len(HISTS[name]), num_shards=shards,
                         boundaries=j.boundaries, hot_keys=j.hot_keys,
                         hot_ways=j.hot_ways, imbalance=j.imbalance,
                         max_dest_frac=j.max_dest_frac)
    assert tp.epoch == jp.epoch and tp.width == jp.width
    assert tp.describe() == jp.describe()
    for n in (100, 4096, 1 << 20):
        assert tp.capacity_for(n) == jp.capacity_for(n)
    for i in range(len(tp.hot_keys)):
        assert tp.hot_dests(i) == jp.hot_dests(i)
    assert interop.shuffle_plan_from_repro(jp) == tp


def kv_apps(name):
    """(reference app, port app) of (key, value) items over 64 keys."""
    jreduce, treduce, jdt, tdt = {
        "sum": (lambda k, v, c: jnp.sum(v), lambda k, v, c: v.sum(),
                jnp.int32, I32),
        "max": (lambda k, v, c: jnp.max(v), lambda k, v, c: v.amax(),
                jnp.float32, F32),
        "min": (lambda k, v, c: jnp.min(v), lambda k, v, c: v.amin(),
                jnp.float32, F32),
        "mean": (lambda k, v, c: jnp.sum(v) / jnp.maximum(c, 1),
                 lambda k, v, c: v.sum() / c.clamp(min=1), jnp.float32,
                 F32),
        "first": (lambda k, v, c: v[0], lambda k, v, c: v[0], jnp.int32,
                  I32),
        "count": (lambda k, v, c: c, lambda k, v, c: c, jnp.int32, I32),
    }[name]
    japp = J.make_app(lambda item, emit: emit(item[0], item[1].astype(jdt)),
                      jreduce, key_space=64,
                      value_aval=jax.ShapeDtypeStruct((), jdt),
                      emit_capacity=1)
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1].to(tdt)),
                      treduce, key_space=64, value_spec=T.ValueSpec((), tdt),
                      emit_capacity=1)
    return japp, tapp


@pytest.mark.parametrize("flow", ["sort", "stream", "combine"])
@pytest.mark.parametrize("name", ["sum", "max", "min", "mean", "first",
                                  "count"])
def test_hot_split_ok_equals_reference(name, flow):
    japp, tapp = kv_apps(name)
    jp = j_plan(japp, flow=flow)
    tp = t_plan(tapp, flow=flow, device="cpu")
    assert TSK.hot_split_ok(flow, tp.spec, tapp.value_spec) == \
        JSK.hot_split_ok(flow, jp.spec, japp.value_aval)
    assert not TSK.hot_split_ok("reduce", None, tapp.value_spec)


def zipf_items(seed, n=2048, hot=None):
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, n) % 64).astype(np.int32)
    if hot is not None:
        keys[rng.random(n) < 0.4] = hot
    vals = rng.integers(-20, 20, n).astype(np.int32)
    return np.stack([keys, vals], axis=1)


@pytest.mark.parametrize("frac", [0.25, 1.0])
@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("flow", ["sort", "reduce"])
@pytest.mark.parametrize("hot", [None, 9])
def test_resolved_options_equal_reference(hot, flow, shards, frac):
    """``resolve_shuffle_options`` through each package's map phase: the
    same resolved record (boundaries, hot keys, ways, imbalance, p-max,
    source) and the same plan epoch."""
    TSK.clear_memo()
    JSK.clear_memo()
    items = zipf_items(shards, hot=hot)
    japp, tapp = kv_apps("sum")
    opts_kw = dict(skew="auto", sample_fraction=frac)
    jr, jprof = JSK.resolve_shuffle_options(
        japp, j_plan(japp, flow=flow), jnp.asarray(items),
        num_shards=shards, options=JSK.ShuffleOptions(**opts_kw))
    tr, tprof = TSK.resolve_shuffle_options(
        tapp, t_plan(tapp, flow=flow, device="cpu"),
        torch.from_numpy(items), num_shards=shards,
        options=TSK.ShuffleOptions(**opts_kw), device="cpu")
    assert repr(tr) == repr(jr)
    assert tprof.describe() == jprof.describe()
    jplan = JSK.plan_from_options(64, shards, jr, flow=flow,
                                  spec=j_plan(japp, flow=flow).spec,
                                  value_aval=japp.value_aval)
    tplan = TSK.plan_from_options(64, shards, tr, flow=flow,
                                  spec=t_plan(tapp, flow=flow,
                                              device="cpu").spec,
                                  value_spec=tapp.value_spec)
    assert (tplan is None) == (jplan is None)
    if tplan is not None:
        assert tplan.epoch == jplan.epoch
        assert tplan.describe() == jplan.describe()


def test_plan_from_options_rejects_hot_keys_it_cannot_merge():
    _, tapp = kv_apps("sum")
    opts = TSK.ShuffleOptions(boundaries=(0, 16, 32, 48, 64), hot_keys=(3,),
                              hot_ways=(2,))
    with pytest.raises(ValueError, match="hot-key splitting"):
        TSK.plan_from_options(64, 4, opts, flow="reduce", spec=None,
                              value_spec=tapp.value_spec)
    plan = TSK.plan_from_options(
        64, 4, opts, flow="sort",
        spec=t_plan(tapp, flow="sort", device="cpu").spec,
        value_spec=tapp.value_spec)
    assert plan.hot_dests(0) == (0, 1)
    assert TSK.plan_from_options(64, 4, TSK.ShuffleOptions()) is None


@pytest.mark.parametrize("kw,match", [
    (dict(skew="sometimes"), "skew"), (dict(hot_keys=(1,)), "pair up"),
    (dict(wire="gzip"), "wire")])
def test_shuffle_options_validation_equals_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        TSK.ShuffleOptions(**kw)
    with pytest.raises(ValueError, match=match):
        JSK.ShuffleOptions(**kw)


@pytest.mark.parametrize("kw", [
    dict(key_space=16, num_shards=4, boundaries=(0, 4, 8, 12)),
    dict(key_space=16, num_shards=4, boundaries=(1, 4, 8, 12, 16)),
    dict(key_space=16, num_shards=4, boundaries=(0, 4, 4, 12, 16)),
    dict(key_space=16, num_shards=4, boundaries=(0, 4, 8, 12, 16),
         hot_keys=(20,), hot_ways=(2,)),
    dict(key_space=16, num_shards=4, boundaries=(0, 4, 8, 12, 16),
         hot_keys=(2,), hot_ways=(1,)),
    dict(key_space=16, num_shards=4, boundaries=(0, 4, 8, 12, 16),
         hot_keys=(2, 2), hot_ways=(2, 2))])
def test_shuffle_plan_validation_equals_reference(kw):
    with pytest.raises(ValueError):
        TSK.ShufflePlan(**kw)
    with pytest.raises(ValueError):
        JSK.ShufflePlan(**kw)


def test_options_repr_and_explicit_boundaries_equal_reference():
    for kw in (dict(), dict(capacity=7, strict=True),
               dict(skew="auto", wire="packed", hot_key_split_max=2),
               dict(boundaries=[0, 3, 64], hot_keys=[1], hot_ways=[2])):
        assert repr(TSK.ShuffleOptions(**kw)) == repr(
            JSK.ShuffleOptions(**kw))
    opts = dict(boundaries=(0, 20, 64), imbalance=3.0)
    _, tapp = kv_apps("sum")
    japp, _ = kv_apps("sum")
    tr, tprof = TSK.resolve_shuffle_options(
        tapp, t_plan(tapp, flow="sort", device="cpu"), None, num_shards=2,
        options=TSK.ShuffleOptions(**opts))
    jr, jprof = JSK.resolve_shuffle_options(
        japp, j_plan(japp, flow="sort"), None, num_shards=2,
        options=JSK.ShuffleOptions(**opts))
    assert repr(tr) == repr(jr) and tr.source == "explicit"
    assert tprof.describe() == jprof.describe()


def test_memo_and_tune_cache_file(tmp_path, monkeypatch):
    """A second resolution of the same items is served by the memo (no
    sample); with ``REPRO_TORCH_TUNE_CACHE`` set, a fresh process's memo
    reads the file; the reference's file variable is not read."""
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    monkeypatch.setenv("JAX_PALLAS_TUNE_CACHE", str(tmp_path / "jax.json"))
    TSK.clear_memo()
    _, tapp = kv_apps("sum")
    plan = t_plan(tapp, flow="sort", device="cpu")
    items = torch.from_numpy(zipf_items(1, hot=9))
    opts = TSK.ShuffleOptions(skew="auto")
    before = TSK.stats_snapshot()
    first, p1 = TSK.resolve_shuffle_options(tapp, plan, items, num_shards=4,
                                            options=opts)
    second, p2 = TSK.resolve_shuffle_options(tapp, plan, items, num_shards=4,
                                             options=opts)
    after = TSK.stats_snapshot()
    assert after["samples"] - before["samples"] == 1
    assert after["cache_hits"] - before["cache_hits"] == 1
    assert (p1.source, p2.source) == ("sample", "cache")
    assert dataclasses.replace(second, source="sample") == first
    stored = json.loads(path.read_text())
    assert len(stored) == 1 and next(iter(stored)).startswith("skew|")
    assert not (tmp_path / "jax.json").exists()
    TSK.clear_memo()
    third, p3 = TSK.resolve_shuffle_options(tapp, plan, items, num_shards=4,
                                            options=opts)
    assert p3.source == "file-cache"
    assert dataclasses.replace(third, source="sample") == first


def test_lower_records_skew_lines_like_the_reference():
    """``lower()`` under ``ShuffleOptions(skew="auto")`` puts the
    planner's provenance on ``plan.skew``: the reference's lines."""
    TSK.clear_memo()
    JSK.clear_memo()
    japp, tapp = kv_apps("sum")
    items = zipf_items(3, hot=9)
    tmr = T.MapReduce(tapp, flow="sort", device="cpu", cache=False)
    tmr.lower(torch.from_numpy(items), options=T.ExecutionOptions(
        mesh=LocalMesh(4, "cpu"), shuffle=TSK.ShuffleOptions(skew="auto")))
    jres, jprof = JSK.resolve_shuffle_options(
        japp, j_plan(japp, flow="sort"), jnp.asarray(items), num_shards=4,
        options=JSK.ShuffleOptions(skew="auto"))
    jplan = JSK.plan_from_options(64, 4, jres, flow="sort",
                                  spec=j_plan(japp, flow="sort").spec,
                                  value_aval=japp.value_aval)
    want = tuple(jprof.describe()) + tuple(jplan.describe())
    assert tmr.plan.skew == want
    text = tmr.explain()
    assert "skew: boundaries: 4 ranges" in text
    assert "hot keys split" in text
