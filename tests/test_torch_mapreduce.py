"""The slice as a whole: ``repro_torch.MapReduce(app, device="cpu").run``
against ``repro.core.MapReduce(app).run`` on the same numpy inputs.

The seven Phoenix apps and the bounding-box (max/min) app, with the folds'
kernels off and on (the reference's Pallas kernels in interpret mode, the
port's kernels through their plain versions on CPU tensors).  Counts and
integer tables must be bitwise equal (the port sums integers into int64,
as torch does, so values are compared, not dtypes), max/min tables bitwise,
float sums within rtol=atol=1e-5.  The plans must match: flow, strategy and
the stream fold's mode.
"""

import os
import sys
from functools import cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import repro.core as J  # noqa: E402
from benchmarks import apps as japps  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
SCALE = 0.01


class JBoundingBox(japps.KMeans):
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, axis=0),
                                jnp.min(values, axis=0)])


def _jax_build(name):
    if name == "BB":
        _, items = japps.build("KM", np.random.default_rng(0), scale=SCALE)
        return JBoundingBox(), items
    return japps.build(name, np.random.default_rng(0), scale=SCALE)


@cache
def _reference(name, use_kernels):
    japp, jitems = _jax_build(name)
    mr = J.MapReduce(japp, use_kernels=use_kernels, cache=False)
    res = mr.run(jitems)
    return (mr.plan.flow, mr.plan.derivation.strategy, mr.tiling.mode,
            np.asarray(res.counts), jax.tree.map(np.asarray, res.values))


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", list(tapps.ALL) + ["BB"])
def test_run_matches_reference(name, use_kernels):
    flow, strategy, mode, jcounts, jvals = _reference(name, use_kernels)
    tapp, titems = tapps.build(name, np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    mr = T.MapReduce(tapp, device="cpu", use_kernels=use_kernels)
    res = mr.run(titems)
    assert (mr.plan.flow, mr.plan.derivation.strategy, mr.tiling.mode) == (
        flow, strategy, mode)
    np.testing.assert_array_equal(res.counts.numpy(), jcounts)
    tvals = res.values.numpy()
    assert tvals.shape == jvals.shape
    if name == "BB":
        np.testing.assert_array_equal(tvals.view(np.uint32),
                                      jvals.view(np.uint32))
    elif np.issubdtype(jvals.dtype, np.integer):
        np.testing.assert_array_equal(tvals, jvals)
    else:
        np.testing.assert_allclose(tvals, jvals, **SUM_TOL)


@pytest.mark.parametrize("name", list(tapps.ALL))
def test_map_phase_hands_the_kernels_dense_pairs(name):
    """The CUDA fold kernels take contiguous keys and rows only.  A map
    that emits one constant key (LR) or constant values (HG) gets them back
    from vmap expanded with stride 0; the map phase must densify them."""
    from repro_torch.core import engine

    tapp, titems = tapps.build(name, np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    stream = engine.map_phase(tapp, titems, "cpu")
    assert stream.keys.is_contiguous() and stream.values.is_contiguous()
    assert stream.keys.dtype == torch.int32


def test_kernels_on_cpu_count_no_launch_and_use_the_fused_accumulator():
    tapp, titems = tapps.build("KM", np.random.default_rng(1), scale=SCALE,
                               device="cpu")
    tops.reset_launch_counts()
    mr = T.MapReduce(tapp, device="cpu", use_kernels=True)
    mr.run(titems)
    counts = tops.launch_counts()
    assert {"onehot_fold", "chunk_monoid_fold"} <= set(counts)
    assert set(counts.values()) == {0}, counts
    assert mr.use_kernels and mr.tiling.mode == "additive"


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tapp, titems = tapps.build("WC", np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MapReduce(tapp).run(titems)


@pytest.mark.parametrize("flow", ["combine", "reduce"],
                         ids=["combine-A8", "reduce-A8"])
def test_flows_not_ported_name_their_roadmap_item(flow):
    """The flows ROADMAP A8 named as not ported now run, and give the
    reference's counts and word counts (int64 values in the port, C.5)."""
    tapp, titems = tapps.build("WC", np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    japp, jitems = japps.build("WC", np.random.default_rng(0), scale=SCALE)
    mr = T.MapReduce(tapp, flow=flow, device="cpu")
    assert mr.plan.flow == flow and mr.tiling is None
    res = mr.run(titems)
    jres = J.MapReduce(japp, flow=flow, cache=False).run(jitems)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(jres.values))


def test_n_pairs_hint_names_the_cost_model_item():
    """The cost model (ROADMAP A6) ranks the stream flow against the sort
    flow for a workload size: on the CPU the plan, its reason and the cost
    lines of ``explain()`` are the reference's, and the run gives the
    reference's counts and word counts."""
    tapp, titems = tapps.build("WC", np.random.default_rng(0), scale=SCALE,
                               device="cpu")
    japp, jitems = japps.build("WC", np.random.default_rng(0), scale=SCALE)
    mr = T.MapReduce(tapp, n_pairs_hint=1 << 20, device="cpu")
    jmr = J.MapReduce(japp, n_pairs_hint=1 << 20, cache=False)
    assert mr.plan.cost is not None and mr.plan.cost.backend == "cpu"
    assert (mr.plan.flow, mr.plan.reason) == (jmr.plan.flow, jmr.plan.reason)
    assert mr.plan.cost.describe() == jmr.plan.cost.describe()
    assert mr.plan.cost.describe() in mr.explain()
    res, jres = mr.run(titems), jmr.run(jitems)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(jres.values))


def test_underivable_reducer_is_not_substituted():
    """No combiner stands in for a reducer the optimizer cannot derive:
    ``auto`` plans the reduce flow, which runs the user's own reduce, and
    the values are the reference's."""
    app = T.make_app(lambda item, emit: emit(item, item.float()),
                     lambda k, v, c: v[0] + v[1], key_space=8,
                     value_spec=TC.ValueSpec((), torch.float32),
                     emit_capacity=1)
    japp = J.make_app(lambda item, emit: emit(item, item.astype(jnp.float32)),
                      lambda k, v, c: v[0] + v[1], key_space=8,
                      value_aval=jax.ShapeDtypeStruct((), jnp.float32),
                      emit_capacity=1)
    mr = T.MapReduce(app, device="cpu")
    assert mr.plan.flow == "reduce" and mr.plan.spec is None
    assert "not combinable" in mr.plan.reason
    items = np.array([1, 3, 1, 5, 3, 1, 7, 9], np.int32)
    res = mr.run(items)
    jres = J.MapReduce(japp, cache=False).run(items)
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(jres.counts))
    np.testing.assert_array_equal(res.values.numpy(), np.asarray(jres.values))
    assert res.to_dict()[1] == 2.0  # 1 + 1: the first two values of key 1


def _wc_items():
    rng = np.random.default_rng(3)
    return rng.integers(-2, 70, size=(300, 4)).astype(np.int32)


def _wc_app():
    return T.make_app(
        lambda win, emit: emit(win, torch.ones_like(win), valid=win != 5),
        lambda k, v, c: v.sum(), key_space=64,
        value_spec=TC.ValueSpec((), torch.int32), emit_capacity=4)


@pytest.mark.parametrize("chunk_pairs,key_block", [(None, None), (64, None),
                                                   (100, 16), (7, 5)])
def test_chunking_blocking_and_masking(chunk_pairs, key_block):
    """Out-of-range keys (<0, >K), masked emissions and any chunking give
    the exact counts; ``n_valid`` drops the tail items."""
    toks = _wc_items()
    opts = T.ExecutionOptions(chunk_pairs=chunk_pairs, key_block=key_block)
    mr = T.MapReduce(_wc_app(), device="cpu")
    flat = toks.reshape(-1)
    want = np.bincount(flat[(flat >= 0) & (flat < 64) & (flat != 5)],
                       minlength=64)
    res = mr.run(toks, options=opts)
    np.testing.assert_array_equal(res.values.numpy(), want)
    np.testing.assert_array_equal(res.counts.numpy(), want)
    head = toks[:123].reshape(-1)
    want_head = np.bincount(head[(head >= 0) & (head < 64) & (head != 5)],
                            minlength=64)
    res = mr.run(toks, options=opts, n_valid=123)
    np.testing.assert_array_equal(res.counts.numpy(), want_head)


def test_manual_combiner_and_explain():
    app = _wc_app()
    app.manual_combiner = TC.count_spec()
    mr = T.MapReduce(app, device="cpu")
    text = mr.explain()
    assert "flow: stream (manual combiner)" in text and "mode=size" in text
    res = mr.run(_wc_items())
    np.testing.assert_array_equal(res.values.numpy(), res.counts.numpy())
    assert res.to_dict()[10] == res.counts[10].item()


def test_core_exports_the_reference_names_it_defines():
    """Every name of ``repro.core.__all__`` that the port's core defines is
    exported by ``repro_torch.core`` as well."""
    import importlib
    import pkgutil

    import repro_torch.core as TCORE

    mods = [importlib.import_module(m.name) for m in pkgutil.iter_modules(
        TCORE.__path__, "repro_torch.core.")]
    defined = [name for name in J.__all__
               if any(hasattr(m, name) for m in mods)]
    assert {"FLOWS", "StreamTiling", "autotune_stream",
            "autotune_sort"} <= set(defined)
    missing = sorted(set(defined) - set(TCORE.__all__))
    assert not missing, missing
    for name in TCORE.__all__:
        assert getattr(T, name) is getattr(TCORE, name)
