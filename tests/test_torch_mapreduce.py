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


@pytest.mark.parametrize("flow,item", [("combine", "A8"), ("reduce", "A8")])
def test_flows_not_ported_name_their_roadmap_item(flow, item):
    tapp, _ = tapps.build("WC", np.random.default_rng(0), scale=SCALE,
                          device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        T.MapReduce(tapp, flow=flow, device="cpu")


def test_n_pairs_hint_names_the_cost_model_item():
    """The sort flow is ported; ranking it against the stream flow for a
    workload size (the reference's cost model) is not."""
    tapp, _ = tapps.build("WC", np.random.default_rng(0), scale=SCALE,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        T.MapReduce(tapp, n_pairs_hint=1 << 20, device="cpu")


def test_underivable_reducer_is_not_substituted():
    app = T.make_app(lambda item, emit: emit(item, item.float()),
                     lambda k, v, c: v[0] + v[1], key_space=8,
                     value_spec=TC.ValueSpec((), torch.float32),
                     emit_capacity=1)
    with pytest.raises(NotImplementedError, match="reduce flow"):
        T.MapReduce(app, device="cpu")


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
