"""Integer sums past 2^31 (ROADMAP C.5, C.38, C.49).

The port holds an integer sum in int64 (torch sums int32 into int64), the
reference in its promoted dtype, int32, which wraps silently past 2^31.
K = 16 keys and 512 int32 values drawn over the whole int32 range, the
reducer ``values.sum()``: in every flow (auto, stream, sort, combine,
reduce) and in a ``LocalMesh(4)`` distributed run, the port equals int64
numpy exactly, and equals the reference's local run modulo 2^32.  The
reference's mesh runs are not the oracle (C.3).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402

K, N = 16, 512
FLOWS = ("auto", "stream", "sort", "combine", "reduce")


def _apps():
    common = dict(key_space=K, emit_capacity=1, max_values_per_key=128)
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]),
                      lambda k, v, c: v.sum(),
                      value_spec=T.ValueSpec((), torch.int32), **common)
    japp = J.make_app(map_fn=lambda item, emit: emit(item[0], item[1]),
                      reduce_fn=lambda k, v, c: jnp.sum(v),
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                      **common)
    return tapp, japp


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(49)
    keys = rng.integers(0, K, N).astype(np.int32)
    vals = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        N, dtype=np.int64, endpoint=True).astype(np.int32)
    exact = np.zeros(K, np.int64)
    np.add.at(exact, keys, vals.astype(np.int64))
    counts = np.bincount(keys, minlength=K)
    # the data must cross the reference's range, or the test shows nothing
    assert (np.abs(exact) > 2**31 - 1).sum() >= K // 2
    return keys, vals, exact, counts


def _check(res, exact, counts):
    got = res.values.cpu().numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(res.counts.cpu().numpy(), counts)


@pytest.mark.parametrize("flow", FLOWS)
def test_int32_sum_past_2_31_local(data, flow):
    keys, vals, exact, counts = data
    tapp, japp = _apps()
    res = T.MapReduce(tapp, flow=flow, device="cpu").run(
        (torch.from_numpy(keys), torch.from_numpy(vals)))
    _check(res, exact, counts)
    jres = J.MapReduce(japp, flow=flow, cache=False).run(
        (jnp.asarray(keys), jnp.asarray(vals)))
    jvals = np.asarray(jres.values)
    assert jvals.dtype == np.int32  # the reference wraps (C.49)
    np.testing.assert_array_equal(np.asarray(jres.counts), counts)
    np.testing.assert_array_equal(
        res.values.numpy().astype(np.uint32), jvals.view(np.uint32))
    assert not np.array_equal(res.values.numpy(), jvals.astype(np.int64))


@pytest.mark.parametrize("flow", FLOWS)
def test_int32_sum_past_2_31_distributed(data, flow):
    keys, vals, exact, counts = data
    tapp, _ = _apps()
    res = T.MapReduce(tapp, flow=flow, device="cpu").run_distributed(
        (torch.from_numpy(keys), torch.from_numpy(vals)),
        mesh=LocalMesh(4, "cpu"))
    _check(res, exact, counts)
