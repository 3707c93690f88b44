"""The stream flow's counts column folded inside B1 (``onehot_fold(...,
counts=True)``), on the CPU.

* The fold against its older form, a fold of ``[values, valid]`` onto the
  same ``[K, D + 1]`` accumulator, through the plain version (and against
  the reference's ``onehot_fold`` in interpret mode): counts exactly,
  values within rtol = atol = 1e-6; ragged N, sentinel, out-of-range and
  negative keys, K past the plain contraction's key block, an empty chunk.
* The KMeans stream flow against ``repro.core.MapReduce(KMeans,
  flow="stream")`` on the same numpy points.
* KMeans's traced bytes: stream <= combine < reduce (the reference's order,
  ``tests/core/test_stream.py``), the stream flow's ``aten::cat`` bytes the
  combine flow's, B1 reading ``[n, D]`` values, and the same FLOPs in the
  two flows' kernel ops.
* N ingests of the streaming service equal the chunk-aligned batch run bit
  for bit on the fused path.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import repro.core as J  # noqa: E402
from benchmarks import apps as japps  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core.plan_cache import TensorSpec  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
FOLD_TOL = dict(rtol=1e-6, atol=1e-6)
K_KM = tapps.KMeans.key_space


def _fold_inputs(seed, n, d, k):
    """Keys in [0, K) with the sentinel K, K + 3, -1 and -7 mixed in; an
    accumulator of random sums and whole counts (a carried table's)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, k, size=n).astype(np.int32)
    bad = rng.random(n) < 0.1
    keys[bad] = rng.choice(np.array([k, k + 3, -1, -7], np.int32),
                           size=int(bad.sum()))
    vals = rng.standard_normal((n, d)).astype(np.float32)
    acc = rng.standard_normal((k, d + 1)).astype(np.float32)
    acc[:, -1] = rng.integers(0, 50, size=k)
    return keys, vals, acc


def _ones_form(keys, vals, k):
    """The older fused form: the values with a column of ``valid``."""
    valid = ((keys >= 0) & (keys < k)).astype(np.float32)[:, None]
    return np.concatenate([vals, valid], axis=1)


# (n, D values, K, block_k): ragged N; K past FOLD_PLAIN_KEY_BLOCK; a
# block_k that does not divide K; one pair; D = 0 (counts alone); empty
FOLD_CASES = [
    (1003, 3, 100, None),
    (2001, 2, ops.FOLD_PLAIN_KEY_BLOCK + 45, None),
    (777, 4, 300, 64),
    (1, 3, 10, None),
    (513, 0, 7, None),
    (0, 3, 100, None),
]


@pytest.mark.parametrize("n,d,k,block_k", FOLD_CASES)
def test_counts_fold_equals_the_valid_column_fold(n, d, k, block_k):
    keys, vals, acc = _fold_inputs(n + d, n, d, k)
    tk, tv, ta = map(torch.from_numpy, (keys, vals, acc))
    got = ops.onehot_fold(tk, tv, ta, block_k=block_k, counts=True)
    want = ops.onehot_fold(tk, torch.from_numpy(_ones_form(keys, vals, k)),
                           ta, block_k=block_k)
    assert got.shape == (k, d + 1) and got.dtype == torch.float32
    assert torch.equal(got[:, -1], want[:, -1])
    valid = keys[(keys >= 0) & (keys < k)]
    np.testing.assert_array_equal(
        got[:, -1].numpy(),
        acc[:, -1] + np.bincount(valid, minlength=k).astype(np.float32))
    np.testing.assert_allclose(got[:, :d].numpy(), want[:, :d].numpy(),
                               **FOLD_TOL)


def test_counts_fold_against_the_reference_kernel():
    """The reference's Pallas ``onehot_fold`` (interpret mode) on the
    ``[values, valid]`` rows: the port's fold of the values alone gives
    its counts exactly and its sums within 1e-6."""
    n, d, k = 1003, 3, 100
    keys, vals, acc = _fold_inputs(5, n, d, k)
    want = np.asarray(jops.onehot_fold(
        jnp.asarray(keys), jnp.asarray(_ones_form(keys, vals, k)),
        jnp.asarray(acc), interpret=True))
    got = ops.onehot_fold(*map(torch.from_numpy, (keys, vals, acc)),
                          counts=True).numpy()
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got[:, :d], want[:, :d], **FOLD_TOL)


def test_counts_fold_rejects_a_mismatched_accumulator():
    keys, vals, acc = map(torch.from_numpy, _fold_inputs(0, 64, 3, 10))
    with pytest.raises(ValueError, match="acc shape"):
        ops.onehot_fold(keys, vals, acc[:, :3], counts=True)
    with pytest.raises(ValueError, match="acc shape"):
        ops.onehot_fold(keys, vals, acc)


def _kmeans_items(points, seed=1):
    pts, assign, _ = datasets.kmeans_data(np.random.default_rng(seed),
                                          points=points)
    return pts, assign


def test_kmeans_stream_flow_matches_the_reference():
    pts, assign = _kmeans_items(1 << 13)
    mr = T.MapReduce(tapps.KMeans(), flow="stream", device="cpu",
                     use_kernels=True, stream_chunk_pairs=1 << 11)
    comp = mr.lower((torch.from_numpy(assign),
                     torch.from_numpy(pts))).compile()
    assert "fused [K=100, 4] accumulator" in comp.as_text()
    res = comp((torch.from_numpy(assign), torch.from_numpy(pts)))
    ref = J.MapReduce(japps.KMeans(), flow="stream", cache=False).run(
        (jnp.asarray(assign), jnp.asarray(pts)))
    np.testing.assert_array_equal(res.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(res.counts.numpy(),
                                  np.bincount(assign, minlength=K_KM))
    np.testing.assert_allclose(res.values.numpy(), np.asarray(ref.values),
                               **SUM_TOL)


def test_kmeans_stream_moves_fewer_bytes_than_combine():
    """The order the reference claims for its flows (on WordCount), on
    the port's trace of KMeans: stream <= combine < reduce, no ``cat``
    past the combine flow's (the
    map's own), B1's op the bytes of ``[n]`` keys, ``[n, D]`` values and
    the ``[K, D + 1]`` accumulator in and out a chunk, and the stream
    flow's kernel FLOPs the combine flow's (``n (D + 1)``)."""
    points, chunk = 1 << 14, 1 << 12
    pts, assign = _kmeans_items(points, seed=2)

    items = (torch.from_numpy(assign), torch.from_numpy(pts))
    cost, comps = {}, {}
    for flow in ("stream", "combine", "reduce"):
        app = tapps.KMeans()
        if flow == "reduce":
            app.max_values_per_key = int(np.bincount(assign).max())
        comps[flow] = T.MapReduce(
            app, flow=flow, device="cpu", use_kernels=True,
            stream_chunk_pairs=chunk).lower(items).compile()
        cost[flow] = comps[flow].traced_cost(items)
    b = {f: c.bytes_accessed for f, c in cost.items()}
    assert b["stream"] <= b["combine"] < b["reduce"], b
    s, c = cost["stream"], cost["combine"]
    assert s.bytes_by_op.get("aten::cat", 0.0) == c.bytes_by_op.get(
        "aten::cat", 0.0)
    d = 3
    acc_bytes = K_KM * (d + 1) * 4
    chunks = points // chunk
    assert s.op_counts["repro_torch::onehot_fold"] == chunks
    assert s.bytes_by_op["repro_torch::onehot_fold"] == chunks * (
        chunk * (4 + 4 * d) + 2 * acc_bytes)
    assert s.flops_by_op["repro_torch::onehot_fold"] == points * (d + 1)
    assert c.flops_by_op["repro_torch::onehot_combine"] == points * (d + 1)
    assert s.flops <= c.flops
    assert ("the counts column folded in the kernel"
            in comps["stream"].as_text())


def test_ingests_equal_the_batch_run_on_the_fused_path():
    """C.35 on B1's counts column: N ingests of a KMeans service (kernels
    on, so the fused accumulator) equal one batch run whose chunk is the
    micro-batch, bit for bit, ragged last batch included."""
    cap, sizes = 256, (256, 256, 256, 256, 100)
    pts, assign = _kmeans_items(sum(sizes), seed=3)
    svc = T.MapReduce(tapps.KMeans(), streaming=True, device="cpu",
                      use_kernels=True).serve(
        batch_capacity=cap, item_spec=(TensorSpec((), torch.int32),
                                       TensorSpec((3,), torch.float32)))
    assert svc.collector.fused_acc
    lo = 0
    for n in sizes:
        svc.ingest((torch.from_numpy(assign[lo:lo + n]),
                    torch.from_numpy(pts[lo:lo + n])))
        lo += n
    got = svc.snapshot()
    want = T.MapReduce(tapps.KMeans(), flow="stream", device="cpu",
                       use_kernels=True).run(
        (torch.from_numpy(assign), torch.from_numpy(pts)),
        options=T.ExecutionOptions(chunk_pairs=cap))
    for a, b in ((got.counts, want.counts), (got.values, want.values)):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.bincount(assign, minlength=K_KM))
