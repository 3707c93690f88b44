"""``int_fold``, the exact integer keyed fold, on the CPU.

Every comparison is bit for bit.

* ``int_fold_plain`` (what ``ops.int_fold`` runs on CPU tensors) against
  the reference's exact integer one-hot contraction
  (``repro.core.collector.StreamCombiner`` in its additive mode: the
  tables and the counts) and ``jnp.bincount``, over the cases
  ``chip_smoke.py``'s phase 2 holds the kernel to: K = 1, 4, 100, 768,
  2^16, 2^20; D = 0, 1, 3; int32 and int64 rows, values near the int32
  limits and per-key sums past 2^31; sentinel and out-of-range keys, every
  key invalid; n = 0, 31 and larger; one key holding almost every pair,
  zipf keys.  The port's tables are int64 and exact (numpy int64, wrapping
  modulo 2^64); the reference's are int32, so they agree modulo 2^32.
* The wrapper: fresh outputs, inputs never written, types and shapes
  checked, two calls equal.
* The plan: at the card's chunk (``stream_chunk_pairs=1<<22``) WordCount
  (2^16 words) and Histogram keep the reference's ``mode=additive`` with
  the kernels on, with no FALLBACK note and no ``LoweringFallbackWarning``.
* Runs: WordCount, Histogram and StringMatch stream runs, a WordCount
  streaming ingest and a ``LocalMesh(2)`` run equal the reference's values
  and counts.
"""

import os
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import repro.core as J  # noqa: E402
from benchmarks import apps as japps  # noqa: E402
from repro.core import collector as JCOL  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.int_fold import int_fold_plain  # noqa: E402

I32, I64 = np.int32, np.int64
#: the card's stream chunk (core/autotune.py CUDA_CHUNK_PAIRS)
CARD_CHUNK = 1 << 22
#: the reference's contraction takes key blocks of this many keys at most
REF_KEY_BLOCK = 4096

# (n, D, K, row dtype, key mix)
CASES = [
    (4099, 1, 100, I32, "uniform"),
    (4099, 3, 100, I32, "uniform"),
    (4099, 0, 100, I32, "uniform"),
    (31, 1, 1, I32, "uniform"),
    (31, 3, 4, I64, "uniform"),
    (4099, 1, 768, I32, "one_key"),
    (4099, 3, 768, I64, "zipf"),
    (4099, 1, 1 << 16, I32, "zipf"),
    (4099, 0, 1 << 16, I32, "zipf"),
    (31, 1, 1 << 20, I64, "uniform"),
    (31, 0, 1 << 20, I32, "uniform"),
    (4099, 1, 100, I32, "all_out"),
    (0, 1, 100, I32, "uniform"),
    (0, 0, 4, I32, "uniform"),
    (4099, 1, 4, I32, "near_limits"),
    (4099, 3, 100, I64, "near_limits"),
]


def _ids(case):
    n, d, k, dt, mix = case
    return f"n{n}-d{d}-k{k}-{np.dtype(dt).name}-{mix}"


def _keys(rng, n, k, mix):
    """[n] int32 keys in [0, K) by ``mix``, a tenth of them the sentinel K
    or out of range (every one with ``all_out``)."""
    if mix == "zipf":
        keys = (rng.zipf(1.2, n) % k).astype(I32)
    else:
        keys = rng.integers(0, k, n).astype(I32)
    if mix == "one_key":  # key K // 2 holds all but about 1/1000
        keys[rng.random(n) >= 1e-3] = k // 2
    bad = rng.random(n) < (1.0 if mix == "all_out" else 0.1)
    keys[bad] = rng.choice(np.array([k, k + 3, -1, -7], I32), int(bad.sum()))
    return keys


def _rows(rng, n, d, dt, mix):
    if mix == "near_limits":  # per-key sums far past 2^31 (or 2^63)
        info = np.iinfo(dt)
        picks = np.array([info.max, info.max - 1, info.min, info.min + 1],
                         dt)
        return rng.choice(picks[:2] if dt == I32 else picks, (n, d))
    return rng.integers(-1000, 1000, (n, d)).astype(dt)


def _inputs(case, seed=0):
    n, d, k, dt, mix = case
    rng = np.random.default_rng(seed)
    keys = _keys(rng, n, k, mix)
    rows = _rows(rng, n, d, dt, mix)
    table = rng.integers(-2**40, 2**40, (k, d)).astype(I64)
    counts = rng.integers(0, 1000, k).astype(I32)
    return keys, rows, table, counts


def _numpy(keys, rows, table, counts):
    """int64 numpy: the table plus each key's sum (wrapping), the counts
    plus each key's pairs."""
    k = table.shape[0]
    ok = (keys >= 0) & (keys < k)
    want = table.copy()
    with np.errstate(over="ignore"):
        np.add.at(want, keys[ok], rows[ok].astype(I64))
    return want, counts + np.bincount(keys[ok], minlength=k).astype(I32)


def _reference(keys, rows, table, counts):
    """The reference's additive fold of one chunk: its exact integer
    one-hot contraction (int32 tables, blocked by keys) of the rows and of
    the valid column (a zero column stands for D = 0)."""
    k = table.shape[0]
    d = max(rows.shape[1], 1)
    rows32 = (rows.astype(I32) if rows.shape[1] else
              np.zeros((rows.shape[0], 1), I32))
    comb = JCOL.StreamCombiner(
        JC.monoid_spec("add"), k, jax.ShapeDtypeStruct((d,), jnp.int32),
        key_block=min(k, REF_KEY_BLOCK), mode="additive")
    tab32 = (table.astype(I32) if table.shape[1] else
             np.zeros((k, 1), I32))
    tabs, cnt = comb.fold_chunk(
        (jnp.asarray(tab32), jnp.asarray(counts)),
        JCOL.PairStream(jnp.asarray(keys), jnp.asarray(rows32), k))
    return np.asarray(tabs)[:, :rows.shape[1]], np.asarray(cnt)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_against_the_reference_contraction_and_bincount(case):
    keys, rows, table, counts = _inputs(case)
    got_t, got_c = ops.int_fold(*(torch.from_numpy(a) for a in
                                  (keys, rows, table, counts)))
    plain_t, plain_c = int_fold_plain(*(torch.from_numpy(a) for a in
                                        (keys, rows, table, counts)))
    assert torch.equal(got_t, plain_t) and torch.equal(got_c, plain_c)
    assert got_t.dtype == torch.int64 and got_c.dtype == torch.int32
    want_t, want_c = _numpy(keys, rows, table, counts)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    if case[-1] == "near_limits":  # the sums do leave the int32 range
        assert (np.abs(want_t - table) > 2**31).any()
    if keys.size:  # the reference's chunk fold takes no empty chunk
        ref_t, ref_c = _reference(keys, rows, table, counts)
        np.testing.assert_array_equal(got_c.numpy(), ref_c)
        # the reference's int32 tables: the same sums modulo 2^32
        np.testing.assert_array_equal(got_t.numpy().astype(np.uint32),
                                      ref_t.view(np.uint32))
    k = table.shape[0]
    jkeys = jnp.asarray(keys)
    binned = jnp.where((jkeys >= 0) & (jkeys < k), jkeys, k)
    np.testing.assert_array_equal(
        got_c.numpy() - counts,
        np.asarray(jnp.bincount(binned, length=k + 1))[:k])


def test_plain_at_the_card_chunk_against_numpy():
    """One 2^22-pair chunk of zipf keys over 2^16 keys (the WordCount
    chunk on the card), int32 rows and int64 rows past the int32 range."""
    case = (CARD_CHUNK, 1, 1 << 16, I32, "zipf")
    keys, rows, table, counts = _inputs(case, seed=1)
    got = ops.int_fold(*(torch.from_numpy(a) for a in
                         (keys, rows, table, counts)))
    want = _numpy(keys, rows, table, counts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    rows64 = (rows.astype(I64) << 31) - 7
    got = ops.int_fold(*(torch.from_numpy(a) for a in
                         (keys, rows64, table, counts)))
    np.testing.assert_array_equal(got[0].numpy(),
                                  _numpy(keys, rows64, table, counts)[0])


def test_outputs_are_fresh_and_inputs_kept():
    keys, rows, table, counts = (torch.from_numpy(a) for a in
                                 _inputs(CASES[1]))
    before = [t.clone() for t in (keys, rows, table, counts)]
    out_t, out_c = ops.int_fold(keys, rows, table, counts)
    again = ops.int_fold(keys, rows, table, counts)
    for t, b in zip((keys, rows, table, counts), before):
        assert torch.equal(t, b)
    assert out_t.data_ptr() != table.data_ptr()
    assert out_c.data_ptr() != counts.data_ptr()
    assert torch.equal(out_t, again[0]) and torch.equal(out_c, again[1])
    only = ops.int_fold(keys, rows, table)  # without counts: the table
    assert torch.is_tensor(only) and torch.equal(only, out_t)
    empty_t, empty_c = ops.int_fold(keys[:0], rows[:0], table, counts)
    assert torch.equal(empty_t, table) and torch.equal(empty_c, counts)
    assert empty_t.data_ptr() != table.data_ptr()


@pytest.mark.parametrize("bad", ["keys64", "rows_f32", "table32",
                                 "counts64", "width", "counts_len"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    keys, rows, table, counts = (torch.from_numpy(a) for a in
                                 _inputs(CASES[1]))
    args = dict(keys=keys, rows=rows, table=table, counts=counts)
    err = TypeError
    if bad == "keys64":
        args["keys"] = keys.long()
    elif bad == "rows_f32":
        args["rows"] = rows.float()
    elif bad == "table32":
        args["table"] = table.int()
    elif bad == "counts64":
        args["counts"] = counts.long()
    elif bad == "width":
        args["table"], err = table[:, :2], ValueError
    else:
        args["counts"], err = counts[:-1], ValueError
    with pytest.raises(err):
        ops.int_fold(args["keys"], args["rows"], args["table"],
                     args["counts"])


# ---------------------------------------------------------------------------
# The plan and the runs against the reference
# ---------------------------------------------------------------------------

WC_VOCAB = 1 << 16


def _wordcount(tokens=1 << 14, seed=6):
    toks, vocab = datasets.wordcount_data(np.random.default_rng(seed),
                                          tokens=tokens, vocab=WC_VOCAB)
    return toks.reshape(-1, 16), vocab


def _pair(name):
    """(torch app, torch items, reference app, reference items)."""
    if name == "WC":
        toks, vocab = _wordcount()
        return (tapps.WordCount(vocab), torch.from_numpy(toks),
                japps.WordCount(vocab), jnp.asarray(toks))
    tapp, titems = tapps.build(name, np.random.default_rng(0), scale=0.05,
                               device="cpu")
    japp, jitems = japps.build(name, np.random.default_rng(0), scale=0.05)
    return tapp, titems, japp, jitems


def _same(res, jres):
    np.testing.assert_array_equal(res.counts.numpy(),
                                  np.asarray(jres.counts))
    np.testing.assert_array_equal(res.values.numpy(),
                                  np.asarray(jres.values))


@pytest.mark.parametrize("name", ["WC", "HG"])
def test_card_chunk_keeps_the_reference_additive_plan(name):
    tapp, titems, japp, jitems = _pair(name)
    jmode = {J.MapReduce(japp, use_kernels=uk, cache=False).tiling.mode
             for uk in (False, True)}
    with warnings.catch_warnings():
        warnings.simplefilter("error", TCOL.LoweringFallbackWarning)
        mr = T.MapReduce(tapp, device="cpu", use_kernels=True,
                         stream_chunk_pairs=CARD_CHUNK)
        comb = mr.lower(titems).compile()._entry.executable.combiner(
            CARD_CHUNK // tapp.emit_capacity)
        res = mr.run(titems)
    assert jmode == {"additive"}
    assert mr.tiling.mode == comb.mode == "additive"
    assert mr.tiling.chunk_pairs == CARD_CHUNK
    assert "FALLBACK" not in mr.explain()
    assert not any("FALLBACK" in n for n in mr.tiling.notes)
    _same(res, J.MapReduce(japp, cache=False).run(jitems))


@pytest.mark.parametrize("chunk", ["auto", CARD_CHUNK])
@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name", ["WC", "HG", "SM"])
def test_stream_runs_equal_the_reference(name, use_kernels, chunk):
    tapp, titems, japp, jitems = _pair(name)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", TCOL.LoweringFallbackWarning)
        res = T.MapReduce(tapp, flow="stream", device="cpu",
                          use_kernels=use_kernels,
                          stream_chunk_pairs=chunk).run(titems)
    _same(res, J.MapReduce(japp, flow="stream", cache=False).run(jitems))


def test_streaming_ingest_equals_the_reference():
    """Four micro-batches of 2^10 windows into a WordCount service (kernels
    on: the integer fold with the counts in its launch) against the
    reference's run over all of them."""
    toks, vocab = _wordcount(tokens=1 << 16, seed=3)
    svc = T.MapReduce(tapps.WordCount(vocab), streaming=True, device="cpu",
                      use_kernels=True).serve(batch_capacity=1 << 10)
    for batch in np.split(toks, 4):
        svc.ingest(torch.from_numpy(batch))
    _same(svc.snapshot(), J.MapReduce(japps.WordCount(vocab), cache=False)
          .run(jnp.asarray(toks)))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_local_mesh_run_equals_the_reference(use_kernels):
    toks, vocab = _wordcount(tokens=1 << 14, seed=5)
    res = T.MapReduce(tapps.WordCount(vocab), flow="stream", device="cpu",
                      use_kernels=use_kernels).run_distributed(
        torch.from_numpy(toks), mesh=LocalMesh(2, "cpu"))
    _same(res, J.MapReduce(japps.WordCount(vocab), cache=False)
          .run(jnp.asarray(toks)))
