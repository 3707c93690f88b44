"""The port's shuffle wire layer (``repro_torch.distributed.wire``) and int8
compression against the reference's, on the CPU.

The same numpy pair streams go through ``repro.distributed.wire`` and the
port: the send buckets, the overflow counts, every leaf of the encoded
tree (``raw``, ``delta`` and ``packed``), the decoded buckets, the
``WireFormat`` (fields and ``epoch``) and the byte accounting must be
equal bit for bit, with the fixed-width ranges and under a skew plan with
hot keys.  ``roofline.shuffle_wire_bytes`` must equal the reference's and
the bytes of the tree the port encodes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import collector as JCOL  # noqa: E402
from repro.core import skew as JSK  # noqa: E402
from repro.distributed import compression as JCOMP  # noqa: E402
from repro.distributed import wire as JW  # noqa: E402
from repro.roofline import analysis as JRA  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import skew as TSK  # noqa: E402
from repro_torch.distributed import compression as TCOMP  # noqa: E402
from repro_torch.distributed import wire as TW  # noqa: E402
from repro_torch.roofline import analysis as TRA  # noqa: E402

K, S = 64, 4
#: (numpy dtype, value shape) of the value streams
VALUES = {"i32": (np.int32, ()), "f32x3": (np.float32, (3,))}


def pairs(seed, n=96, *, hot=None, value="i32", wide=False):
    """Keys in [0, K] (K: the sentinel, about a tenth), values from a seed;
    ``hot`` keys take about half the pairs; ``wide`` int values leave the
    int8 range."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, K, size=n).astype(np.int32)
    if hot:
        keys[rng.random(n) < 0.5] = rng.choice(np.asarray(hot, np.int32),
                                               size=1)[0]
        keys[rng.random(n) < 0.2] = rng.choice(np.asarray(hot, np.int32),
                                               size=1)[0]
    keys[rng.random(n) < 0.1] = K
    dt, shape = VALUES[value]
    if np.issubdtype(dt, np.integer):
        lim = 1000 if wide else 100
        vals = rng.integers(-lim, lim, size=(n,) + shape).astype(dt)
    else:
        vals = (rng.standard_normal((n,) + shape) * 4).astype(dt)
        vals[rng.random((n,) + shape) < 0.1] = 0.0
    return keys, vals


def plans(hot: bool):
    """(reference plan, port plan) over K = 64 at S = 4, or (None, None)."""
    if not hot:
        return None, None
    jplan = JSK.ShufflePlan(key_space=K, num_shards=S,
                            boundaries=(0, 10, 30, 41, K),
                            hot_keys=(12, 50), hot_ways=(3, 2),
                            imbalance=2.5, max_dest_frac=0.6)
    return jplan, interop.shuffle_plan_from_repro(jplan)


def both(keys, vals, *, codec, hot, capacity=None):
    """(reference fmt, buckets, encoded), (port fmt, buckets, encoded)."""
    jplan, tplan = plans(hot)
    jstream = JCOL.PairStream(jnp.asarray(keys), jnp.asarray(vals), K)
    tstream = TCOL.PairStream(torch.from_numpy(keys), torch.from_numpy(vals),
                              K)
    jfmt = JW.wire_format(key_space=K, num_shards=S, n_pairs=len(keys),
                          value_avals=jstream.values, codec=codec,
                          capacity=capacity, plan=jplan)
    tfmt = TW.wire_format(key_space=K, num_shards=S, n_pairs=len(keys),
                          value_avals=tstream.values, codec=codec,
                          capacity=capacity, plan=tplan)
    jb = JW.bucketize(jfmt, jstream, jplan)
    tb = TW.bucketize(tfmt, tstream, tplan)
    return ((jfmt, jb, JW.encode(jfmt, jb[0], jb[1])),
            (tfmt, tb, TW.encode(tfmt, tb[0], tb[1])))


def np_of(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_bits(a, b):
    a, b = np_of(a), np_of(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def assert_tree_bits(jtree, ttree):
    jl = jax.tree.leaves(jtree)
    tl = torch.utils._pytree.tree_leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert_bits(a, b)


@pytest.mark.parametrize("value", sorted(VALUES))
@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("codec", TW.CODECS)
def test_buckets_and_encoded_tree_equal_reference(codec, hot, value):
    keys, vals = pairs(7, hot=(12, 50) if hot else None, value=value)
    (jfmt, jb, jenc), (tfmt, tb, tenc) = both(keys, vals, codec=codec,
                                              hot=hot)
    assert dataclasses.asdict(tfmt) == dataclasses.asdict(
        interop.wire_format_from_repro(jfmt))
    assert tfmt.epoch == jfmt.epoch
    assert repr(tfmt.value_leaves) == repr(jfmt.value_leaves)
    for a, b in zip(jb[:2], tb[:2]):
        assert_bits(a, b)
    assert int(jb[2]) == int(tb[2])
    assert sorted(tenc) == sorted(jenc)
    assert_tree_bits(jenc, tenc)
    assert TW.tree_nbytes(tenc) == TW.encoded_nbytes(tfmt) \
        == JW.encoded_nbytes(jfmt) == JW.tree_nbytes(jenc)
    assert TW.raw_nbytes(tfmt) == JW.raw_nbytes(jfmt)
    assert TW.wire_bytes_per_shard(tfmt) == JW.wire_bytes_per_shard(jfmt)


@pytest.mark.parametrize("hot", [False, True])
@pytest.mark.parametrize("codec", TW.CODECS)
def test_decode_equals_reference_per_destination(codec, hot):
    keys, vals = pairs(11, hot=(12, 50) if hot else None, value="f32x3")
    (jfmt, _, jenc), (tfmt, _, tenc) = both(keys, vals, codec=codec, hot=hot)
    for d in range(S):
        jk, jv = JW.decode(jfmt, jax.tree.map(lambda v: v[d:d + 1], jenc), d)
        tk, tv = TW.decode(tfmt, torch.utils._pytree.tree_map(
            lambda v: v[d:d + 1], tenc), d)
        assert_bits(jk, tk)
        assert_bits(jv, tv)


@pytest.mark.parametrize("hot", [False, True])
def test_delta_decodes_to_the_raw_buckets(hot):
    keys, vals = pairs(3, n=200, hot=(12, 50) if hot else None)
    _, (tfmt, tb, tenc) = both(keys, vals, codec="delta", hot=hot)
    for d in range(S):
        k, v = TW.decode(tfmt, {kk: vv[d:d + 1] for kk, vv in tenc.items()},
                         d)
        assert torch.equal(k[0], tb[0][d]) and torch.equal(v[0], tb[1][d])


@pytest.mark.parametrize("capacity", [1, 5, 17])
@pytest.mark.parametrize("hot", [False, True])
def test_overflow_counts_equal_reference(capacity, hot):
    keys, vals = pairs(5, n=128, hot=(12, 50) if hot else None)
    (jfmt, jb, jenc), (tfmt, tb, tenc) = both(keys, vals, codec="delta",
                                              hot=hot, capacity=capacity)
    assert int(jb[2]) == int(tb[2]) > 0
    assert_tree_bits(jenc, tenc)
    assert tfmt.epoch == jfmt.epoch


def test_packed_wraps_wide_int_values_as_the_reference():
    keys, vals = pairs(9, wide=True)
    (_, _, jenc), (_, _, tenc) = both(keys, vals, codec="packed", hot=False)
    assert_tree_bits(jenc, tenc)


@pytest.mark.parametrize("w", [1, 3, 7, 8, 9, 13, 20, 31])
def test_bit_lane_equals_reference(w):
    rng = np.random.default_rng(w)
    sym = rng.integers(0, 1 << w, size=(3, 37), dtype=np.int64).astype(
        np.int32)
    jp = JW._pack_symbols(jnp.asarray(sym), w)
    tp = TW._pack_symbols(torch.from_numpy(sym), w)
    assert_bits(jp, tp)
    assert_bits(JW._unpack_symbols(jp, 37, w),
                TW._unpack_symbols(tp, 37, w))
    assert np.array_equal(TW._unpack_symbols(tp, 37, w).numpy(), sym)


def test_epochs_of_fixed_and_planned_formats_equal_reference():
    jplan, tplan = plans(True)
    assert tplan.epoch == jplan.epoch and tplan.width == jplan.width
    for plan_pair in ((None, None), (jplan, tplan)):
        for codec in TW.CODECS:
            for dt, shape in ((np.int32, ()), (np.float32, (5,)),
                              (np.int8, (2,))):
                spec = np.zeros((10,) + shape, dt)
                jf = JW.wire_format(key_space=K, num_shards=S, n_pairs=1000,
                                    value_avals=jnp.asarray(spec),
                                    codec=codec, plan=plan_pair[0])
                tf = TW.wire_format(key_space=K, num_shards=S, n_pairs=1000,
                                    value_avals=torch.from_numpy(spec),
                                    codec=codec, plan=plan_pair[1])
                assert tf.epoch == jf.epoch, (codec, dt, shape)
                assert tf.capacity == jf.capacity
                assert tf.delta_bits == jf.delta_bits


def test_wire_format_validation_and_capacity_chain():
    with pytest.raises(ValueError, match="unknown wire codec"):
        TW.WireFormat(codec="zstd", num_shards=2, capacity=4, key_space=8,
                      lo=(0, 4), span=4)
    with pytest.raises(ValueError, match="range base"):
        TW.WireFormat(codec="raw", num_shards=2, capacity=4, key_space=8,
                      lo=(0,), span=4)
    _, tplan = plans(True)
    jplan, _ = plans(True)
    for n in (10, 100, 5000):
        assert TW.resolve_capacity(n, S) == JW.resolve_capacity(n, S)
        assert TW.resolve_capacity(n, S, plan=tplan) == JW.resolve_capacity(
            n, S, plan=jplan)
        assert TW.resolve_capacity(n, S, capacity=7, plan=tplan) == 7
    keys, vals = pairs(1)
    fmt = TW.wire_format(key_space=K, num_shards=S, n_pairs=len(keys),
                         value_avals=torch.from_numpy(vals))
    with pytest.raises(ValueError, match="epoch"):
        TW.bucketize(fmt, TCOL.PairStream(torch.from_numpy(keys),
                                          torch.from_numpy(vals), K), tplan)


@pytest.mark.parametrize("codec", TW.CODECS)
@pytest.mark.parametrize("value_dtype,value_bytes",
                         [("int32", 4), ("float32", 12), ("bfloat16", 2)])
@pytest.mark.parametrize("num_shards", [1, 2, 4, 16])
def test_shuffle_wire_bytes_equals_reference(codec, value_dtype, value_bytes,
                                             num_shards):
    kw = dict(n_pairs=1 << 16, key_space=1 << 12, num_shards=num_shards,
              value_bytes=value_bytes, value_dtype=value_dtype)
    assert TRA.shuffle_wire_bytes(codec, **kw) == JRA.shuffle_wire_bytes(
        codec, **kw)
    assert TRA.shuffle_wire_bytes(codec, capacity=999, **kw) == \
        JRA.shuffle_wire_bytes(codec, capacity=999, **kw)


def test_shuffle_wire_bytes_equals_the_encoded_tree():
    n, k, s = 4096, 1 << 12, 16
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, k, n // s).astype(np.int32))
    vals = torch.ones(n // s, dtype=torch.int32)
    for codec in TW.CODECS:
        fmt = TW.wire_format(key_space=k, num_shards=s, n_pairs=n // s,
                             value_avals=vals, codec=codec)
        sk, sv, _ = TW.bucketize(fmt, TCOL.PairStream(keys, vals, k))
        enc = TW.tree_nbytes(TW.encode(fmt, sk, sv))
        assert TRA.shuffle_wire_bytes(codec, n_pairs=n, key_space=k,
                                      num_shards=s) == enc * (s - 1) / s
    # the reference's wire gate (bench_flow_sweep --wire): int16 values,
    # K = 8192 over 16 shards, 10-bit residuals against 32-bit keys
    kw = dict(n_pairs=1 << 22, key_space=8192, num_shards=16, value_bytes=2,
              value_dtype="int16")
    assert TRA.shuffle_wire_bytes("delta", **kw) <= 0.6 * \
        TRA.shuffle_wire_bytes("raw", **kw)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(7,), (4, 9), (3, 2, 5)])
def test_quant_int8_equals_reference(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-3, 4)).astype(
        np.float32)
    x.reshape(-1)[rng.random(x.size) < 0.2] = 0.0
    x.reshape(-1)[0] = 127 * 0.5  # a half-way point of some scale
    jq, js = JCOMP.quant_int8(jnp.asarray(x))
    tq, ts = TCOMP.quant_int8(torch.from_numpy(x))
    assert_bits(jq, tq)
    assert_bits(js, ts)
    assert_bits(JCOMP.dequant_int8(jq, js), TCOMP.dequant_int8(tq, ts))
    assert_bits(JCOMP.fake_quant_int8(jnp.asarray(x)),
                TCOMP.fake_quant_int8(torch.from_numpy(x)))
    jrq, jrs = jax.vmap(JCOMP.quant_int8)(jnp.asarray(x))
    trq, trs = TCOMP.quant_int8_rows(torch.from_numpy(x))
    assert_bits(jrq, trq)
    assert_bits(jrs, trs)


def test_quant_int8_of_zeros_and_error_feedback():
    q, s = TCOMP.quant_int8(torch.zeros(5))
    jq, js = JCOMP.quant_int8(jnp.zeros(5))
    assert_bits(jq, q)
    assert_bits(js, s)
    g = {"w": torch.tensor([0.3, -1.7, 2.0]), "b": torch.tensor([5.0])}
    res = TCOMP.ErrorFeedback.init(g)
    comp, res2 = TCOMP.ErrorFeedback.apply(g, res)
    for k in g:
        torch.testing.assert_close(comp[k] + res2[k], g[k], rtol=0,
                                   atol=1e-6)
        jc, jr = JCOMP.ErrorFeedback.apply(
            {k: jnp.asarray(g[k].numpy())},
            JCOMP.ErrorFeedback.init({k: jnp.asarray(g[k].numpy())}))
        assert_bits(jc[k], comp[k])
        assert_bits(jr[k], res2[k])


def test_shuffle_options_validate_wire_codec():
    with pytest.raises(ValueError, match="wire"):
        TSK.ShuffleOptions(wire="zstd")
    assert repr(TSK.ShuffleOptions(wire="delta")) == repr(
        JSK.ShuffleOptions(wire="delta"))
