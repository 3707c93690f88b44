"""The port's distributed runs (``run_distributed`` over a shard mesh) on
the CPU.

* Every flow on ``LocalMesh(S)``, S in {1, 2, 4}, for five combiner paths
  (float max/min, integer sum, a float centroid, the first-element idiom
  through ``spec.merge``, and the reapply contract), against
  ``repro``'s ``run_local``: counts, integer sums and max/min bit for
  bit, float sums within rtol = atol = 1e-5.  The stream and combine
  flows also bit for bit against ``engine.merge_partial_tables`` over the
  shards' own tables, and key-sharded with ``scatter_output``.
* The key-sharded layout of the sort and reduce flows, planted NaN
  payloads under max/min, and the divisibility error, against the
  reference's own 4-device mesh run (one subprocess).
* Skew plans (balanced boundaries, hot-key splits) against the port's and
  the reference's local runs and numpy, the wire codecs bit for bit with
  raw, overflow (strict and not), ``explain()``'s skew and wire lines, the
  compiled cache, the option surface.
* ``ProcessGroupMesh`` over gloo at world size 2 and 4 (subprocesses,
  120 s each at most): bit for bit with ``LocalMesh`` at the same S.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap
import types
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
from repro.core import combiner as JC  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch.core import collector as TCOL  # noqa: E402
from repro_torch.core import combiner as TC  # noqa: E402
from repro_torch.core import engine as TENG  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.core import skew as TSK  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402
from repro_torch.distributed import compression as TCOMP  # noqa: E402
from repro_torch.distributed import wire as TW  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
F32, I32 = torch.float32, torch.int32
K = 64
N = 512
FLOWS = ("stream", "combine", "sort", "reduce")
SUM_TOL = dict(rtol=1e-5, atol=1e-5)


def _manual_reapply(pkg):
    """A sum with no merge and the reapply contract."""
    return dataclasses.replace(pkg.sum_spec(), merge=None, reapply_ok=True)


#: combiner path -> (port reduce, JAX reduce, dtype, value shape, manual
#: spec, exact): max/min and integers compare bit for bit, float sums
#: within SUM_TOL
SPECS = {
    "bbox": (lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
             lambda k, v, c: jnp.concatenate([jnp.max(v, 0), jnp.min(v, 0)]),
             "float32", (2,), None, True),
    "int_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                "int32", (), None, True),
    "centroid": (lambda k, v, c: v.sum(0) / c.clamp(min=1).to(F32),
                 lambda k, v, c: jnp.sum(v, 0) / jnp.maximum(c, 1),
                 "float32", (3,), None, False),
    "first": (lambda k, v, c: v[0], lambda k, v, c: v[0], "float32", (),
              None, True),
    "reapply_sum": (lambda k, v, c: v.sum(), lambda k, v, c: jnp.sum(v),
                    "int32", (), _manual_reapply, True),
}


def apps(name, key_space=K):
    tfn, jfn, dt, shape, manual, _ = SPECS[name]
    tattrs = {"manual_combiner": manual(TC)} if manual else {}
    jattrs = {"manual_combiner": manual(JC)} if manual else {}
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]), tfn,
                      key_space=key_space,
                      value_spec=T.ValueSpec(shape, getattr(torch, dt)),
                      emit_capacity=1, max_values_per_key=64, **tattrs)
    japp = J.make_app(map_fn=lambda item, emit: emit(item[0], item[1]),
                      reduce_fn=jfn, key_space=key_space,
                      value_aval=jax.ShapeDtypeStruct(shape,
                                                      getattr(jnp, dt)),
                      emit_capacity=1, max_values_per_key=64, **jattrs)
    return tapp, japp


def kv_items(name, n=N, seed=0, key_space=K):
    """(keys [n] int32 with about a tenth the sentinel, values [n, ...])."""
    _, _, dt, shape, _, _ = SPECS[name]
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, key_space, n).astype(np.int32)
    keys[rng.random(n) < 0.1] = key_space
    if dt == "int32":
        vals = rng.integers(-50, 50, (n,) + shape).astype(np.int32)
    else:
        vals = rng.standard_normal((n,) + shape).astype(np.float32)
    return keys, vals


def host(x):
    return x.detach().cpu().numpy()


def assert_same(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        if got.dtype.kind == "f":
            assert got.astype(want.dtype).tobytes() == want.tobytes()
        else:
            np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **SUM_TOL)


_REF: dict = {}


def reference_local(name, flow):
    """The reference's ``run_local`` result (numpy), cached."""
    if (name, flow) not in _REF:
        _, japp = apps(name)
        keys, vals = kv_items(name)
        res = J.MapReduce(japp, flow=flow, cache=False).run(
            (jnp.asarray(keys), jnp.asarray(vals)))
        _REF[name, flow] = (np.asarray(res.keys), np.asarray(res.values),
                            np.asarray(res.counts))
    return _REF[name, flow]


def run_port(name, flow, shards, **opts):
    tapp, _ = apps(name)
    keys, vals = kv_items(name)
    mr = T.MapReduce(tapp, flow=flow, device="cpu")
    return mr, mr.run_distributed(
        (torch.from_numpy(keys), torch.from_numpy(vals)),
        mesh=LocalMesh(shards, "cpu"),
        options=T.ExecutionOptions(**opts) if opts else None)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("flow", FLOWS)
def test_local_mesh_equals_reference_run_local(flow, name, shards):
    _, res = run_port(name, flow, shards)
    jk, jv, jc = reference_local(name, flow)
    # sort and reduce results are key-sharded, [S * K/S] rows here
    assert res.keys.shape[0] == K
    np.testing.assert_array_equal(host(res.keys), jk)
    np.testing.assert_array_equal(host(res.counts), jc)
    assert_same(host(res.values), jv, SPECS[name][5])
    assert res.plan.flow == flow


def shard_partials(mr, flow, items, shards):
    """Each shard's un-finalized (tables, counts) by the local machinery:
    the stream flow's ``LocalRun`` at the plan's tiling, the combine
    flow's fold of the shard's mapped pairs."""
    app, spec = mr.app, mr.plan.spec
    blocks = TENG.shard_items(items, shards)
    out = []
    for b in blocks:
        if flow == "stream":
            run = TENG.LocalRun(app, "stream", spec, device="cpu",
                                chunk_pairs=mr.tiling.chunk_pairs,
                                key_block=(mr.tiling.key_block
                                           if mr.tiling.blocked else None))
            out.append(run.tables(b)[1:])
        else:
            out.append(TENG._combine_local_tables(
                app, spec, TENG.map_phase(app, b, torch.device("cpu")),
                combine_impl="auto", use_kernels=False))
    return out


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("flow", ["stream", "combine"])
def test_merge_equals_merge_partial_tables_bitwise(flow, name, shards):
    mr, res = run_port(name, flow, shards)
    keys, vals = kv_items(name)
    items = (torch.from_numpy(keys), torch.from_numpy(vals))
    parts = shard_partials(mr, flow, items, shards)
    wk, wv, wc = TENG.merge_partial_tables(
        mr.app, mr.plan.spec, [p[0] for p in parts], [p[1] for p in parts])
    assert torch.equal(res.keys, wk) and torch.equal(res.counts, wc)
    assert host(res.values).tobytes() == host(wv).tobytes()


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", ["bbox", "centroid", "int_sum",
                                  "reapply_sum"])
@pytest.mark.parametrize("flow", ["stream", "combine"])
def test_scatter_output_is_the_replicated_result_key_sharded(flow, name,
                                                             shards):
    _, rep = run_port(name, flow, shards)
    _, sc = run_port(name, flow, shards, scatter_output=True)
    assert torch.equal(sc.keys, rep.keys)
    assert torch.equal(sc.counts, rep.counts)
    assert host(sc.values).tobytes() == host(rep.values).tobytes()
    assert sc.layout.sharded and not rep.layout.sharded


def test_scatter_output_needs_a_divisible_key_space():
    tapp, _ = apps("int_sum", key_space=10)
    keys, vals = kv_items("int_sum", key_space=10)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        T.MapReduce(tapp, flow="stream", device="cpu").run_distributed(
            (torch.from_numpy(keys), torch.from_numpy(vals)),
            mesh=LocalMesh(4, "cpu"),
            options=T.ExecutionOptions(scatter_output=True))


# ---------------------------------------------------------------------------
# Against the reference's own 4-device mesh (one subprocess)
# ---------------------------------------------------------------------------

REF_MESH = """
import numpy as np, jax, jax.numpy as jnp, sys
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.core import MapReduceApp, plan_execution
from repro.core import engine as eng

out = {}
mesh = jax.make_mesh((4,), ("data",))
V = 50
class WC(MapReduceApp):
    key_space = V
    value_aval = jax.ShapeDtypeStruct((), jnp.int32)
    max_values_per_key = 256
    emit_capacity = 8
    def map(self, item, emit): emit(item, item % 7 - 3)
    def reduce(self, key, values, count): return jnp.sum(values)
rng = np.random.default_rng(0)
toks = rng.integers(0, V, (64, 8)).astype(np.int32)
np.save(sys.argv[1] + "/toks.npy", toks)
with mesh:
    x = jax.device_put(jnp.asarray(toks), NamedSharding(mesh, P("data")))
    for flow in ("sort", "reduce"):
        k, v, c = eng.run_distributed(WC(), plan_execution(WC(), flow=flow),
                                      x, mesh=mesh)
        out[flow] = (np.asarray(k), np.asarray(v), np.asarray(c))

class BB(MapReduceApp):
    key_space = 12
    value_aval = jax.ShapeDtypeStruct((2,), jnp.float32)
    emit_capacity = 1
    def map(self, item, emit): emit(item[0].astype(jnp.int32), item[1:])
    def reduce(self, key, values, count):
        return jnp.concatenate([jnp.max(values, 0), jnp.min(values, 0)])
bits = np.load(sys.argv[1] + "/bbox.npy")
with mesh:
    x = jax.device_put(jnp.asarray(bits.view(np.float32)),
                       NamedSharding(mesh, P("data")))
    for flow in ("stream", "sort"):
        k, v, c = eng.run_distributed(BB(), plan_execution(BB(), flow=flow),
                                      x, mesh=mesh)
        out["bbox_" + flow] = (np.asarray(k), np.asarray(v), np.asarray(c))
    try:
        eng.run_distributed(WC(), plan_execution(WC(), flow="stream"),
                            jnp.asarray(toks[:10]), mesh=mesh)
        out["indivisible"] = "ran"
    except Exception as e:
        out["indivisible"] = type(e).__name__
from repro.core import MapReduce
res = MapReduce(BB(), flow="stream", cache=False).run(
    jnp.asarray(bits.view(np.float32)))
out["bbox_local"] = np.asarray(res.values)
np.save(sys.argv[1] + "/out.npy", np.asarray(out, dtype=object),
        allow_pickle=True)
print("REF_MESH_OK")
"""


def bbox_items():
    """Key-in-column-0 items of 12 keys with planted NaNs of random payload
    and sign, and signed zeros, as float32 bits."""
    rng = np.random.default_rng(5)
    n = 256
    vals = rng.standard_normal((n, 2)).astype(np.float32)
    p = rng.random((n, 2))
    vals[p < 0.1] = 0.0
    vals[(p >= 0.1) & (p < 0.2)] = -0.0
    nan = (p >= 0.2) & (p < 0.26)
    payload = (np.uint32(0x7FC00000)
               | rng.integers(1, 1 << 22, nan.sum(), dtype=np.uint32)
               | (rng.integers(0, 2, nan.sum(), dtype=np.uint32)
                  << np.uint32(31)))
    vals[nan] = payload.view(np.float32)
    keys = rng.integers(0, 12, n).astype(np.float32)
    items = np.concatenate([keys[:, None], vals], axis=1)
    return items.view(np.uint32)


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    d = tmp_path_factory.mktemp("refmesh")
    np.save(d / "bbox.npy", bbox_items())
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_MESH, str(d)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.load(d / "toks.npy"), np.load(d / "out.npy",
                                            allow_pickle=True).item()


def wc_app(vocab=50):
    return T.make_app(lambda item, emit: emit(item, item % 7 - 3),
                      lambda k, v, c: v.sum(), key_space=vocab,
                      value_spec=T.ValueSpec((), I32), emit_capacity=8,
                      max_values_per_key=256)


def bbox_app():
    return T.make_app(
        lambda item, emit: emit(item[0].to(I32), item[1:]),
        lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]), key_space=12,
        value_spec=T.ValueSpec((2,), F32), emit_capacity=1)


@pytest.mark.parametrize("flow", ["sort", "reduce"])
def test_key_sharded_layout_equals_reference_mesh(reference_mesh, flow):
    """K = 50 over 4 shards: [4 * 13] rows, the last shard's padded, keys
    past K at zero count, as the reference's mesh run lays them out."""
    toks, out = reference_mesh
    res = T.MapReduce(wc_app(), flow=flow, device="cpu").run_distributed(
        torch.from_numpy(toks), mesh=LocalMesh(4, "cpu"))
    jk, jv, jc = out[flow]
    assert res.keys.shape == (52,)
    np.testing.assert_array_equal(host(res.keys), jk)
    np.testing.assert_array_equal(host(res.counts), jc)
    np.testing.assert_array_equal(host(res.values)[jc > 0], jv[jc > 0])


@pytest.mark.parametrize("flow", ["stream", "sort"])
def test_nan_payloads_against_reference_mesh(reference_mesh, flow):
    """Max/min over planted NaN payloads and signed zeros, the port's
    4-shard run against the reference: bit for bit with the reference's
    ``run_local`` (JAX's rule: a NaN propagates, with its payload) on both
    flows.  The reference's 4-device mesh run agrees on the sort flow,
    where each key folds in one shard; on the stream flow its ``pmax`` /
    ``pmin`` across shards drop NaNs (ROADMAP C.42), so it agrees exactly
    where no shard's partial is a NaN, and elsewhere holds the max/min of
    the partials that are not."""
    _, out = reference_mesh
    items = torch.from_numpy(bbox_items().view(np.float32))
    res = T.MapReduce(bbox_app(), flow=flow, device="cpu").run_distributed(
        items, mesh=LocalMesh(4, "cpu"))
    jk, jv, jc = out["bbox_" + flow]
    np.testing.assert_array_equal(host(res.counts), jc)
    got = host(res.values)
    assert got.view(np.uint32).tobytes() == \
        out["bbox_local"].view(np.uint32).tobytes()
    if flow == "sort":
        assert got.view(np.uint32).tobytes() == jv.view(np.uint32).tobytes()
        return
    # the shards' partial max/min, by the port's (and JAX's) rule
    blocks = bbox_items().view(np.float32).reshape(4, -1, 3)
    parts = np.stack([T.MapReduce(bbox_app(), flow="stream", device="cpu")
                      .run(torch.from_numpy(b)).values.numpy()
                      for b in blocks])
    nan_part = np.isnan(parts).any(axis=0)
    same = got.view(np.uint32) == jv.view(np.uint32)
    assert same[~nan_part].all()
    assert nan_part.any() and not same[nan_part].all()
    clean = np.where(np.isnan(parts), np.nan, parts)
    want = np.concatenate([np.nanmax(clean[..., :2], axis=0),
                           np.nanmin(clean[..., 2:], axis=0)], axis=1)
    np.testing.assert_array_equal(jv[nan_part], want[nan_part])


def test_indivisible_item_count_raises_as_the_reference(reference_mesh):
    toks, out = reference_mesh
    assert out["indivisible"] != "ran"
    with pytest.raises(ValueError, match="evenly divisible"):
        T.MapReduce(wc_app(), flow="stream", device="cpu").run_distributed(
            torch.from_numpy(toks[:10]), mesh=LocalMesh(4, "cpu"))


# ---------------------------------------------------------------------------
# Skew plans, wire codecs, overflow
# ---------------------------------------------------------------------------


def zipf_tokens(n_items=256, vocab=256, seed=7, hot=5):
    rng = np.random.default_rng(seed)
    toks = (rng.zipf(1.1, (n_items, 8)) % vocab).astype(np.int32)
    toks[::2] = hot  # half the pairs on one key
    return toks


def wc_count_app(vocab=256):
    return T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                      lambda k, v, c: v.sum(), key_space=vocab,
                      value_spec=T.ValueSpec((), I32), emit_capacity=8,
                      max_values_per_key=2048)


@pytest.mark.parametrize("wire", ["raw", "delta"])
@pytest.mark.parametrize("flow", ["sort", "reduce"])
def test_skew_auto_hot_split_equals_local_runs_and_numpy(flow, wire):
    """Zipf tokens with a key holding half the pairs, over 4 shards:
    balanced boundaries (and, on the sort flow, a hot key split) give the
    counts of ``np.bincount`` and the bits of the port's and the
    reference's local runs, and of ``skew="off"``; nothing overflows under
    ``strict=True``."""
    TSK.clear_memo()
    toks = zipf_tokens()
    want = np.bincount(toks.reshape(-1), minlength=256)
    items = torch.from_numpy(toks)
    mr = T.MapReduce(wc_count_app(), flow=flow, device="cpu", cache=False)
    auto = mr.run_distributed(items, mesh=LocalMesh(4, "cpu"),
                              options=T.ExecutionOptions(
                                  shuffle=TSK.ShuffleOptions(
                                      skew="auto", wire=wire, strict=True)))
    off = T.MapReduce(wc_count_app(), flow=flow, device="cpu").run_distributed(
        items, mesh=LocalMesh(4, "cpu"),
        options=T.ExecutionOptions(shuffle=TSK.ShuffleOptions(capacity=2048)))
    local = T.MapReduce(wc_count_app(), flow=flow, device="cpu").run(items)
    japp = J.make_app(map_fn=lambda item, emit: emit(item,
                                                     jnp.ones_like(item)),
                      reduce_fn=lambda k, v, c: jnp.sum(v), key_space=256,
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                      emit_capacity=8, max_values_per_key=2048)
    jres = J.MapReduce(japp, flow=flow, cache=False).run(jnp.asarray(toks))
    assert auto.keys.shape == (256,)  # densified
    np.testing.assert_array_equal(host(auto.counts), want)
    np.testing.assert_array_equal(host(auto.values), want)
    np.testing.assert_array_equal(host(auto.values), host(local.values))
    np.testing.assert_array_equal(host(auto.values), np.asarray(jres.values))
    np.testing.assert_array_equal(host(off.values)[:256], want)
    text = mr.explain()
    assert "skew: boundaries: 4 ranges" in text
    assert ("hot keys split" in text) == (flow == "sort")
    assert not any("overflow" in d for d in auto.diagnostics)


def test_hot_split_on_float_sums_within_tolerance_of_numpy():
    TSK.clear_memo()
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 128, 4096).astype(np.int32)
    keys[rng.random(4096) < 0.4] = 77
    w = rng.random(4096).astype(np.float32)
    app = T.make_app(lambda item, emit: emit(item[0].to(I32), item[1]),
                     lambda k, v, c: v.sum(), key_space=128,
                     value_spec=T.ValueSpec((), F32), emit_capacity=1)
    items = (torch.from_numpy(keys), torch.from_numpy(w))
    mr = T.MapReduce(app, flow="sort", device="cpu", cache=False)
    res = mr.run_distributed(items, mesh=LocalMesh(4, "cpu"),
                             options=T.ExecutionOptions(
                                 shuffle=TSK.ShuffleOptions(skew="auto")))
    assert "hot keys split: 77x" in mr.explain()
    np.testing.assert_array_equal(host(res.counts),
                                  np.bincount(keys, minlength=128))
    np.testing.assert_allclose(
        host(res.values), np.bincount(keys, weights=w.astype(np.float64),
                                      minlength=128), **SUM_TOL)


@pytest.mark.parametrize("wire", ["delta", "packed"])
@pytest.mark.parametrize("flow", ["sort", "reduce"])
def test_wire_codecs_against_raw(flow, wire):
    """delta gives the raw result bit for bit; packed too while the values
    fit int8 (the int-exact contract)."""
    toks = zipf_tokens(seed=3)
    items = torch.from_numpy(toks)

    def run(codec):
        return T.MapReduce(wc_app(256), flow=flow, device="cpu"
                           ).run_distributed(
            items, mesh=LocalMesh(4, "cpu"), options=T.ExecutionOptions(
                shuffle=TSK.ShuffleOptions(wire=codec, capacity=2048)))

    raw, enc = run("raw"), run(wire)
    assert torch.equal(raw.counts, enc.counts)
    assert torch.equal(raw.values, enc.values)


def test_measured_wire_bytes_equal_the_roofline_model():
    toks = zipf_tokens(seed=4)
    mr = T.MapReduce(wc_app(256), flow="sort", device="cpu")
    for codec in TW.CODECS:
        comp = mr.lower(torch.from_numpy(toks), options=T.ExecutionOptions(
            mesh=LocalMesh(4, "cpu"),
            shuffle=TSK.ShuffleOptions(wire=codec, capacity=2048,
                                       strict=True))).compile()
        comp(torch.from_numpy(toks))
        ex = comp._entry.executable.last_exchange
        from repro_torch.roofline import analysis as roofline

        model = roofline.shuffle_wire_bytes(
            codec, n_pairs=toks.size, key_space=256, num_shards=4,
            value_bytes=4, value_dtype="int32", capacity=2048)
        assert ex["sent_bytes"] * 3 / 4 == model == \
            TW.wire_bytes_per_shard(ex["format"])


def test_overflow_raises_under_strict_and_warns_otherwise():
    toks = zipf_tokens(seed=1)
    items = torch.from_numpy(toks)
    mr = T.MapReduce(wc_count_app(), flow="sort", device="cpu")
    with pytest.raises(ValueError, match="shuffle overflow"):
        mr.run_distributed(items, mesh=LocalMesh(4, "cpu"),
                           options=T.ExecutionOptions(
                               shuffle=TSK.ShuffleOptions(capacity=64,
                                                          strict=True)))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        res = mr.run_distributed(items, mesh=LocalMesh(4, "cpu"),
                                 options=T.ExecutionOptions(
                                     shuffle=TSK.ShuffleOptions(capacity=64)))
    assert any(issubclass(x.category, TCOL.LoweringFallbackWarning)
               and "overflow" in str(x.message) for x in w)
    assert any("shuffle overflow" in d for d in res.diagnostics)
    assert int(res.counts.sum()) < toks.size


def test_wire_explain_lines_equal_reference():
    """``plan.wire``'s bytes line is the reference's; both name the codec."""
    toks = zipf_tokens(seed=2)
    sh_t = TSK.ShuffleOptions(wire="delta")
    mr = T.MapReduce(wc_count_app(), flow="sort", device="cpu", cache=False)
    mr.lower(torch.from_numpy(toks), options=T.ExecutionOptions(
        mesh=LocalMesh(4, "cpu"), shuffle=sh_t))
    japp = J.make_app(map_fn=lambda item, emit: emit(item,
                                                     jnp.ones_like(item)),
                      reduce_fn=lambda k, v, c: jnp.sum(v), key_space=256,
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                      emit_capacity=8)
    jmr = J.MapReduce(japp, flow="sort", cache=False)
    fake_mesh = types.SimpleNamespace(shape={"data": 4})
    jmr.plan.wire = jmr._wire_provenance(
        J.ExecutionOptions(shuffle=J.ShuffleOptions(wire="delta"),
                           mesh=fake_mesh), jnp.asarray(toks), "distributed")
    assert mr.plan.wire[0].startswith("codec delta on the all-to-all")
    assert mr.plan.wire[1:] == jmr.plan.wire[1:]
    assert "wire: modeled wire bytes/shard" in mr.explain()


# ---------------------------------------------------------------------------
# The staged path and the option surface
# ---------------------------------------------------------------------------


def test_lower_infers_distributed_and_repeat_compile_is_a_hit():
    tapp, _ = apps("centroid")
    keys, vals = kv_items("centroid")
    items = (torch.from_numpy(keys), torch.from_numpy(vals))
    mesh = LocalMesh(4, "cpu")
    mr = T.MapReduce(tapp, flow="stream", device="cpu")
    opts = T.ExecutionOptions(mesh=mesh)
    comp = mr.lower(items, options=opts).compile()
    assert comp.mode == "distributed"
    first = comp(items)
    before = pc.stats_snapshot()
    again = T.MapReduce(tapp, flow="stream", device="cpu").lower(
        items, options=opts).compile()
    delta = {k: v - before[k] for k, v in pc.stats_snapshot().items()}
    assert again.cache_event == "hit"
    assert delta["derives"] == delta["autotunes"] == delta["compiles"] == 0
    assert torch.equal(again(items).values, first.values)
    assert "mode: distributed" in again.explain()
    assert "distributed stream over local(size=4" in again.as_text()
    other = mr.lower(items, options=T.ExecutionOptions(
        mesh=LocalMesh(2, "cpu"))).compile()
    assert other.cache_key != comp.cache_key
    assert comp.cost_analysis()["flow"] == "stream"


def test_run_distributed_needs_a_mesh_and_its_axis():
    tapp, _ = apps("int_sum")
    keys, vals = kv_items("int_sum")
    items = (torch.from_numpy(keys), torch.from_numpy(vals))
    mr = T.MapReduce(tapp, device="cpu")
    with pytest.raises(TypeError, match="requires a mesh"):
        mr.run_distributed(items)
    with pytest.raises(TypeError, match="requires a mesh"):
        mr.lower(items, mode="distributed")
    with pytest.raises(ValueError, match="data axis"):
        mr.run_distributed(items, mesh=LocalMesh(2, "cpu"),
                           options=T.ExecutionOptions(data_axis="model"))
    with pytest.raises(TypeError, match="ExecutionOptions"):
        mr.run_distributed(items, mesh=LocalMesh(2, "cpu"),
                           scatter_output=True)


def test_flat_shuffle_fields_forward_with_deprecation():
    with pytest.warns(DeprecationWarning, match="deprecated"):
        opts = T.ExecutionOptions(shuffle_capacity=12, strict_shuffle=True)
    assert opts.shuffle == TSK.ShuffleOptions(capacity=12, strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        o2 = T.ExecutionOptions(shuffle=TSK.ShuffleOptions(capacity=5))
    assert (o2.shuffle_capacity, o2.strict_shuffle) == (5, False)
    with pytest.raises(TypeError, match="ShuffleOptions"):
        T.ExecutionOptions(shuffle={"capacity": 5})


# ---------------------------------------------------------------------------
# The mesh's collectives and compressed_psum
# ---------------------------------------------------------------------------


def test_local_mesh_collectives():
    mesh = LocalMesh(3, "cpu")
    xs = [torch.arange(6).reshape(3, 2) + 10 * s for s in range(3)]
    got = mesh.all_to_all(xs)
    for d in range(3):
        assert torch.equal(got[d], torch.stack([xs[s][d] for s in range(3)]))
    total = sum(xs)
    assert all(torch.equal(p, total) for p in mesh.psum(xs))
    for s, part in enumerate(mesh.psum_scatter(xs)):
        assert torch.equal(part, total[s:s + 1])
    assert torch.equal(mesh.pmax(xs)[0], xs[2])
    assert torch.equal(mesh.pmin(xs)[1], xs[0])
    assert torch.equal(mesh.all_gather(xs)[2], torch.stack(xs))
    assert mesh.axis_index() == [0, 1, 2]
    with pytest.raises(ValueError, match="one a shard"):
        mesh.psum(xs[:2])
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        mesh.all_to_all([torch.zeros(4)] * 3)


def test_compressed_psum_sums_dequantized_shards_in_order():
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(17).astype(np.float32))
          for _ in range(4)]
    got = TCOMP.compressed_psum(xs, LocalMesh(4, "cpu"))
    want = TCOMP.fake_quant_int8(xs[0])
    for x in xs[1:]:
        want = want + TCOMP.fake_quant_int8(x)
    assert all(torch.equal(g, want) for g in got)


# ---------------------------------------------------------------------------
# ProcessGroupMesh over gloo: bit for bit with LocalMesh at the same S
# ---------------------------------------------------------------------------

CASES = """
import numpy as np, torch
import repro_torch as T
from repro_torch.core import skew as TSK

I32, F32 = torch.int32, torch.float32

def cases():
    rng = np.random.default_rng(11)
    pts = rng.standard_normal((1024, 3)).astype(np.float32)
    cid = rng.integers(0, 64, 1024).astype(np.int32)
    km = T.make_app(lambda item, emit: emit(item[0], item[1]),
                    lambda k, v, c: v.sum(0) / c.clamp(min=1).to(F32),
                    key_space=64, value_spec=T.ValueSpec((3,), F32),
                    emit_capacity=1)
    bb = T.make_app(lambda item, emit: emit(item[0], item[1]),
                    lambda k, v, c: torch.cat([v.amax(0), v.amin(0)]),
                    key_space=64, value_spec=T.ValueSpec((3,), F32),
                    emit_capacity=1)
    toks = (rng.zipf(1.2, (512, 8)) % 128).astype(np.int32)
    toks[::3] = 9
    wc = T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                    lambda k, v, c: v.sum(), key_space=128,
                    value_spec=T.ValueSpec((), I32), emit_capacity=8,
                    max_values_per_key=4096)
    kv = (torch.from_numpy(cid), torch.from_numpy(pts))
    tk = torch.from_numpy(toks)
    auto = T.ExecutionOptions(shuffle=TSK.ShuffleOptions(
        skew="auto", wire="delta", strict=True))
    wide = T.ExecutionOptions(shuffle=TSK.ShuffleOptions(capacity=4096,
                                                         strict=True))
    return {
        "km_stream": (km, "stream", kv, None),
        "km_stream_scatter": (km, "stream", kv,
                              T.ExecutionOptions(scatter_output=True)),
        "km_combine": (km, "combine", kv, None),
        "bb_stream": (bb, "stream", kv, None),
        "km_sort": (km, "sort", kv, None),
        "wc_sort": (wc, "sort", tk, wide),
        "wc_reduce": (wc, "reduce", tk, wide),
        "wc_sort_skew": (wc, "sort", tk, auto),
        "wc_reduce_skew": (wc, "reduce", tk, auto),
    }

def run_all(mesh):
    out = {}
    for name, (app, flow, items, opts) in cases().items():
        res = T.MapReduce(app, flow=flow, device="cpu").run_distributed(
            items, mesh=mesh, options=opts).gather_result()
        out[name] = [res.keys.numpy(), res.values.numpy(),
                     res.counts.numpy()]
    return out
"""

WORKER = """
import sys, numpy as np, torch.distributed as dist
rank, world, port, path = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
exec(open(path + "/cases.py").read())
from repro_torch.distributed import ProcessGroupMesh
mesh = ProcessGroupMesh()
assert mesh.size == world and mesh.shards() == [rank]
out = run_all(mesh)
if rank == 0:
    np.save(path + "/pg.npy", np.asarray(out, dtype=object),
            allow_pickle=True)
dist.barrier()
dist.destroy_process_group()
print("RANK_OK", rank)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_process_group_equals_local_mesh(world, tmp_path):
    (tmp_path / "cases.py").write_text(textwrap.dedent(CASES))
    (tmp_path / "worker.py").write_text(textwrap.dedent(WORKER))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(r), str(world),
         str(port), str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
    got = np.load(tmp_path / "pg.npy", allow_pickle=True).item()
    scope: dict = {}
    exec(textwrap.dedent(CASES), scope)
    TSK.clear_memo()
    want = scope["run_all"](LocalMesh(world, "cpu"))
    assert sorted(got) == sorted(want)
    for name in want:
        for g, w in zip(got[name], want[name]):
            assert g.shape == w.shape and g.tobytes() == w.tobytes(), name
