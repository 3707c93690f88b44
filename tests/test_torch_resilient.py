"""The port's resilient driver (``run_resilient``, A12) on the CPU against
the reference's mesh-less ``engine.run_resilient`` under the same scripts.

For every flow and every scripted fault (no failure, a killed host, a
checkpoint restore, a dead disk, a straggler, an elastic 4 → 3, an uneven
6 shards over 4 hosts) and every chaos drill of
``tests/integration/test_chaos.py`` (a killed coordinator, a corrupt
partial, store timeouts, a partitioned host, the multi-fault drill):

1. the result equals the port's fault-free run and
   ``run_distributed(LocalMesh(S))`` bit for bit;
2. every ``RecoveryLog`` field but ``final_mesh`` equals the reference's
   (the event lines with the temp dir and the checksums' hex masked);
3. the values equal the reference's: integers and counts exactly, float
   sums within rtol = atol = 1e-6.

Also: input validation, a ``skew="auto"`` sort run against the local run
(C.2), checkpoints written by the reference (a sort partial restored as
it is; a stream partial carried by ``interop.shard_partial_from_repro``,
and rejected uncarried), a partial of another codec rejected by its wire
epoch, ``explain()``'s recovery lines, the staged path's repeat call, a
multi-rank ``ProcessGroupMesh`` refused (C.48), and the streaming
service's torn-write restore under a ``RetryPolicy``.
"""

import dataclasses
import os
import re
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as J  # noqa: E402
from repro.core import engine as JENG  # noqa: E402
from repro.distributed import chaos as JCH  # noqa: E402
from repro.distributed import coordination as JCO  # noqa: E402
from repro.distributed import fault as JF  # noqa: E402
import repro_torch as T  # noqa: E402
from repro_torch import apps as tapps  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core import engine as TENG  # noqa: E402
from repro_torch.core import plan_cache as pc  # noqa: E402
from repro_torch.distributed import LocalMesh  # noqa: E402
from repro_torch.distributed import chaos as TCH  # noqa: E402
from repro_torch.distributed import coordination as TCO  # noqa: E402
from repro_torch.distributed import fault as TF  # noqa: E402

VOCAB = 48
FLOWS = ("stream", "combine", "sort", "reduce")
CHAOS_FLOWS = ("stream", "sort", "reduce")
SUM_TOL = dict(rtol=1e-6, atol=1e-6)


def wc_apps():
    """Word count, int32 values: every result exact."""
    tapp = T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                      lambda k, v, c: v.sum(), key_space=VOCAB,
                      value_spec=T.ValueSpec((), torch.int32),
                      emit_capacity=8, max_values_per_key=256)
    japp = J.make_app(map_fn=lambda item, emit: emit(item,
                                                     jnp.ones_like(item)),
                      reduce_fn=lambda k, v, c: jnp.sum(v), key_space=VOCAB,
                      value_aval=jax.ShapeDtypeStruct((), jnp.int32),
                      emit_capacity=8, max_values_per_key=256)
    return tapp, japp


def fsum_apps():
    """Per-key float sums of (key, weight) items."""
    tapp = T.make_app(lambda item, emit: emit(item[0], item[1]),
                      lambda k, v, c: v.sum(), key_space=VOCAB,
                      value_spec=T.ValueSpec((), torch.float32),
                      emit_capacity=4, max_values_per_key=256)
    japp = J.make_app(map_fn=lambda item, emit: emit(item[0], item[1]),
                      reduce_fn=lambda k, v, c: jnp.sum(v), key_space=VOCAB,
                      value_aval=jax.ShapeDtypeStruct((), jnp.float32),
                      emit_capacity=4, max_values_per_key=256)
    return tapp, japp


APPS = {"wc": wc_apps, "fsum": fsum_apps}


def items_np(app: str, n: int = 64):
    rng = np.random.default_rng(0)
    if app == "wc":
        return rng.integers(0, VOCAB, (n, 8)).astype(np.int32)
    # consecutive keys: a shard's pairs spread over every key range, so no
    # destination of the all-to-all passes its default capacity
    keys = (np.arange(n * 4) % VOCAB).astype(np.int32).reshape(n, 4)
    return keys, rng.standard_normal((n, 4)).astype(np.float32)


def t_items(x):
    return (tuple(torch.from_numpy(a) for a in x) if isinstance(x, tuple)
            else torch.from_numpy(x))


def j_items(x):
    return (tuple(jnp.asarray(a) for a in x) if isinstance(x, tuple)
            else jnp.asarray(x))


_MR: dict = {}
_JPLAN: dict = {}
_JIT: dict = {}


def port_mr(app: str, flow: str):
    if (app, flow) not in _MR:
        _MR[app, flow] = T.MapReduce(APPS[app]()[0], flow=flow, device="cpu")
    return _MR[app, flow]


def reference(app: str, flow: str, x, **kw):
    """The reference's mesh-less ``run_resilient`` (numpy out, and its
    log), one derivation and one jit cache per (app, flow)."""
    japp = APPS[app]()[1]
    if (app, flow) not in _JPLAN:
        _JPLAN[app, flow] = J.plan_execution(japp, flow=flow)
    plan = dataclasses.replace(_JPLAN[app, flow], recovery=())
    k, v, c, log = JENG.run_resilient(
        japp, plan, j_items(x),
        jit_cache=_JIT.setdefault((app, flow), {}), **kw)
    return (np.asarray(k), np.asarray(v), np.asarray(c)), log, plan


def port(app: str, flow: str, x, *, mesh=None, **opts):
    return port_mr(app, flow).run_resilient(
        t_items(x), mesh=mesh, options=T.ExecutionOptions(**opts))


_CLEAN: dict = {}


def clean(app: str, flow: str, H: int, S: int, n: int):
    """The port's fault-free resilient run and ``run_distributed`` over
    ``LocalMesh(S)``, cached."""
    key = (app, flow, H, S, n)
    if key not in _CLEAN:
        x = items_np(app, n)
        res = port(app, flow, x, num_hosts=H, num_shards=S)
        dist = port_mr(app, flow).run_distributed(
            t_items(x), mesh=LocalMesh(S, "cpu"))
        _CLEAN[key] = (res, dist)
    return _CLEAN[key]


def tbits(res):
    return [t.numpy().tobytes() for t in (res.keys, res.values, res.counts)]


def masked(lines, root=None):
    """Event lines with the temp dir and the checksums' hex masked: the
    checkpoint bytes differ between the packages (int64 tables, the zip's
    time stamps), so the CRCs in a verification failure do too."""
    out = []
    for line in lines:
        if root is not None:
            line = line.replace(str(root), "<tmp>")
        out.append(re.sub(r"[0-9a-f]{8} != [0-9a-f]{8}", "<crc> != <crc>",
                          line))
    return tuple(out)


def log_fields(log, root=None) -> dict:
    d = dataclasses.asdict(log)
    d.pop("final_mesh")
    d["store_events"] = masked(d["store_events"], root)
    return d


def assert_same_as_reference(app, res, want):
    k, v, c = want
    np.testing.assert_array_equal(res.keys.numpy(), k)
    np.testing.assert_array_equal(res.counts.numpy(), c)
    if app == "wc":
        np.testing.assert_array_equal(res.values.numpy(), v)
    else:
        np.testing.assert_allclose(res.values.numpy(), v, **SUM_TOL)


def check(app, flow, x, H, S, res, want, jlog, root=None):
    """The three claims of the module docstring."""
    base, dist = clean(app, flow, H, S, len(np.atleast_1d(
        x[0] if isinstance(x, tuple) else x)))
    assert tbits(res) == tbits(base) == tbits(dist), flow
    assert log_fields(res.recovery, root) == log_fields(jlog, root)
    assert_same_as_reference(app, res, want)


# -- scripted faults -----------------------------------------------------------

SCENARIOS = {
    "none": dict(H=4, S=4),
    "kill_host": dict(H=4, S=8, inject=dict(dead_hosts=(2,))),
    "ckpt_restore": dict(H=4, S=8, ckpt="d",
                         inject=dict(dead_hosts=(1,), die_after_shards=1)),
    "dead_disk": dict(H=4, S=8, ckpt="gone",
                      inject=dict(dead_hosts=(1,), die_after_shards=1,
                                  checkpoint_survives=False)),
    "straggler": dict(H=4, S=4, inject=dict(straggler_hosts=(1,))),
    "elastic": dict(H=4, S=4, inject=dict(resize_to=3)),
    "uneven": dict(H=4, S=6, n=60),
}


def expect(name, log):
    """The reference tests' expected values of each script."""
    if name == "none":
        assert len(log.computed) == 4 and not log.recomputed
    elif name == "kill_host":
        assert log.dead_hosts == [2] and log.recomputed == [(2, 3), (6, 3)]
    elif name == "ckpt_restore":
        assert log.restored == [1] and log.recomputed == [(5, 2)]
    elif name == "dead_disk":
        assert not log.restored
        assert [s for s, _ in log.recomputed] == [1, 5]
    elif name == "straggler":
        assert log.straggler_hosts == [1] and log.speculated == [(1, 2)]
    elif name == "elastic":
        assert log.resized == (4, 3)
        assert [s for s, _ in log.recomputed] == [3]
    elif name == "uneven":
        assert log.straggler_hosts == [] and not log.speculated
        assert not log.recomputed and len(log.computed) == 6


def run_scenario(app, flow, name, tmp_path):
    sc = dict(SCENARIOS[name])
    H, S, n = sc["H"], sc["S"], sc.get("n", 64)
    x = items_np(app, n)
    kw = dict(num_hosts=H, num_shards=S)
    tkw, jkw = dict(kw), dict(kw)
    if "inject" in sc:
        tkw["inject"] = TF.FaultInjection(**sc["inject"])
        jkw["inject"] = JF.FaultInjection(**sc["inject"])
    if "ckpt" in sc:
        tkw["ckpt_dir"] = str(tmp_path / "port" / sc["ckpt"])
        jkw["ckpt_dir"] = str(tmp_path / "ref" / sc["ckpt"])
    want, jlog, _ = reference(app, flow, x, **jkw)
    res = port(app, flow, x, **tkw)
    check(app, flow, x, H, S, res, want, jlog)
    expect(name, res.recovery)
    return res


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("flow", FLOWS)
def test_scripted_fault_equals_reference(flow, name, tmp_path):
    run_scenario("wc", flow, name, tmp_path)


@pytest.mark.parametrize("name", ["none", "kill_host", "ckpt_restore"])
@pytest.mark.parametrize("flow", FLOWS)
def test_scripted_fault_float_sums(flow, name, tmp_path):
    run_scenario("fsum", flow, name, tmp_path)


@pytest.mark.parametrize("flow", FLOWS)
def test_engine_entry_point_equals_api(flow):
    """``engine.run_resilient`` (the engine layer, plain keyword
    arguments) gives the API's bits, with the plan's tiling."""
    mr = port_mr("wc", flow)
    x = items_np("wc")
    plan = dataclasses.replace(mr.plan, recovery=())
    k, v, c, log = TENG.run_resilient(
        mr.app, plan, t_items(x), num_hosts=4, num_shards=8, device="cpu",
        inject=TF.FaultInjection(dead_hosts=(2,)),
        chunk_pairs=mr.tiling.chunk_pairs if mr.tiling else None)
    res = port("wc", flow, x, num_hosts=4, num_shards=8,
               inject=TF.FaultInjection(dead_hosts=(2,)))
    assert [t.numpy().tobytes() for t in (k, v, c)] == tbits(res)
    assert any("recomputed" in line for line in plan.recovery)


@pytest.mark.parametrize("flow", FLOWS)
def test_mesh_argument_and_elastic_final_mesh(flow):
    """``mesh=LocalMesh(S)`` sets H = S; an elastic resize continues on
    ``LocalMesh(new_H)`` (``elastic.best_mesh``)."""
    x = items_np("wc")
    res = port("wc", flow, x, mesh=LocalMesh(8, "cpu"),
               inject=TF.FaultInjection(resize_to=4))
    log = res.recovery
    assert (log.num_hosts, log.num_shards, log.resized) == (8, 8, (8, 4))
    assert log.moved == [4, 5, 6, 7]
    assert log.recomputed == [(4, 0), (5, 1), (6, 2), (7, 3)]
    assert isinstance(log.final_mesh, LocalMesh)
    assert log.final_mesh.size == 4
    assert tbits(res) == tbits(clean("wc", flow, 8, 8, 64)[1])


def test_validates_inputs():
    mr = port_mr("wc", "stream")
    with pytest.raises(ValueError, match="divide"):
        mr.run_resilient(t_items(items_np("wc", 60)),
                         options=T.ExecutionOptions(num_hosts=8,
                                                    num_shards=8))
    with pytest.raises(ValueError, match="positive"):
        mr.run_resilient(t_items(items_np("wc")),
                         options=T.ExecutionOptions(num_hosts=0))
    with pytest.raises(ValueError, match="resize_to must be positive"):
        mr.run_resilient(t_items(items_np("wc")), options=T.ExecutionOptions(
            num_hosts=4, inject=TF.FaultInjection(resize_to=0)))
    with pytest.raises(TypeError, match="ExecutionOptions"):
        mr.run_resilient(t_items(items_np("wc")), num_hosts=4)


def test_multi_rank_process_group_mesh_is_refused():
    """Every shard runs in one process (C.48): a ProcessGroupMesh of more
    than one rank raises, naming the note."""
    fake = LocalMesh(2, "cpu")
    fake.kind = "process_group"
    with pytest.raises(NotImplementedError, match="C.48"):
        TENG.run_resilient(port_mr("wc", "stream").app,
                           port_mr("wc", "stream").plan,
                           t_items(items_np("wc")), mesh=fake)


# -- chaos drills ------------------------------------------------------------


def _chaos(pkg):
    ch, co = pkg
    return {
        "coordinator_kill": dict(chaos=ch.ChaosPlan().kill_coordinator(
            after=1)),
        "corrupt_one_of_eight": dict(chaos=ch.ChaosPlan().kill_host(
            2, after=2).corrupt_checkpoint(2)),
        "store_timeout": dict(
            retry=co.RetryPolicy(max_attempts=4, base_delay_s=0.01),
            chaos=ch.ChaosPlan().delay_store(2)),
        "partition": dict(chaos=ch.ChaosPlan().partition(3)),
        "multifault": dict(
            retry=co.RetryPolicy(max_attempts=4, base_delay_s=0.01),
            chaos=(ch.ChaosPlan().kill_coordinator(after=1)
                   .corrupt_checkpoint(0).straggler(3).delay_store(1))),
    }


def expect_chaos(name, log, plan_lines, ckpt_dir):
    if name == "coordinator_kill":
        assert log.coordinator == 0 and log.failover == (0, 1, 2)
        assert 0 in log.dead_hosts and log.restored
        assert any("failover" in e and "adopted" in e for e in plan_lines)
    elif name == "corrupt_one_of_eight":
        assert log.corrupt == [2]
        assert 2 not in log.restored and 6 in log.restored
        assert 2 in [s for s, _ in log.recomputed]
        assert os.path.isdir(os.path.join(ckpt.shard_partial_dir(ckpt_dir, 2),
                                          "step_0.corrupt"))
        assert any("quarantined" in e for e in plan_lines)
    elif name == "store_timeout":
        assert any("backing off" in e for e in log.store_events)
        assert any("succeeded on attempt" in e for e in log.store_events)
        assert any("retry:" in e for e in plan_lines)
    elif name == "partition":
        assert log.partitioned == [3] and 3 in log.dead_hosts
        assert any("partition" in e for e in plan_lines)
    elif name == "multifault":
        assert log.failover == (0, 1, 2) and log.corrupt == [0]
        assert log.straggler_hosts == [3]


@pytest.mark.parametrize("name", sorted(_chaos((TCH, TCO))))
@pytest.mark.parametrize("flow", CHAOS_FLOWS)
def test_chaos_drill_equals_reference(flow, name, tmp_path):
    x = items_np("wc")
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    want, jlog, _ = reference("wc", flow, x, num_hosts=4, num_shards=8,
                              ckpt_dir=jd, **_chaos((JCH, JCO))[name])
    mr = T.MapReduce(port_mr("wc", flow).app, flow=flow, device="cpu")
    res = mr.run_resilient(t_items(x), options=T.ExecutionOptions(
        num_hosts=4, num_shards=8, ckpt_dir=td, **_chaos((TCH, TCO))[name]))
    base, dist = clean("wc", flow, 4, 8, 64)
    assert tbits(res) == tbits(base) == tbits(dist)
    assert log_fields(res.recovery) == log_fields(jlog)
    assert_same_as_reference("wc", res, want)
    expect_chaos(name, res.recovery, mr.plan.recovery, td)
    assert mr.plan.recovery == res.plan.recovery


def test_chaos_store_timeouts_exhaust_the_bounded_budget(tmp_path):
    with pytest.raises(TCO.RetryError, match="bounded attempts"):
        port("wc", "stream", items_np("wc"), num_hosts=4, num_shards=8,
             ckpt_dir=str(tmp_path),
             retry=TCO.RetryPolicy(max_attempts=2, base_delay_s=0.0),
             chaos=TCH.ChaosPlan().delay_store(50))


def test_chaos_events_reach_explain(tmp_path):
    mr = T.MapReduce(port_mr("wc", "stream").app, flow="stream",
                     device="cpu")
    mr.run_resilient(t_items(items_np("wc")), options=T.ExecutionOptions(
        num_hosts=4, num_shards=8, ckpt_dir=str(tmp_path),
        retry=TCO.RetryPolicy(max_attempts=3, base_delay_s=0.25),
        chaos=TCH.ChaosPlan().kill_coordinator(after=1).delay_store(1)))
    text = mr.explain()
    assert "recovery: lease: host 0 elected coordinator" in text
    assert "backing off 0.25s" in text
    assert "host 1 adopted" in text


@pytest.mark.parametrize("store", ["path", "store", "kv"])
def test_coord_knobs_through_execution_options(tmp_path, store):
    """``coord`` as a directory, a ``CoordinationStore`` (rebound onto the
    drill's clock) or a ``KVStore``; the file store holds the reference's
    records."""
    root = str(tmp_path / "coord")
    coord = {"path": root,
             "store": TCO.CoordinationStore(root),
             "kv": TCO.FileKVStore(root)}[store]
    res = port("wc", "stream", items_np("wc"), num_hosts=4, num_shards=8,
               ckpt_dir=str(tmp_path), coord=coord,
               retry=TCO.RetryPolicy(max_attempts=4, base_delay_s=0.01),
               chaos=TCH.ChaosPlan().kill_coordinator(after=1).delay_store(1))
    log = res.recovery
    assert log.failover == (0, 1, 2)
    assert any("backing off" in e for e in log.store_events)
    assert tbits(res) == tbits(clean("wc", "stream", 4, 8, 64)[0])
    kv = JCO.FileKVStore(root)  # the reference reads the port's store
    assert JCO.Lease.from_json(kv.get("lease")).holder == 1
    assert (JCO.CoordinationStore(kv).load_ledger(0)
            == TCO.CoordinationStore(TCO.FileKVStore(root)).load_ledger(0))


# -- skew, checkpoints across packages and codecs ---------------------------


def test_skew_auto_sort_equals_local_run():
    """A hot key split over 3 ranges: the resilient sort run equals the
    single-host local run (C.2: the reference's own skewed resilient run
    differs from its local one) and ``run_distributed`` bit for bit."""
    K = 64
    rng = np.random.default_rng(5)
    toks = torch.from_numpy((rng.zipf(1.3, size=4096) % K).astype(
        np.int32).reshape(-1, 16))
    app = tapps.WordCount(K)
    sh = T.ShuffleOptions(skew="auto", strict=True)
    mr = T.MapReduce(app, flow="sort", device="cpu")
    res = mr.run_resilient(toks, options=T.ExecutionOptions(
        num_hosts=4, num_shards=4, shuffle=sh,
        inject=TF.FaultInjection(dead_hosts=(1,))))
    log = res.recovery
    assert any("hot keys split" in line for line in log.skew_plan)
    assert log.boundary_epoch != 0 and log.recomputed == [(1, 2)]
    local = T.MapReduce(app, flow="sort", device="cpu").run(toks)
    assert torch.equal(res.counts, local.counts)
    assert torch.equal(res.values, local.values)
    dist = T.MapReduce(app, flow="sort", device="cpu").run_distributed(
        toks, mesh=LocalMesh(4, "cpu"), options=T.ExecutionOptions(
            shuffle=sh))
    assert tbits(res) == tbits(dist)
    assert "recovery: skew: hot keys split" in mr.explain()


@pytest.mark.parametrize("flow", ["sort", "reduce"])
def test_reference_written_wire_partial_is_restored(flow, tmp_path):
    """The reference checkpoints every sort (reduce) partial; the port
    restores host 3's shards from them as they are, to its own bits."""
    d = str(tmp_path)
    x = items_np("wc")
    reference("wc", flow, x, num_hosts=4, num_shards=8, ckpt_dir=d)
    res = port("wc", flow, x, num_hosts=4, num_shards=8, ckpt_dir=d,
               inject=TF.FaultInjection(dead_hosts=(3,)))
    log = res.recovery
    assert log.restored == [3, 7] and not log.recomputed
    assert not log.epoch_rejects
    assert tbits(res) == tbits(clean("wc", flow, 4, 8, 64)[0])


@pytest.mark.parametrize("flow", ["stream", "combine"])
def test_reference_table_partial_carried_or_rejected(flow, tmp_path):
    """A reference stream (combine) partial holds int32 tables: carried
    through ``interop.shard_partial_from_repro`` it restores to the port's
    bits; uncarried, its layout is rejected and the shards recomputed."""
    jd, td = str(tmp_path / "ref"), str(tmp_path / "port")
    x = items_np("wc")
    reference("wc", flow, x, num_hosts=4, num_shards=8, ckpt_dir=jd)
    mr = port_mr("wc", flow)
    run = TENG.resilient_run(
        mr.app, mr.plan, num_shards=8, shard_items_n=8,
        device=torch.device("cpu"),
        chunk_pairs=mr.tiling.chunk_pairs if mr.tiling else None)
    for s in range(8):
        tree, _ = ckpt.restore(ckpt.shard_partial_dir(jd, s),
                               {"counts": 0, "tables": (0,)}, device="cpu")
        assert tree["tables"][0].dtype == torch.int32
        got = interop.shard_partial_from_repro(run, tree)
        assert got["tables"][0].dtype == torch.int64
        ckpt.save(ckpt.shard_partial_dir(td, s), 0, got)
    want = tbits(clean("wc", flow, 4, 8, 64)[0])
    inj = TF.FaultInjection(dead_hosts=(3,))
    res = port("wc", flow, x, num_hosts=4, num_shards=8, ckpt_dir=td,
               inject=inj)
    assert res.recovery.restored == [3, 7] and tbits(res) == want
    res = port("wc", flow, x, num_hosts=4, num_shards=8, ckpt_dir=jd,
               inject=inj)
    log = res.recovery
    assert log.epoch_rejects == [3, 7] and not log.restored
    assert log.recomputed == [(3, 0), (7, 0)] and tbits(res) == want
    assert sum("different wire layout" in e for e in log.store_events) == 2


def test_other_codec_partial_rejected_by_wire_epoch(tmp_path):
    """Partials checkpointed under the delta codec carry another wire
    epoch: a raw run rejects them and recomputes, as the reference does
    (the same log), and delta's restore is raw's bits."""
    d = str(tmp_path / "port")
    x = items_np("wc")
    delta = T.ShuffleOptions(wire="delta")
    port("wc", "sort", x, num_hosts=4, num_shards=8, ckpt_dir=d,
         shuffle=delta)
    res = port("wc", "sort", x, num_hosts=4, num_shards=8, ckpt_dir=d,
               inject=TF.FaultInjection(dead_hosts=(3,)))
    assert res.recovery.epoch_rejects == [3, 7] and not res.recovery.restored
    jd = str(tmp_path / "ref")
    reference("wc", "sort", x, num_hosts=4, num_shards=8, ckpt_dir=jd,
              wire="delta")
    _, jlog, _ = reference("wc", "sort", x, num_hosts=4, num_shards=8,
                           ckpt_dir=jd,
                           inject=JF.FaultInjection(dead_hosts=(3,)))
    assert log_fields(res.recovery) == log_fields(jlog)
    want = tbits(clean("wc", "sort", 4, 8, 64)[0])
    assert tbits(res) == want
    d2 = str(tmp_path / "delta")  # d's shards 3 and 7 are raw's now
    port("wc", "sort", x, num_hosts=4, num_shards=8, ckpt_dir=d2,
         shuffle=delta)
    restored = port("wc", "sort", x, num_hosts=4, num_shards=8, ckpt_dir=d2,
                    shuffle=delta, inject=TF.FaultInjection(dead_hosts=(3,)))
    assert restored.recovery.restored == [3, 7]
    assert tbits(restored) == want


def test_wire_partial_epoch_is_uint32_on_disk(tmp_path):
    """C.47: the epoch is stored as the reference's ``[1]`` uint32 and
    read back as an int."""
    d = str(tmp_path)
    port("wc", "sort", items_np("wc"), num_hosts=4, num_shards=8, ckpt_dir=d)
    with np.load(os.path.join(ckpt.shard_partial_dir(d, 0), "step_0",
                              "arrays.npz")) as z:
        dtypes = {str(z[k].dtype) for k in z.files}
    assert "uint32" in dtypes
    tree, _ = ckpt.restore(ckpt.shard_partial_dir(d, 0),
                           {"overflow": 0, "wire": {"keys": 0, "vals": 0},
                            "wire_epoch": 0}, device="cpu")
    assert tree["wire_epoch"].dtype == torch.uint32
    assert tree["overflow"].dtype == torch.int32


# -- the staged path ---------------------------------------------------------


def test_explain_recovery_lines_and_result():
    mr = T.MapReduce(port_mr("wc", "sort").app, flow="sort", device="cpu")
    res = mr.run_resilient(t_items(items_np("wc")), options=T.ExecutionOptions(
        num_hosts=4, num_shards=8,
        inject=TF.FaultInjection(dead_hosts=(2,))))
    text = mr.explain()
    assert ("recovery: resilient run: 8 shards over 4 hosts at step 0; 6 "
            "computed in the primary phase") in text
    assert ("recovery: detected dead hosts [2]; restored [] from "
            "checkpointed partials, recomputed [2, 6] on backup ranks [3]"
            ) in text
    lines = text.splitlines()
    first = next(i for i, x in enumerate(lines) if x.startswith("recovery:"))
    assert all(x.startswith("recovery: ") for x in lines[first:])
    assert res.recovery.summary() == tuple(
        x[len("recovery: "):] for x in lines if x.startswith("recovery: "))
    assert "mode: resilient" in mr.lower(
        t_items(items_np("wc")), mode="resilient").compile().explain()


def test_repeat_call_derives_tunes_and_compiles_nothing():
    app = port_mr("wc", "sort").app
    x = t_items(items_np("wc"))
    opts = T.ExecutionOptions(num_hosts=4, num_shards=8)
    mr = T.MapReduce(app, flow="sort", device="cpu")
    before = pc.stats_snapshot()
    first = mr.run_resilient(x, options=opts)
    mid = pc.stats_snapshot()
    assert mid["compiles"] - before["compiles"] == 1
    again = mr.run_resilient(x, options=dataclasses.replace(
        opts, inject=TF.FaultInjection(dead_hosts=(1,))))
    delta = {k: v - mid[k] for k, v in pc.stats_snapshot().items()}
    assert all(delta[k] == 0 for k in ("derives", "autotunes", "compiles")), \
        delta
    assert tbits(first) == tbits(again)
    comp = mr.lower(x, mode="resilient", options=opts).compile()
    assert comp.cache_key is None and comp.num_shards == 8
    assert "resilient driver: 8 shards" in comp.as_text()


# -- the streaming service: torn write, retried restore ----------------------


def test_service_torn_write_restore_with_retry_policy(tmp_path):
    """The newest snapshot is torn (``chaos.corrupt_service_checkpoint``):
    ``restore()`` under a ``RetryPolicy`` quarantines it, falls back to
    the newest valid one bit for bit, and replaying the lost batches
    reconverges."""
    B = 16
    app = T.make_app(lambda item, emit: emit(item, torch.ones_like(item)),
                     lambda k, v, c: v.sum(), key_space=VOCAB,
                     value_spec=T.ValueSpec((), torch.int32),
                     emit_capacity=1, max_values_per_key=4096)
    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.integers(0, VOCAB, (B,)).astype(
        np.int32)) for _ in range(8)]
    d = str(tmp_path)
    events: list = []

    class Recording(TCO.RetryPolicy):
        def call(self, fn, **kw):
            events.append(kw.get("op"))
            return super().call(fn, **kw)

    def build():
        return T.MapReduce(app, streaming=True, device="cpu").serve(
            batch_capacity=B, ckpt_dir=d, ckpt_every=2,
            item_spec=pc.TensorSpec((), torch.int32),
            retry_policy=Recording(max_attempts=3, base_delay_s=0.0))

    svc = build()
    for i, b in enumerate(batches):
        svc.ingest(b)
        if i == 5:
            want6 = svc.snapshot()
    assert ckpt.latest_step(ckpt.service_state_dir(d)) == 8
    assert TCH.corrupt_service_checkpoint(d, 8) is not None
    fresh = build()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = fresh.restore()
    assert got == 6 and fresh.batch_id == 6 and events
    assert torch.equal(fresh.snapshot().values, want6.values)
    assert os.path.isdir(os.path.join(ckpt.service_state_dir(d),
                                      "step_8.corrupt"))
    for b in batches[6:]:
        fresh.ingest(b)
    assert torch.equal(fresh.snapshot().values, svc.snapshot().values)
    TCH.corrupt_payload(os.path.join(ckpt.service_state_dir(d), "step_6",
                                     "arrays.npz"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="step 6"):
        build().restore(step=6)
