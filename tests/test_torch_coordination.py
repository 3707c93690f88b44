"""The port's durable control plane (``repro_torch.distributed.
coordination``) and chaos scripts (``chaos``) against the reference's:
the retry schedules and their event lines, the bounded failure and
``no_retry``; ``elect``; the lease's JSON bytes; the ``FileKVStore`` round
trip, atomic writes and key guard, and a store written by either package
read by the other; lease expiry with exactly one winner;
``DurableHeartbeatMonitor`` partitions; ``ChaosPlan.resolve_injection``
and ``describe()``; the corruption primitives on the port's checkpoints."""

import dataclasses
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.distributed import chaos as JCH  # noqa: E402
from repro.distributed import coordination as JCO  # noqa: E402
from repro.distributed import fault as JF  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.distributed import chaos as TCH  # noqa: E402
from repro_torch.distributed import coordination as TCO  # noqa: E402
from repro_torch.distributed import fault as TF  # noqa: E402

PAIRS = ((JCO, JF), (TCO, TF))


# -- RetryPolicy ----------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"max_attempts": 5, "base_delay_s": 0.1, "multiplier": 2.0,
         "max_delay_s": 0.5},
    {"max_attempts": 1}, {"max_attempts": 7, "base_delay_s": 0.25,
                          "multiplier": 3.0, "max_delay_s": 4.0},
    {"max_attempts": 0}])
def test_retry_schedule_equals_reference(kw):
    t = TCO.RetryPolicy(**kw)
    assert t.schedule() == JCO.RetryPolicy(**kw).schedule()
    assert t.schedule() == t.schedule()  # jitter-free
    assert dataclasses.asdict(t) == dataclasses.asdict(JCO.RetryPolicy(**kw))


def _retry_trace(co, fails: int, kw: dict, exc=None):
    """Run a flaky op under ``co.RetryPolicy(**kw)``: the calls made, the
    sleeps taken, the event lines and the outcome."""
    calls, slept, events = [], [], []
    exc = exc or co.StoreTimeout

    def flaky():
        calls.append(1)
        if len(calls) <= fails:
            raise exc("transient")
        return "ok"

    try:
        out = co.RetryPolicy(**kw).call(flaky, op="flaky op",
                                        sleep=slept.append,
                                        on_event=events.append)
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        out = (type(e).__name__, str(e))
    return len(calls), slept, events, out


@pytest.mark.parametrize("fails,kw", [
    (2, {"max_attempts": 4, "base_delay_s": 0.01}),
    (0, {"max_attempts": 3}),
    (3, {"max_attempts": 3, "base_delay_s": 0.0}),
    (9, {"max_attempts": 5, "base_delay_s": 0.25, "max_delay_s": 0.5})])
def test_retry_call_events_equal_reference(fails, kw):
    t = _retry_trace(TCO, fails, kw)
    assert t == _retry_trace(JCO, fails, kw)
    if 0 < fails < kw["max_attempts"]:
        assert t[3] == "ok" and any("backing off" in e for e in t[2])
        assert any("succeeded on attempt" in e for e in t[2])
    if fails >= kw["max_attempts"]:
        assert t[3][0] == "RetryError" and "bounded attempts" in t[3][1]
        assert t[0] == kw["max_attempts"]


def test_retry_bounded_raises_retry_error():
    pol = TCO.RetryPolicy(max_attempts=3, base_delay_s=0.0)
    with pytest.raises(TCO.RetryError, match="3 bounded attempts") as ei:
        pol.call(lambda: (_ for _ in ()).throw(TCO.StoreTimeout("down")),
                 op="dead store", sleep=lambda _: None)
    assert ei.value.attempts == 3 and isinstance(ei.value.last,
                                                 TCO.StoreTimeout)


@pytest.mark.parametrize("exc", [FileNotFoundError, KeyError])
def test_retry_does_not_retry_missing_or_foreign(exc):
    """``no_retry`` (a missing file) and errors outside ``retry_on``
    surface at once, as in the reference."""
    t = _retry_trace(TCO, 5, {"max_attempts": 5}, exc=exc)
    assert t[0] == 1 and t[3][0] == exc.__name__
    assert t == _retry_trace(JCO, 5, {"max_attempts": 5}, exc=exc)


def _deadline_trace(co, fm):
    clock = fm.StepClock()
    pol = co.RetryPolicy(max_attempts=10, base_delay_s=1.0, multiplier=1.0,
                         timeout_s=2.5)
    calls = []

    def down():
        calls.append(clock())
        raise co.StoreTimeout("down")

    with pytest.raises(co.RetryError):
        pol.call(down, sleep=clock.advance, clock=clock)
    return calls


def test_retry_deadline_bounds_the_attempts():
    # the attempt at t = 3 is the first to fail past the 2.5 s deadline
    assert _deadline_trace(TCO, TF) == _deadline_trace(JCO, JF) == [
        0.0, 1.0, 2.0, 3.0]


# -- election and leases -----------------------------------------------------


@pytest.mark.parametrize("alive", [[3, 1, 5], range(8), {7}, (2, 2, 0)])
def test_elect_equals_reference(alive):
    assert TCO.elect(alive) == JCO.elect(alive) == min(alive)


def test_elect_empty_raises():
    with pytest.raises(ValueError):
        TCO.elect([])


@pytest.mark.parametrize("lease", [(0, 1, 0.0, 60.0), (3, 7, 12.5, 72.5),
                                   (1, 2, 1e9, 1e9 + 0.1)])
def test_lease_json_bytes_equal_reference(lease):
    t = TCO.Lease(*lease)
    j = JCO.Lease(*lease)
    assert t.to_json() == j.to_json()
    assert TCO.Lease.from_json(j.to_json()) == t
    assert JCO.Lease.from_json(t.to_json()) == j


def _lease_trace(co, fm):
    clk = fm.StepClock()
    store = co.CoordinationStore(co.MemKVStore(), lease_ttl_s=10.0,
                                 clock=clk)
    first = store.adopt(0, range(4))
    clk.advance(5.0)
    kept = store.adopt(2, range(4))
    clk.advance(6.0)
    refused = store.adopt(3, [2, 3])
    second = store.adopt(2, [2, 3])
    renewed = store.renew(second)
    return ([None if x is None else dataclasses.astuple(x)
             for x in (first, kept, refused, second, renewed)],
            store.events, store.kv.get("lease"))


def test_lease_expiry_failover_equals_reference():
    t = _lease_trace(TCO, TF)
    assert t == _lease_trace(JCO, JF)
    leases = t[0]
    assert leases[0][:2] == (0, 1) and leases[1] is None
    assert leases[2] is None and leases[3][:2] == (2, 2)
    assert any("adopted coordination" in e for e in t[1])


def test_lease_adoption_exactly_one_winner():
    for alive in ([0, 1, 2], [1, 3], [2], [0, 2, 5, 7]):
        for order in itertools.permutations(alive):
            store = TCO.CoordinationStore(TCO.MemKVStore(), lease_ttl_s=10.0,
                                          clock=TF.StepClock())
            wins = [h for h in order if store.adopt(h, alive) is not None]
            assert wins == [min(alive)], (alive, order, wins)


def test_lease_election_hypothesis():
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.given(alive=st.sets(st.integers(0, 15), min_size=1, max_size=16),
               seed=st.integers(0, 2**31 - 1))
    @hyp.settings(max_examples=100, deadline=None)
    def drill(alive, seed):
        order = sorted(alive, key=lambda h: np.random.default_rng(
            seed + h).integers(0, 1 << 30))
        store = TCO.CoordinationStore(TCO.MemKVStore(), lease_ttl_s=10.0,
                                      clock=TF.StepClock())
        assert [h for h in order if store.adopt(h, alive) is not None] == [
            TCO.elect(alive)] == [JCO.elect(alive)]

    drill()


# -- stores ----------------------------------------------------------------


def test_file_kv_store_roundtrip_atomic_and_guarded(tmp_path):
    kv = TCO.FileKVStore(str(tmp_path))
    kv.put("hosts/3", b'{"host": 3}')
    kv.put("lease", b'{"holder": 0}')
    assert kv.get("hosts/3") == b'{"host": 3}'
    assert kv.get("missing") is None
    assert kv.keys("hosts/") == ["hosts/3"]
    assert kv.keys() == ["hosts/3", "lease"]
    # a torn writer's tmp file is never a key
    open(os.path.join(str(tmp_path), "hosts", "4.tmp"), "wb").write(b"{")
    assert kv.keys() == ["hosts/3", "lease"]
    kv.delete("hosts/3")
    kv.delete("hosts/3")  # deleting a missing key is a no-op
    assert kv.get("hosts/3") is None
    for bad in ("../escape", "/abs", ".hidden", "", "a/../b"):
        with pytest.raises(ValueError, match="bad store key"):
            kv.put(bad, b"nope")


def test_mem_kv_store_equals_reference():
    stores = [co.MemKVStore() for co, _ in PAIRS]
    for kv in stores:
        kv.put("b/1", b"x")
        kv.put("a", bytearray(b"y"))
        kv.put("b/0", b"z")
        kv.delete("nope")
    assert [kv.keys() for kv in stores][0] == [kv.keys() for kv in stores][1]
    assert [kv.keys("b/") for kv in stores] == [["b/0", "b/1"]] * 2
    assert all(kv.get("a") == b"y" for kv in stores)


def _write_control_plane(co, fm, root):
    clk = fm.StepClock()
    c = co.CoordinationStore(root, clock=clk, lease_ttl_s=5.0)
    c.register_host(2)
    c.beat(0, step=2)
    c.beat(1, step=1)
    c.adopt(0, [0, 1])
    c.record_shard(4, host=0, step=7)
    c.record_shard(5, host=1, step=7)
    c.record_shard(6, host=1, step=8)
    return c


def _read_control_plane(co, fm, root):
    c = co.CoordinationStore(root, clock=fm.StepClock(), lease_ttl_s=5.0)
    lease = c.lease()
    return (c.host_records(), dataclasses.astuple(lease), c.load_ledger(7),
            c.load_ledger(8), c.load_ledger(None), c.load_ledger(9))


@pytest.mark.parametrize("writer,reader", [(0, 1), (1, 0), (1, 1), (0, 0)])
def test_store_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                         reader):
    root = str(tmp_path / "coord")
    _write_control_plane(*PAIRS[writer], root)
    got = _read_control_plane(*PAIRS[reader], root)
    assert got == _read_control_plane(*PAIRS[1 - reader], root)
    recs, lease, l7, l8, lall, l9 = got
    assert recs[0]["step"] == 2 and recs[1]["step"] == 1
    assert recs[2]["ever"] is False
    assert lease[:2] == (0, 1)
    assert l7 == {4: 0, 5: 1} and l8 == {6: 1} and l9 == {}
    assert lall == {4: 0, 5: 1, 6: 1}


def test_store_files_are_the_reference_bytes(tmp_path):
    roots = [str(tmp_path / name) for name in ("ref", "port")]
    for (co, fm), root in zip(PAIRS, roots):
        _write_control_plane(co, fm, root)
    kvs = [TCO.FileKVStore(r) for r in roots]
    assert kvs[0].keys() == kvs[1].keys()
    for k in kvs[0].keys():
        assert kvs[0].get(k) == kvs[1].get(k), k


def test_torn_records_read_as_missing(tmp_path):
    c = TCO.CoordinationStore(str(tmp_path), clock=TF.StepClock())
    c.beat(0, step=1)
    c.record_shard(1, host=0, step=0)
    c.kv.put("hosts/1", b"{torn")
    c.kv.put("ledger/shard_2", b"\xff\xfe")
    assert sorted(c.host_records()) == [0]
    assert c.load_ledger(0) == {1: 0}
    c.clear_ledger()
    assert c.load_ledger() == {}


def _fault_gate_trace(co, fm):
    clk = fm.StepClock()
    c = co.CoordinationStore(co.MemKVStore(), clock=clk,
                             retry=co.RetryPolicy(max_attempts=4,
                                                  base_delay_s=0.5))
    c.inject_store_faults(2, kinds=("beat",))
    c.beat(0, step=1)
    c.register_host(1)  # not a gated kind
    c.beat(1, step=2)
    return c.events, clk(), sorted(c.host_records())


def test_store_fault_gate_equals_reference():
    t = _fault_gate_trace(TCO, TF)
    assert t == _fault_gate_trace(JCO, JF)
    assert t[1] == 0.5 + 1.0  # the backoff advanced the synthetic clock
    assert sum("backing off" in e for e in t[0]) == 2


# -- the durable heartbeat monitor --------------------------------------------


def _monitor_trace(co, fm):
    clk = fm.StepClock()
    store = co.CoordinationStore(co.MemKVStore(), clock=clk)
    mon = co.DurableHeartbeatMonitor(store, 4, timeout_s=10.0, clock=clk)
    seen = [(mon.dead_hosts(), mon.alive_hosts())]
    for h in range(4):
        mon.beat(h, step=1)
    mon.partition(2)
    mon.partition(2)  # one event, not two
    clk.advance(11.0)
    for h in range(4):
        mon.beat(h, step=2 if h != 3 else 0)
    seen.append((mon.dead_hosts(), mon.alive_hosts(), mon.stragglers(lag=2),
                 mon.stragglers(lag=1)))
    mon.heal(2)
    mon.beat(2, step=3)
    seen.append((mon.dead_hosts(), mon.alive_hosts()))
    return seen, store.events


def test_durable_monitor_partition_equals_reference():
    t = _monitor_trace(TCO, TF)
    assert t == _monitor_trace(JCO, JF)
    assert t[0][1][0] == [2] and t[0][1][1] == [0, 1, 3]
    assert t[0][1][3] == [3] and t[0][2][0] == []
    assert sum("partition" in e for e in t[1]) == 1


# -- chaos plans -------------------------------------------------------------


def _plans(ch):
    return {
        "empty": ch.ChaosPlan(),
        "kill_coordinator": ch.ChaosPlan().kill_coordinator(after=1),
        "corrupt": ch.ChaosPlan().corrupt_checkpoint(3, 1).corrupt_checkpoint(
            3),
        "multifault": (ch.ChaosPlan().kill_coordinator(after=1)
                       .corrupt_checkpoint(0).straggler(3).delay_store(1)),
        "kill_hosts": ch.ChaosPlan().kill_host(2, 1, after=2,
                                               checkpoint_survives=False),
        "partition_resize": (ch.ChaosPlan().partition(3).partition(1)
                             .resize(6).delay_store(4, ("ckpt", "beat"))),
    }


def _injections(fm):
    return [None, fm.FaultInjection(dead_hosts=(5,), die_after_shards=3),
            fm.FaultInjection(straggler_hosts=(2,), resize_to=3,
                              checkpoint_survives=False)]


@pytest.mark.parametrize("name", sorted(_plans(TCH)))
@pytest.mark.parametrize("base", [0, 1, 2])
@pytest.mark.parametrize("coordinator", [0, 2])
def test_chaos_resolve_and_describe_equal_reference(name, base, coordinator):
    t = _plans(TCH)[name]
    j = _plans(JCH)[name]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.describe() == j.describe()
    got = t.resolve_injection(_injections(TF)[base], coordinator)
    want = j.resolve_injection(_injections(JF)[base], coordinator)
    assert isinstance(got, TF.FaultInjection)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _tree():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "n": torch.tensor([7], dtype=torch.int32)}


def test_corrupt_shard_partial_is_caught_and_quarantined(tmp_path):
    d = str(tmp_path)
    sd = ckpt.shard_partial_dir(d, 3)
    ckpt.save(sd, 0, _tree())
    assert TCH.corrupt_shard_partial(d, 4, 0) is None  # no such shard
    path = TCH.corrupt_shard_partial(d, 3, 0)
    assert path == os.path.join(sd, "step_0", "arrays.npz")
    with pytest.raises(ckpt.CheckpointCorruptError, match="step 0"):
        ckpt.verify_step(sd, 0)
    assert ckpt.quarantine_step(sd, 0).endswith("step_0.corrupt")


def test_truncate_payload_and_service_checkpoint(tmp_path):
    d = str(tmp_path)
    sd = ckpt.service_state_dir(d)
    ckpt.save(sd, 2, _tree())
    assert TCH.corrupt_service_checkpoint(d, 5) is None
    path = TCH.corrupt_service_checkpoint(d, 2)
    assert os.path.getsize(path) == 16
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(sd, _tree(), step=2, device="cpu")
    assert os.path.isdir(os.path.join(sd, "step_2.corrupt"))


def test_corrupt_payload_flips_the_head_deterministically(tmp_path):
    p = tmp_path / "f.bin"
    p.write_bytes(bytes(range(100)))
    TCH.corrupt_payload(str(p), nbytes=8)
    data = p.read_bytes()
    assert data[:8] == bytes(b ^ 0xFF for b in range(8))
    assert data[8:] == bytes(range(8, 100))
    json.dumps(list(data[:2]))  # plain bytes, nothing random
