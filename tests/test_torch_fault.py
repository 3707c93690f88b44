"""The port's fault module (``repro_torch.distributed.fault``) against the
reference's: the stateless shard assignment, the backup rank, the
heartbeat monitor (deaths, no false deaths at construction, startup
grace, stragglers), ``RestartPolicy``, ``StepClock`` and every line of
``RecoveryLog.summary``, for the same inputs, with hypothesis over H, S
and step as ``tests/integration/test_fault.py`` does."""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.distributed import fault as JF  # noqa: E402
from repro_torch.distributed import fault as TF  # noqa: E402


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t


def both(fn):
    """``fn(module)`` on the reference and on the port: the two results,
    or the two exceptions' types and messages."""
    out = []
    for mod in (JF, TF):
        try:
            out.append(("ok", fn(mod)))
        except Exception as e:  # noqa: BLE001 - compared, then re-checked
            out.append(("raise", type(e).__name__, str(e)))
    return out


@pytest.mark.parametrize("H,S", [(4, 16), (7, 8), (3, 8), (5, 16), (8, 3),
                                 (4, 1), (1, 5), (4, 0)])
@pytest.mark.parametrize("step", [0, 1, 5])
def test_shard_for_equals_reference(H, S, step):
    j, t = both(lambda m: [m.shard_for(step, h, H, S) for h in range(H)])
    assert j == t
    flat = sorted(s for owned in t[1] for s in owned)
    assert flat == list(range(S))


@pytest.mark.parametrize("args", [(0, 0, 0, 8), (0, 4, 4, 8), (0, -1, 4, 8),
                                  (0, 0, 4, -1)])
def test_shard_for_invalid_inputs_raise_as_reference(args):
    j, t = both(lambda m: m.shard_for(*args))
    assert j == t and t[0] == "raise" and t[1] == "ValueError"


@pytest.mark.parametrize("step,dead,H,S,alive", [
    (3, 1, 4, 16, None), (3, 1, 4, 16, [0, 3]), (0, 6, 7, 8, None),
    (2, 0, 4, 8, [2]), (0, 3, 4, 8, [5]), (0, 0, 1, 4, None),
    (0, 5, 4, 8, None)])
def test_backup_assignment_equals_reference(step, dead, H, S, alive):
    j, t = both(lambda m: m.backup_assignment(step, dead, H, S, alive=alive))
    assert j == t


def test_assignment_properties_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=200, deadline=None)
    @given(step=st.integers(0, 50), num_hosts=st.integers(1, 12),
           num_shards=st.integers(0, 64))
    def check(step, num_hosts, num_shards):
        per_host = [TF.shard_for(step, h, num_hosts, num_shards)
                    for h in range(num_hosts)]
        assert per_host == [JF.shard_for(step, h, num_hosts, num_shards)
                            for h in range(num_hosts)]
        loads = [len(o) for o in per_host]
        assert max(loads) - min(loads) <= 1
        if num_hosts > 1:
            dead = step % num_hosts
            assert (TF.backup_assignment(step, dead, num_hosts, num_shards)
                    == JF.backup_assignment(step, dead, num_hosts,
                                            num_shards))

    check()


def _drive_monitor(mod, script):
    """Run a heartbeat script on ``mod``'s monitor; the observations."""
    clk = FakeClock(script["t0"])
    mon = mod.HeartbeatMonitor(script["hosts"], timeout_s=script["timeout"],
                               grace_s=script.get("grace"), clock=clk)
    seen = []
    for t, beats in script["events"]:
        clk.t = t
        for h, step in beats:
            mon.beat(h, step)
        seen.append((mon.dead_hosts(), sorted(mon.alive_hosts()),
                     mon.stragglers(lag=2), mon.stragglers(lag=4)))
    return seen


MONITOR_SCRIPTS = {
    "death": {"t0": 0.0, "hosts": 4, "timeout": 10,
              "events": [(0, [(h, 0) for h in range(4)]),
                         (5, [(0, 1), (1, 1), (2, 1)]), (12, [])]},
    "no_false_deaths_at_construction": {
        "t0": 1000.0, "hosts": 4, "timeout": 10,
        "events": [(1000.0, []), (1015.0, [(0, 1)]), (1026.0, []),
                   (1040.0, [])]},
    "grace": {"t0": 5.0, "hosts": 3, "timeout": 10, "grace": 2.0,
              "events": [(14.0, [(1, 3)]), (17.5, []), (30.0, [(1, 4)])]},
    "stragglers": {"t0": 0.0, "hosts": 3, "timeout": 100,
                   "events": [(1, [(0, 10), (1, 10), (2, 7)]),
                              (2, [(2, 9)])]},
}


@pytest.mark.parametrize("name", sorted(MONITOR_SCRIPTS))
def test_heartbeat_monitor_equals_reference(name):
    script = MONITOR_SCRIPTS[name]
    assert (_drive_monitor(TF, script) == _drive_monitor(JF, script))


def test_heartbeat_monitor_cases():
    death = _drive_monitor(TF, MONITOR_SCRIPTS["death"])
    assert death[-1][0] == [3]
    boot = _drive_monitor(TF, MONITOR_SCRIPTS["no_false_deaths_at_"
                                              "construction"])
    assert boot[0][0] == [] and boot[1][0] == []
    assert 0 in boot[2][0] and set(boot[3][0]) == {0, 1, 2, 3}
    strag = _drive_monitor(TF, MONITOR_SCRIPTS["stragglers"])
    assert strag[0][2] == [2] and strag[0][3] == []
    # against the real monotonic clock no host is dead at construction
    assert TF.HeartbeatMonitor(4, timeout_s=60).dead_hosts() == []


@pytest.mark.parametrize("max_restarts,failures", [(2, 3), (0, 1), (5, 5)])
def test_restart_policy_equals_reference(max_restarts, failures):
    def run(mod):
        p = mod.RestartPolicy(max_restarts=max_restarts)
        return [p.on_failure() for _ in range(failures)], p.restarts

    j, t = both(run)
    assert j == t


def test_step_clock_equals_reference():
    def run(mod):
        c = mod.StepClock(2.5)
        return [c(), c.advance(), c.advance(3.25), c()]

    j, t = both(run)
    assert j == t == ("ok", [2.5, 3.5, 6.75, 6.75])


def _log(mod, **fields):
    log = mod.RecoveryLog(num_hosts=fields.pop("num_hosts", 4),
                          num_shards=fields.pop("num_shards", 8),
                          step=fields.pop("step", 0))
    for k, v in fields.items():
        setattr(log, k, v)
    return log


LOGS = {
    "clean": {},
    "coordinator": {"coordinator": 0},
    "failover": {"coordinator": 0, "failover": (0, 1, 2),
                 "dead_hosts": [0], "restored": [0],
                 "recomputed": [(4, 1)]},
    "partition_corrupt": {"partitioned": [3], "corrupt": [2, 0],
                          "dead_hosts": [3], "recomputed": [(3, 0), (7, 0)]},
    "epoch_rejects": {"epoch_rejects": [5, 1], "boundary_epoch": 1234,
                      "skew_plan": ("boundaries: 4 ranges", "hot key 7")},
    "stragglers": {"straggler_hosts": [1], "speculated": [(1, 2)],
                   "num_shards": 4},
    "resize": {"resized": (4, 3), "moved": [0, 1, 2, 3],
               "recomputed": [(3, 0)], "num_shards": 4},
    "overflow": {"shuffle_overflow": (0, 3, 0, 12), "step": 7},
    "events": {"store_events": ("lease: host 0 elected coordinator "
                                "(epoch 1, ttl 60s)", "retry: x")},
}


@pytest.mark.parametrize("name", sorted(LOGS))
def test_recovery_log_summary_equals_reference(name):
    t = _log(TF, **dict(LOGS[name]))
    j = _log(JF, **dict(LOGS[name]))
    assert t.summary() == j.summary()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("kw", [
    {}, {"dead_hosts": (2,)}, {"dead_hosts": (1, 3), "die_after_shards": 1,
                                "checkpoint_survives": False},
    {"straggler_hosts": (0,), "resize_to": 3}])
def test_fault_injection_fields_equal_reference(kw):
    assert (dataclasses.asdict(TF.FaultInjection(**kw))
            == dataclasses.asdict(JF.FaultInjection(**kw)))
    with pytest.raises(dataclasses.FrozenInstanceError):
        TF.FaultInjection(**kw).resize_to = 2
