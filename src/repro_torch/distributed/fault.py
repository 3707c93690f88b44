"""Fault tolerance: heartbeats, stragglers, the stateless shard
assignment, and the failure script and recovery ledger of
``engine.run_resilient``.

Counterpart of ``repro/distributed/fault.py``, function for function: for
the same inputs every function, and every line of
:meth:`RecoveryLog.summary`, equals the reference's.

* **State recovery**: a shard's partial (its holder tables, or its
  encoded all-to-all sends) is a pure function of its items, and the
  derived combiner merges partials as a monoid, so a lost shard is
  recomputed, or restored from its checkpointed partial
  (``checkpoint/ckpt.py``), with the bits of the fault-free run.
* **Failure detection** is heartbeat-based: every host beats
  ``(host_id, step, time)``; a host silent for ``timeout_s`` is dead.  The
  resilient driver runs the monitor on a synthetic clock
  (:class:`StepClock`); ``coordination.DurableHeartbeatMonitor`` keeps the
  same records in a durable store.
* **Straggler mitigation** is the stateless assignment
  ``shard = f(step, host_index, num_hosts)``: any host computes any other
  host's shards, so a backup rank re-executes a lagging host's shards
  (speculative re-execution, MapReduce's own trick).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable


@dataclasses.dataclass
class HostState:
    host_id: int
    last_step: int = -1
    last_beat: float = 0.0
    ever_beat: bool = False


class HeartbeatMonitor:
    """Declares hosts dead after ``timeout_s`` without a heartbeat.

    ``last_beat`` is initialized from the injected ``clock`` at
    construction — NOT 0.0, which against ``time.monotonic()`` (seconds
    since an arbitrary epoch, typically boot) declared every host dead
    before its first beat.  Hosts that have never beaten get an extra
    ``grace_s`` startup allowance (default: one more timeout) on top of
    the timeout before they are declared dead, so a slow-to-join host is
    not buried while it is still binding its devices.
    """

    def __init__(self, num_hosts: int, *, timeout_s: float = 60.0,
                 grace_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.grace_s = timeout_s if grace_s is None else grace_s
        self.clock = clock
        now = self.clock()
        self.hosts = {i: HostState(i, last_beat=now) for i in range(num_hosts)}

    def beat(self, host_id: int, step: int):
        h = self.hosts[host_id]
        h.last_step = step
        h.last_beat = self.clock()
        h.ever_beat = True

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        out = []
        for i, h in self.hosts.items():
            limit = self.timeout_s + (0.0 if h.ever_beat else self.grace_s)
            if now - h.last_beat > limit:
                out.append(i)
        return out

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [i for i in self.hosts if i not in dead]

    def stragglers(self, *, lag: int = 2) -> list[int]:
        """Hosts alive but >= ``lag`` steps behind the front-runner."""
        alive = self.alive_hosts()
        if not alive:
            return []
        front = max(self.hosts[i].last_step for i in alive)
        return [i for i in alive if front - self.hosts[i].last_step >= lag]


def shard_for(step: int, host_index: int, num_hosts: int,
              num_shards: int) -> list[int]:
    """Deterministic, stateless shard assignment.

    Rotates assignments across steps so a persistently slow host does not
    pin the same shard (straggler decorrelation), and any host can compute
    any other host's assignment for speculative backup execution.

    The assignment is round-robin over rotated host ranks, so it stays a
    partition (every shard owned exactly once) for ANY ``num_shards`` /
    ``num_hosts`` pair — an elastic remesh from 8 to 7 hosts must not crash
    the recovery path it exists to serve.  Per-host load is balanced to
    within one shard (``floor`` vs ``ceil`` of ``num_shards/num_hosts``).
    """
    if num_hosts <= 0:
        raise ValueError(f"num_hosts must be positive, got {num_hosts}")
    if not 0 <= host_index < num_hosts:
        raise ValueError(
            f"host_index {host_index} out of range [0, {num_hosts})")
    if num_shards < 0:
        raise ValueError(f"num_shards must be >= 0, got {num_shards}")
    base = (host_index + step) % num_hosts
    return [s for s in range(num_shards) if s % num_hosts == base]


def backup_assignment(step: int, dead_host: int, num_hosts: int,
                      num_shards: int, *, alive: list[int] | None = None
                      ) -> tuple[int, list[int]]:
    """Which surviving host re-executes a dead host's shards: the next
    alive rank (deterministic, no coordination — every survivor computes
    the same answer locally).  ``alive`` restricts the candidates when the
    caller knows which ranks still beat; without it, the next rank."""
    if num_hosts <= 1:
        raise ValueError("no surviving host available for backup execution")
    if not 0 <= dead_host < num_hosts:
        raise ValueError(
            f"dead_host {dead_host} out of range [0, {num_hosts})")
    candidates = [(dead_host + k) % num_hosts for k in range(1, num_hosts)]
    if alive is not None:
        alive_set = set(alive)
        filtered = [c for c in candidates if c in alive_set]
        if filtered:
            candidates = filtered
    return candidates[0], shard_for(step, dead_host, num_hosts, num_shards)


@dataclasses.dataclass
class RestartPolicy:
    """Restart-from-latest: ``on_failure()`` counts a restart and says
    whether another is allowed."""

    max_restarts: int = 100
    restarts: int = 0

    def on_failure(self) -> bool:
        self.restarts += 1
        return self.restarts <= self.max_restarts


# ---------------------------------------------------------------------------
# Deterministic fault injection + recovery bookkeeping for run_resilient
# ---------------------------------------------------------------------------


class StepClock:
    """Synthetic monotonic clock for deterministic failure drills."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float = 1.0) -> float:
        self.t += dt
        return self.t


@dataclasses.dataclass(frozen=True)
class FaultInjection:
    """Deterministic failure script consumed by ``engine.run_resilient``.

    The driver simulates the cluster events a production deployment
    actually has, in a single process, so recovery is testable bit-for-bit:

    * ``dead_hosts`` crash after completing ``die_after_shards`` of their
      assigned shards — their in-memory partials are lost; checkpoints
      they wrote before dying survive unless ``checkpoint_survives`` is
      False (e.g. host-local disk died with the host).
    * ``straggler_hosts`` stay alive (keep heartbeating) but make no
      progress this round — their shards are speculatively re-executed on
      the deterministic backup rank.
    * ``resize_to`` shrinks or grows the host count after the map phase
      (elastic event): the driver remeshes, recomputes the stateless
      assignment, and re-runs only the shards whose partials were lost
      with the removed hosts.
    """

    dead_hosts: tuple[int, ...] = ()
    die_after_shards: int = 0
    checkpoint_survives: bool = True
    straggler_hosts: tuple[int, ...] = ()
    resize_to: int | None = None


@dataclasses.dataclass
class RecoveryLog:
    """What ``run_resilient`` did to produce its answer — who computed,
    restored, re-executed or speculated which shard, and what the shuffle
    overflow counters saw.  Summarized onto ``plan.recovery``."""

    num_hosts: int
    num_shards: int
    step: int
    #: (shard, host) pairs completed in the primary map phase.
    computed: list = dataclasses.field(default_factory=list)
    #: shards restored from checkpointed partial aggregates.
    restored: list = dataclasses.field(default_factory=list)
    #: (shard, backup_host) recomputed after a detected host death.
    recomputed: list = dataclasses.field(default_factory=list)
    #: (shard, backup_host) speculatively re-executed for stragglers.
    speculated: list = dataclasses.field(default_factory=list)
    dead_hosts: list = dataclasses.field(default_factory=list)
    straggler_hosts: list = dataclasses.field(default_factory=list)
    #: (old_hosts, new_hosts) when an elastic resize happened, else None.
    resized: tuple | None = None
    #: shards whose owner changed across the resize.
    moved: list = dataclasses.field(default_factory=list)
    #: per-source-shard count of shuffle pairs past the all-to-all capacity
    #: (reduce/sort flows only; () for the table-merge flows).
    shuffle_overflow: tuple = ()
    #: the mesh run_resilient ended on (None when driven mesh-less).
    final_mesh: Any = None
    #: lease holder elected at the start of a coordinated run, else None.
    coordinator: int | None = None
    #: (old_holder, new_holder, epoch) when the lease failed over.
    failover: tuple | None = None
    #: shards whose durable partials failed checksum verification and
    #: were quarantined to ``*.corrupt`` then recomputed.
    corrupt: list = dataclasses.field(default_factory=list)
    #: hosts whose beats/writes a chaos partition dropped at the wire.
    partitioned: list = dataclasses.field(default_factory=list)
    #: raw control-plane event lines (retries, backoffs, lease adoptions,
    #: quarantines) from the CoordinationStore — no silent retries.
    store_events: tuple = ()
    #: skew shuffle-plan provenance (boundary spans + split-key shard
    #: ownership lines) when the run routed by a ``skew.ShufflePlan``.
    skew_plan: tuple = ()
    #: content fingerprint of the boundary layout stamped into the
    #: checkpointable wire format (0 = legacy fixed-width ranges).
    boundary_epoch: int = 0
    #: shards whose durable partials carried a STALE boundary epoch
    #: (bucketized under different key ranges) — rejected at restore and
    #: recomputed deterministically.
    epoch_rejects: list = dataclasses.field(default_factory=list)

    def summary(self) -> tuple[str, ...]:
        """Human-readable recovery events for ``plan.recovery``."""
        lines = [
            f"resilient run: {self.num_shards} shards over "
            f"{self.num_hosts} hosts at step {self.step}; "
            f"{len(self.computed)} computed in the primary phase"]
        if self.coordinator is not None and self.failover is None:
            lines.append(
                f"coordinator: host {self.coordinator} held the lease "
                f"for the whole run")
        if self.failover is not None:
            old, new, epoch = self.failover
            lines.append(
                f"failover: coordinator {old} lost the lease; host {new} "
                f"adopted the durable ledger at epoch {epoch} and "
                f"resumed phase B from checkpointed partials")
        if self.partitioned:
            lines.append(
                f"partitioned hosts {sorted(self.partitioned)}: beats and "
                f"writes dropped at the transport; shards recovered on "
                f"live ranks")
        if self.corrupt:
            lines.append(
                f"corrupt checkpoints: shards {sorted(self.corrupt)} "
                f"failed checksum verification, quarantined to *.corrupt "
                f"and recomputed deterministically")
        if self.epoch_rejects:
            lines.append(
                f"stale boundary epochs: shards "
                f"{sorted(self.epoch_rejects)} checkpointed under "
                f"different skew boundaries (epoch != "
                f"{self.boundary_epoch}); rejected and recomputed")
        for line in self.skew_plan:
            lines.append(f"skew: {line}")
        if self.dead_hosts:
            lines.append(
                f"detected dead hosts {sorted(self.dead_hosts)}; "
                f"restored {sorted(self.restored)} from checkpointed "
                f"partials, recomputed "
                f"{sorted(s for s, _ in self.recomputed)} on backup ranks "
                f"{sorted(set(h for _, h in self.recomputed))}")
        if self.straggler_hosts:
            lines.append(
                f"stragglers {sorted(self.straggler_hosts)}: speculatively "
                f"re-executed {sorted(s for s, _ in self.speculated)} on "
                f"backup ranks "
                f"{sorted(set(h for _, h in self.speculated))}")
        if self.resized is not None:
            lines.append(
                f"elastic resize {self.resized[0]} -> {self.resized[1]} "
                f"hosts: {len(self.moved)} shard assignments moved, "
                f"re-ran only the shards whose partials were lost")
        total_ovf = int(sum(self.shuffle_overflow)) if len(
            self.shuffle_overflow) else 0
        if total_ovf:
            lines.append(
                f"shuffle overflow: {total_ovf} pairs past capacity "
                f"(per-shard {tuple(int(x) for x in self.shuffle_overflow)})")
        lines.extend(self.store_events)
        return tuple(lines)
