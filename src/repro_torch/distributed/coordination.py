"""Durable multi-host coordination: KV store, heartbeats, leases, retries.

Counterpart of ``repro/distributed/coordination.py``.  The keys and the
JSON records are the reference's, so a store written by either package
reads in the other.

``engine.run_resilient``'s plain control plane is an in-process
``fault.HeartbeatMonitor``: the coordinator's memory is the cluster
state, and a coordinator crash loses the recovery ledger even though
every shard partial is checkpointed.  This module moves the control plane
onto a durable store:

* ``KVStore``, the pluggable interface (``put/get/delete/keys``).
  ``FileKVStore`` keeps one file a key (every write is ``tmp +
  os.replace``, atomic on POSIX, so a reader never sees a torn value);
  ``MemKVStore`` backs tests and in-process drills.
* ``CoordinationStore``, the control plane's schema over a KVStore:
  ``hosts/<h>`` heartbeat records, ``lease`` for the coordinator, and
  ``ledger/shard_<s>`` completion records (the durable ``RecoveryLog``).
  Every store operation goes through ``retried()``, a bounded
  deterministic backoff, and every retry is recorded on ``events``.
* **Lease-based election.**  ``elect(alive)`` is pure: the lowest live
  rank wins.  ``CoordinationStore.adopt`` grants the lease only to that
  host, and only when the current lease has expired or its holder is
  dead, so for any alive-set exactly one host adopts.  On failover the
  new coordinator reads the ledger from the store and resumes phase B
  from the durable partials, with the same bits (partials are pure
  functions of their shards; merges are monoids).
* ``RetryPolicy``: capped exponential backoff on a jitter-free schedule
  (drills must repeat bit for bit) and a per-operation timeout.
* ``DurableHeartbeatMonitor``: the ``fault.HeartbeatMonitor`` interface
  over the store, plus ``partition()``: a partitioned host keeps
  computing, but its beats and writes never reach the store, so the
  cluster declares it dead and recomputes its shards.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Iterable


class StoreTimeout(OSError):
    """A store operation timed out (injected by chaos drills; in production
    the filesystem/KV client raises its own OSError subclass)."""


class RetryError(RuntimeError):
    """A store operation failed after exhausting its bounded retry budget."""

    def __init__(self, op: str, attempts: int, last: BaseException):
        super().__init__(
            f"{op}: failed after {attempts} bounded attempts "
            f"({type(last).__name__}: {last})")
        self.op = op
        self.attempts = attempts
        self.last = last


# ---------------------------------------------------------------------------
# KV stores
# ---------------------------------------------------------------------------


class KVStore:
    """Pluggable durable key-value interface.  Keys are ``/``-separated
    paths (``hosts/3``, ``ledger/shard_7``); values are bytes.  ``put``
    must be atomic: a concurrent reader sees the old value or the new one,
    never a torn write."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes | None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def keys(self, prefix: str = "") -> list[str]:
        raise NotImplementedError


class MemKVStore(KVStore):
    """In-memory store for unit tests and mesh-less property drills."""

    def __init__(self):
        self._d: dict[str, bytes] = {}

    def put(self, key: str, value: bytes) -> None:
        self._d[key] = bytes(value)

    def get(self, key: str) -> bytes | None:
        return self._d.get(key)

    def delete(self, key: str) -> None:
        self._d.pop(key, None)

    def keys(self, prefix: str = "") -> list[str]:
        return sorted(k for k in self._d if k.startswith(prefix))


class FileKVStore(KVStore):
    """Shared-filesystem store: one file per key under ``root``.

    Atomicity is ``tmp + os.replace`` — the same discipline as
    checkpoint/ckpt.py — so a crashed writer never leaves a torn value
    for the next coordinator to trip over.
    """

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if not key or key.startswith(("/", ".")) or ".." in key:
            raise ValueError(f"bad store key: {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def put(self, key: str, value: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(value)
        os.replace(tmp, p)

    def get(self, key: str) -> bytes | None:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def keys(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel.replace(os.sep, "/") + "/"
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                k = rel + fn
                if k.startswith(prefix):
                    out.append(k)
        return sorted(out)


# ---------------------------------------------------------------------------
# Retry policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded, deterministic retry for store/shard operations.

    The backoff schedule is capped exponential and JITTER-FREE: drills must
    be reproducible bit-for-bit, so two runs of the same chaos script take
    the same schedule (``schedule()`` is a pure function of the policy).
    ``timeout_s`` bounds the total wall-clock per operation; retries never
    loop unboundedly — after ``max_attempts`` (or the deadline) the last
    error is re-raised wrapped in ``RetryError``.
    """

    max_attempts: int = 5
    base_delay_s: float = 0.05
    multiplier: float = 2.0
    max_delay_s: float = 2.0
    timeout_s: float = 30.0
    #: exception types that are retried; everything else propagates
    #: immediately (a corrupt checkpoint is not transient).
    retry_on: tuple = (OSError, TimeoutError)
    #: never retried even if they match ``retry_on`` (a missing checkpoint
    #: will stay missing no matter how patiently we re-read it).
    no_retry: tuple = (FileNotFoundError,)

    def schedule(self) -> tuple[float, ...]:
        """Deterministic backoff delays between attempts (len = retries)."""
        out = []
        d = self.base_delay_s
        for _ in range(max(0, self.max_attempts - 1)):
            out.append(min(d, self.max_delay_s))
            d *= self.multiplier
        return tuple(out)

    def call(self, fn: Callable[[], Any], *, op: str = "store op",
             sleep: Callable[[float], Any] | None = None,
             clock: Callable[[], float] | None = None,
             on_event: Callable[[str], Any] | None = None) -> Any:
        """Run ``fn`` under this policy.  Every retry emits an event line
        (attempt number, error, backoff taken) via ``on_event`` — no
        silent retries — and eventual success after retries is recorded
        too, so ``plan.recovery`` shows the full story."""
        sleep = time.sleep if sleep is None else sleep
        clock = time.monotonic if clock is None else clock
        emit = on_event if on_event is not None else (lambda s: None)
        delays = self.schedule()
        deadline = clock() + self.timeout_s
        last: BaseException | None = None
        for attempt in range(1, self.max_attempts + 1):
            try:
                result = fn()
            except self.retry_on as e:
                if isinstance(e, self.no_retry):
                    raise
                last = e
                out_of_budget = (attempt >= self.max_attempts
                                 or clock() >= deadline)
                if out_of_budget:
                    emit(f"retry: {op} FAILED after {attempt} bounded "
                         f"attempts ({type(e).__name__}: {e})")
                    raise RetryError(op, attempt, e) from e
                delay = delays[attempt - 1]
                emit(f"retry: {op} attempt {attempt}/{self.max_attempts} "
                     f"failed ({type(e).__name__}: {e}); backing off "
                     f"{delay:g}s")
                sleep(delay)
            else:
                if attempt > 1:
                    emit(f"retry: {op} succeeded on attempt "
                         f"{attempt}/{self.max_attempts}")
                return result
        raise RetryError(op, self.max_attempts, last)  # pragma: no cover


# ---------------------------------------------------------------------------
# Lease-based coordinator election
# ---------------------------------------------------------------------------


def elect(alive: Iterable[int]) -> int:
    """Deterministic coordinator election: the lowest-ranked live host.

    Pure and total — every survivor computes the same winner locally from
    the same alive-set, so election needs no consensus round-trip.  Raises
    ``ValueError`` on an empty alive-set (nobody left to coordinate).
    """
    alive = sorted(set(int(a) for a in alive))
    if not alive:
        raise ValueError("cannot elect a coordinator from an empty alive-set")
    return alive[0]


@dataclasses.dataclass(frozen=True)
class Lease:
    """Coordinator lease record stored under the ``lease`` key."""

    holder: int
    epoch: int
    granted_at: float
    expires_at: float

    def to_json(self) -> bytes:
        return json.dumps(dataclasses.asdict(self)).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Lease":
        d = json.loads(raw.decode())
        return cls(holder=int(d["holder"]), epoch=int(d["epoch"]),
                   granted_at=float(d["granted_at"]),
                   expires_at=float(d["expires_at"]))


# ---------------------------------------------------------------------------
# Coordination store
# ---------------------------------------------------------------------------


class CoordinationStore:
    """Control-plane schema over a ``KVStore``.

    Store layout (all values JSON):

    ======================  =================================================
    ``hosts/<h>``           heartbeat record {host, step, time, ever}
    ``lease``               coordinator lease {holder, epoch, granted_at,
                            expires_at}
    ``ledger/shard_<s>``    durable RecoveryLog entry {shard, host, step} —
                            written by the host as it completes the shard,
                            read by a failover coordinator during adoption
    ======================  =================================================

    All writes funnel through ``retried()`` (bounded ``RetryPolicy``
    backoff, per-op timeout) and optionally through the chaos fault gate
    (``inject_store_faults``), which raises ``StoreTimeout`` for the first
    N matching operations — deterministic "delayed store" drills.
    ``events`` accumulates every retry/lease/partition event for
    ``plan.recovery``.
    """

    def __init__(self, store: KVStore | str, *,
                 retry: RetryPolicy | None = None,
                 lease_ttl_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], Any] | None = None):
        if isinstance(store, str):
            store = FileKVStore(store)
        self.kv = store
        self.retry = retry if retry is not None else RetryPolicy()
        self.lease_ttl_s = lease_ttl_s
        self.clock = clock
        # default sleep: advance a synthetic clock if we were given one,
        # else real time.sleep — keeps drills instant AND deterministic.
        if sleep is None:
            sleep = getattr(clock, "advance", None) or time.sleep
        self.sleep = sleep
        self.events: list[str] = []
        self._fail_ops = 0
        self._fail_kinds: tuple[str, ...] = ()

    # -- chaos fault gate ---------------------------------------------------

    def inject_store_faults(self, ops: int,
                            kinds: tuple[str, ...] = ("put",)) -> None:
        """Arm the deterministic delayed-store drill: the next ``ops``
        operations whose kind is in ``kinds`` raise ``StoreTimeout``
        before touching the store, then behave normally — exercising the
        backoff → success path."""
        self._fail_ops = int(ops)
        self._fail_kinds = tuple(kinds)

    def _maybe_fail(self, kind: str, op: str) -> None:
        if self._fail_ops > 0 and kind in self._fail_kinds:
            self._fail_ops -= 1
            raise StoreTimeout(f"injected store timeout ({op})")

    def retried(self, op: str, fn: Callable[[], Any], *,
                kind: str = "put") -> Any:
        """Run ``fn`` under the store's retry policy + chaos fault gate,
        recording every retry onto ``events``."""

        def gated():
            self._maybe_fail(kind, op)
            return fn()

        return self.retry.call(gated, op=op, sleep=self.sleep,
                               clock=self.clock,
                               on_event=self.events.append)

    # -- heartbeats ---------------------------------------------------------

    def register_host(self, host: int) -> None:
        rec = {"host": int(host), "step": -1, "time": self.clock(),
               "ever": False}
        self.retried(f"register host {host}",
                     lambda: self.kv.put(f"hosts/{host}",
                                         json.dumps(rec).encode()),
                     kind="register")

    def beat(self, host: int, step: int) -> None:
        rec = {"host": int(host), "step": int(step), "time": self.clock(),
               "ever": True}
        self.retried(f"heartbeat host {host}",
                     lambda: self.kv.put(f"hosts/{host}",
                                         json.dumps(rec).encode()),
                     kind="beat")

    def host_records(self) -> dict[int, dict]:
        out = {}
        for k in self.kv.keys("hosts/"):
            raw = self.kv.get(k)
            if raw is None:
                continue
            try:
                rec = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue  # torn record: treat as missing, host re-beats
            out[int(rec["host"])] = rec
        return out

    # -- lease --------------------------------------------------------------

    def lease(self) -> Lease | None:
        raw = self.kv.get("lease")
        return None if raw is None else Lease.from_json(raw)

    def adopt(self, host: int, alive: Iterable[int], *,
              ttl_s: float | None = None) -> Lease | None:
        """Try to take the coordinator lease as ``host``.

        Returns the (possibly pre-existing) lease if ``host`` ends up the
        coordinator, else None.  Exactly one host in ``alive`` can ever
        win: a live unexpired holder keeps the lease, otherwise only
        ``elect(alive)`` may adopt, bumping the epoch.
        """
        alive = set(int(a) for a in alive)
        now = self.clock()
        cur = self.lease()
        if cur is not None and cur.expires_at > now and cur.holder in alive:
            return cur if cur.holder == host else None
        winner = elect(alive)
        if host != winner:
            return None
        ttl = self.lease_ttl_s if ttl_s is None else ttl_s
        new = Lease(holder=host, epoch=(cur.epoch + 1 if cur else 1),
                    granted_at=now, expires_at=now + ttl)
        self.retried(f"lease adoption by host {host}",
                     lambda: self.kv.put("lease", new.to_json()),
                     kind="lease")
        if cur is None:
            self.events.append(
                f"lease: host {host} elected coordinator "
                f"(epoch {new.epoch}, ttl {ttl:g}s)")
        else:
            why = ("expired" if cur.expires_at <= now else
                   f"holder {cur.holder} dead")
            self.events.append(
                f"lease: host {host} adopted coordination from host "
                f"{cur.holder} ({why}) at epoch {new.epoch}")
        return new

    def renew(self, lease: Lease, *, ttl_s: float | None = None) -> Lease:
        now = self.clock()
        ttl = self.lease_ttl_s if ttl_s is None else ttl_s
        new = dataclasses.replace(lease, granted_at=now, expires_at=now + ttl)
        self.retried(f"lease renewal by host {lease.holder}",
                     lambda: self.kv.put("lease", new.to_json()),
                     kind="lease")
        return new

    # -- durable recovery ledger -------------------------------------------

    def record_shard(self, shard: int, host: int, step: int) -> None:
        """Durably record that ``host`` completed ``shard`` — written by
        the worker itself (not the coordinator), so the ledger survives a
        coordinator death and the failover host adopts it from the store."""
        rec = {"shard": int(shard), "host": int(host), "step": int(step)}
        self.retried(f"ledger record shard {shard}",
                     lambda: self.kv.put(f"ledger/shard_{shard}",
                                         json.dumps(rec).encode()),
                     kind="ledger")

    def load_ledger(self, step: int | None = None) -> dict[int, int]:
        """shard -> host completion records (the adopted RecoveryLog)."""
        out = {}
        for k in self.kv.keys("ledger/"):
            raw = self.kv.get(k)
            if raw is None:
                continue
            try:
                rec = json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            if step is None or int(rec.get("step", -1)) == int(step):
                out[int(rec["shard"])] = int(rec["host"])
        return out

    def clear_ledger(self) -> None:
        for k in self.kv.keys("ledger/"):
            self.kv.delete(k)


# ---------------------------------------------------------------------------
# Store-backed heartbeat monitor
# ---------------------------------------------------------------------------


class DurableHeartbeatMonitor:
    """``fault.HeartbeatMonitor`` interface backed by a CoordinationStore.

    The liveness rule is identical (timeout + startup grace for hosts that
    never beat) but the records live in the durable store, so a failover
    coordinator reads the same truth the dead one saw.  ``partition(h)``
    models a network partition: host ``h``'s beats are dropped at the
    transport, so the cluster declares it dead and recovers its shards
    even though the host itself keeps running.
    """

    def __init__(self, coord: CoordinationStore, num_hosts: int, *,
                 timeout_s: float = 60.0, grace_s: float | None = None,
                 clock: Callable[[], float] | None = None):
        self.coord = coord
        self.num_hosts = num_hosts
        self.timeout_s = timeout_s
        self.grace_s = timeout_s if grace_s is None else grace_s
        self.clock = coord.clock if clock is None else clock
        self.partitioned: set[int] = set()
        for i in range(num_hosts):
            coord.register_host(i)

    def partition(self, host: int) -> None:
        if host not in self.partitioned:
            self.partitioned.add(host)
            self.coord.events.append(
                f"partition: host {host} unreachable — heartbeats and "
                f"store writes dropped at the transport")

    def heal(self, host: int) -> None:
        self.partitioned.discard(host)

    def beat(self, host_id: int, step: int) -> None:
        if host_id in self.partitioned:
            return  # dropped on the wire
        self.coord.beat(host_id, step)

    def _records(self) -> dict[int, dict]:
        recs = self.coord.host_records()
        # hosts with no surviving record at all count as never-beaten
        for i in range(self.num_hosts):
            recs.setdefault(i, {"host": i, "step": -1, "time": 0.0,
                                "ever": False})
        return recs

    def dead_hosts(self) -> list[int]:
        now = self.clock()
        out = []
        for i, rec in sorted(self._records().items()):
            limit = self.timeout_s + (0.0 if rec.get("ever") else self.grace_s)
            if now - float(rec.get("time", 0.0)) > limit:
                out.append(i)
        return out

    def alive_hosts(self) -> list[int]:
        dead = set(self.dead_hosts())
        return [i for i in sorted(self._records()) if i not in dead]

    def stragglers(self, *, lag: int = 2) -> list[int]:
        recs = self._records()
        alive = self.alive_hosts()
        if not alive:
            return []
        front = max(int(recs[i].get("step", -1)) for i in alive)
        return [i for i in alive
                if front - int(recs[i].get("step", -1)) >= lag]
