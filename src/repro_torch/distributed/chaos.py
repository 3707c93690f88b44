"""Deterministic chaos scripts for the resilient driver and the streaming
service.

Counterpart of ``repro/distributed/chaos.py``; its corruption primitives
work on the port's checkpoint files (``checkpoint/ckpt.py``, the
reference's format).  ``FaultInjection`` (``fault.py``) scripts the
basic cluster events: host deaths, stragglers, elastic resizes.
``ChaosPlan`` extends it into a multi-fault drill for the durable control
plane:

* ``kill_coordinator(after=k)``: the lease holder dies after completing
  ``k`` of its shards; the lowest-ranked survivor adopts the lease and
  the ledger, and phase B resumes with the same bits.
* ``corrupt_checkpoint(*shards)``: those shards' durable partials are
  bit-flipped on disk and their in-memory copies dropped, which forces
  the verify → quarantine → recompute path.
* ``partition(*hosts)``: the hosts keep computing, but their beats and
  store writes are dropped at the transport; the cluster declares them
  dead and recomputes their shards.
* ``delay_store(ops, kinds)``: the first N matching store operations
  raise ``StoreTimeout``; the RetryPolicy's bounded backoff must absorb
  them, every attempt on the record.
* ``straggler(*hosts)`` / ``kill_host`` / ``resize``: the base
  ``FaultInjection`` events.

Every fault is deterministic (no RNG): a plan replays the same drill bit
for bit, so a recovered answer can be held to the clean run's bits.
"""

from __future__ import annotations

import dataclasses
import os

from repro_torch.checkpoint import ckpt
from repro_torch.distributed.fault import FaultInjection


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """A scripted multi-fault drill.  Build fluently:

    >>> plan = (ChaosPlan()
    ...         .kill_coordinator(after=1)
    ...         .corrupt_checkpoint(3)
    ...         .delay_store(2)
    ...         .straggler(5))

    Consumed by ``engine.run_resilient(chaos=plan)``; the parts that map
    onto the base ``FaultInjection`` are merged by ``resolve_injection``,
    the control-plane faults (corruption, partitions, store delays) are
    applied by the driver against the CoordinationStore + checkpoint
    layer directly.
    """

    #: kill the current lease holder after it completes this many shards
    #: (None = coordinator survives).
    kill_coordinator_after: int | None = None
    dead_hosts: tuple[int, ...] = ()
    die_after_shards: int = 0
    checkpoint_survives: bool = True
    straggler_hosts: tuple[int, ...] = ()
    partition_hosts: tuple[int, ...] = ()
    #: shards whose durable partials are bit-flipped (and in-memory copies
    #: dropped) after the map phase.
    corrupt_shards: tuple[int, ...] = ()
    #: arm CoordinationStore.inject_store_faults with (ops, kinds).
    store_fail_ops: int = 0
    store_fail_kinds: tuple[str, ...] = ("ckpt",)
    resize_to: int | None = None

    # -- fluent builders (frozen: each returns a new plan) ------------------

    def kill_coordinator(self, *, after: int = 0) -> "ChaosPlan":
        return dataclasses.replace(self, kill_coordinator_after=int(after))

    def kill_host(self, *hosts: int, after: int = 0,
                  checkpoint_survives: bool = True) -> "ChaosPlan":
        return dataclasses.replace(
            self, dead_hosts=tuple(sorted(set(self.dead_hosts)
                                          | set(int(h) for h in hosts))),
            die_after_shards=int(after),
            checkpoint_survives=bool(checkpoint_survives))

    def corrupt_checkpoint(self, *shards: int) -> "ChaosPlan":
        return dataclasses.replace(
            self, corrupt_shards=tuple(sorted(set(self.corrupt_shards)
                                              | set(int(s) for s in shards))))

    def partition(self, *hosts: int) -> "ChaosPlan":
        return dataclasses.replace(
            self, partition_hosts=tuple(sorted(set(self.partition_hosts)
                                               | set(int(h) for h in hosts))))

    def delay_store(self, ops: int,
                    kinds: tuple[str, ...] = ("ckpt",)) -> "ChaosPlan":
        return dataclasses.replace(self, store_fail_ops=int(ops),
                                   store_fail_kinds=tuple(kinds))

    def straggler(self, *hosts: int) -> "ChaosPlan":
        return dataclasses.replace(
            self, straggler_hosts=tuple(sorted(set(self.straggler_hosts)
                                               | set(int(h) for h in hosts))))

    def resize(self, to: int) -> "ChaosPlan":
        return dataclasses.replace(self, resize_to=int(to))

    # -- resolution ---------------------------------------------------------

    def resolve_injection(self, base: FaultInjection | None,
                          coordinator: int) -> FaultInjection:
        """Merge this plan (given the elected coordinator's rank) with an
        optional base ``FaultInjection`` into the script the resilient
        driver's existing death/straggler/resize machinery consumes.
        ``die_after_shards`` is a single global knob in FaultInjection, so
        a kill-coordinator ``after`` takes precedence when set."""
        base = base if base is not None else FaultInjection()
        dead = set(base.dead_hosts) | set(self.dead_hosts)
        die_after = max(base.die_after_shards, self.die_after_shards)
        if self.kill_coordinator_after is not None:
            dead.add(int(coordinator))
            die_after = int(self.kill_coordinator_after)
        return FaultInjection(
            dead_hosts=tuple(sorted(dead)),
            die_after_shards=die_after,
            checkpoint_survives=(base.checkpoint_survives
                                 and self.checkpoint_survives),
            straggler_hosts=tuple(sorted(set(base.straggler_hosts)
                                         | set(self.straggler_hosts))),
            resize_to=(self.resize_to if self.resize_to is not None
                       else base.resize_to),
        )

    def describe(self) -> tuple[str, ...]:
        out = []
        if self.kill_coordinator_after is not None:
            out.append(f"kill coordinator after "
                       f"{self.kill_coordinator_after} shards")
        if self.dead_hosts:
            out.append(f"kill hosts {list(self.dead_hosts)} after "
                       f"{self.die_after_shards} shards"
                       + ("" if self.checkpoint_survives
                          else " (checkpoints lost)"))
        if self.corrupt_shards:
            out.append(f"corrupt shard partials {list(self.corrupt_shards)}")
        if self.partition_hosts:
            out.append(f"partition hosts {list(self.partition_hosts)}")
        if self.store_fail_ops:
            out.append(f"delay first {self.store_fail_ops} store ops "
                       f"(kinds {list(self.store_fail_kinds)})")
        if self.straggler_hosts:
            out.append(f"stragglers {list(self.straggler_hosts)}")
        if self.resize_to is not None:
            out.append(f"elastic resize to {self.resize_to} hosts")
        return tuple(out)


# ---------------------------------------------------------------------------
# Deterministic corruption primitives
# ---------------------------------------------------------------------------


def corrupt_payload(path: str, *, nbytes: int = 64) -> None:
    """Deterministically flip the first ``nbytes`` of a file in place
    (XOR 0xFF) — models bit rot / a torn remote copy without any RNG."""
    with open(path, "r+b") as f:
        head = f.read(nbytes)
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in head))


def truncate_payload(path: str, *, keep: int = 16) -> None:
    """Deterministically truncate a file to ``keep`` bytes — models a
    torn write that escaped the atomic-rename discipline (e.g. a partial
    object-store upload)."""
    with open(path, "r+b") as f:
        f.truncate(keep)


def corrupt_shard_partial(ckpt_dir: str, shard: int, step: int) -> str | None:
    """Corrupt the durable partial checkpoint of one shard (the payload
    bytes, so the manifest CRC catches it); returns the corrupted path or
    None when that shard has no checkpoint on disk."""
    d = os.path.join(ckpt.shard_partial_dir(ckpt_dir, shard),
                     f"step_{step}")
    apath = os.path.join(d, "arrays.npz")
    if not os.path.exists(apath):
        return None
    corrupt_payload(apath)
    return apath


def corrupt_service_checkpoint(ckpt_dir: str, step: int) -> str | None:
    """Corrupt a streaming-service snapshot (``service/step_<N>``) —
    drives the MapReduceService torn-restore drill."""
    d = os.path.join(ckpt.service_state_dir(ckpt_dir), f"step_{step}")
    apath = os.path.join(d, "arrays.npz")
    if not os.path.exists(apath):
        return None
    truncate_payload(apath)
    return apath
