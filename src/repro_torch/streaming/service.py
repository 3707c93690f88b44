"""MapReduceService: a long-lived, continuously ingesting MapReduce.

Counterpart of ``repro/streaming/service.py``.  The batch engine answers
"fold these N items"; a service absorbs micro-batches for as long as it
runs and answers live queries.  The derived combiner is a monoid, so
partial tables can be folded into and merged at any time.

Staging: the service stages once, through the staged path
(``lower().optimize().compile()`` at mode="streaming"), into an ingest
``(state, items, n_valid) -> state`` sized to ``batch_capacity``
(``engine.build_stream_ingest``).  Every ``ingest()`` after that is a
dispatch: no re-planning, re-tuning or re-compiling, which
``plan_cache.stats_snapshot()`` shows.  A micro-batch below the capacity
is not padded: the reference pads it and masks the tail to the sentinel
key (its executables have static shapes), but the port's fold loop runs
on the host and stops at ``n_valid``, and a sum's lane order depends on
the pairs a fold call sees (ROADMAP C.26), so padding would change the
bits.  N ingests of full micro-batches give the bits of one batch run
whose chunk is the micro-batch.

Consistency: the whole mutable state lives in one immutable
:class:`_ServiceState` behind a single reference.  ``ingest()`` builds a
new record (every fold returns new tensors; the old tables are never
written through) and swaps the reference; ``snapshot()`` reads the
reference once and works off that frozen view, so snapshots are
consistent without pausing ingestion and without copying tables.  On the
card, ingestion and snapshots issue their kernels on the same stream, so
a snapshot's reads follow, in stream order, the writes of the state it
read.

Exactness: counts live in the collector's count column, the last
column of a fused f32 accumulator where the kernel folds sums.  It holds
a count exactly up to 2^24 (int32 counts: 2^31 - 1), as in the batch
flow; a batch run is bounded, but a service under ``window=None`` never
resets its table, so ``counts_exact`` and ``explain()`` say when a slot
may have passed the bound.

Durability: every ``ckpt_every`` batches the slot states are saved
atomically through ``checkpoint/ckpt.py`` (the reference's format), keyed
by the number of batches ingested.  ``restore()`` reloads the newest valid
checkpoint bit for bit, so a restarted service continues exactly where
the checkpoint was cut.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.checkpoint import ckpt
from repro_torch.core import engine as eng
from repro_torch.core import plan_cache as pc
from repro_torch.core.api import (ExecutionOptions, MapReduce,
                                  MapReduceResult, to_device)
from repro_torch.streaming.windows import Window


class ServiceFailedError(RuntimeError):
    """The service was marked failed (a fatal ingestion-worker death or an
    explicit ``fail()``): ingestion is refused, ``snapshot()`` keeps
    serving the last consistent state, and a ``restore()`` clears the
    mark."""


@dataclasses.dataclass(frozen=True)
class _ServiceState:
    """One immutable generation of the service: swap-on-ingest."""

    slots: tuple  # per-window-slot carried collector states
    batch_id: int  # micro-batches ingested so far
    n_items: int  # items ingested so far


class MapReduceService:
    """Continuous-ingestion MapReduce over a plan staged once.

    Build it with :meth:`MapReduce.serve`::

        mr = MapReduce(app, streaming=True)
        svc = mr.serve(batch_capacity=512, window=sliding(8, 2),
                       ckpt_dir="/ckpts", ckpt_every=16)
        svc.ingest(items)                # folds one micro-batch
        res = svc.snapshot()             # live MapReduceResult, no pause

    ``window=None`` aggregates globally (nothing expires); a
    :class:`~repro_torch.streaming.Window` bounds results to the trailing
    micro-batches with a ring of per-slot tables (``windows.py``), which
    needs the derived combiner's partials to be mergeable
    (``derivation.mergeable_partials``): the slots are merged at query
    time.
    """

    def __init__(self, mr: MapReduce, *, batch_capacity: int,
                 window: Window | None = None,
                 options: ExecutionOptions | None = None,
                 item_spec: Any = None,
                 ckpt_dir: str | None = None, ckpt_every: int = 0,
                 keep_ckpts: int = 3, retry_policy: Any = None):
        if batch_capacity <= 0:
            raise ValueError("batch_capacity must be positive")
        if mr.plan.flow != "stream":
            raise ValueError(
                f"MapReduceService needs the stream flow (micro-batches "
                f"fold into its carried holder tables); this plan chose "
                f"{mr.plan.flow!r} — construct MapReduce(app, "
                f"streaming=True)")
        d = mr.plan.derivation
        if (window is not None and d is not None
                and not d.mergeable_partials):
            raise ValueError(
                "windowed serving merges per-slot partial tables at query "
                "time, but this combiner's partials are not mergeable "
                f"({mr.plan.spec.describe}); use window=None (global "
                "aggregation) or a merge-capable reducer")
        self.mr = mr
        self.app = mr.app
        self.spec = mr.plan.spec
        self.device = mr.device
        self.batch_capacity = int(batch_capacity)
        self.window = window
        cap = max(self.app.emit_capacity, 1)
        opts = options if options is not None else ExecutionOptions()
        if opts.chunk_pairs is None:
            # one fold per ingest: the chunk is the micro-batch, so N
            # ingests replay the chunks of a batch run with this chunk
            opts = dataclasses.replace(
                opts, chunk_pairs=self.batch_capacity * cap)
        self.options = opts
        self._ckpt_dir = (ckpt.service_state_dir(ckpt_dir)
                          if ckpt_dir is not None else None)
        self.ckpt_every = int(ckpt_every)
        self.keep_ckpts = int(keep_ckpts)
        self.retry_policy = retry_policy
        self._lock = threading.Lock()  # serializes writers, never readers
        self._compiled = None
        self._item_sig: str | None = None
        self._state: _ServiceState | None = None
        self._failed: BaseException | None = None
        #: control-plane event lines (checkpoint and restore retries,
        #: failure marks), shown by explain() and mirrored onto the
        #: compiled plan's diagnostics
        self.events: list[str] = []
        if item_spec is not None:
            self._compile(pc.items_spec_of(item_spec))

    # -- failure state --------------------------------------------------------

    def fail(self, exc: BaseException) -> None:
        """Mark the service failed (the ingestion front end does, on a
        fatal worker death): ingestion is refused from here on, snapshots
        keep serving the last published state."""
        self._failed = exc
        self._record(f"service marked FAILED: {type(exc).__name__}: {exc}; "
                     f"snapshots still serve the last consistent state")

    @property
    def failed(self) -> BaseException | None:
        """The failure the service was marked with, or None."""
        return self._failed

    def _record(self, line: str) -> None:
        self.events.append(line)
        if self._compiled is not None:
            self._compiled.plan.diagnostics += (line,)

    def _retried(self, op: str, fn):
        """``fn()``, through ``retry_policy.call(fn, op=, on_event=)`` when
        the service has a retry policy (a
        ``distributed.coordination.RetryPolicy``; any object with that
        method works)."""
        if self.retry_policy is None:
            return fn()
        return self.retry_policy.call(fn, op=op, on_event=self._record)

    # -- staging --------------------------------------------------------------

    @property
    def n_slots(self) -> int:
        return self.window.n_slots if self.window is not None else 1

    @property
    def collector(self):
        """The staged ingest's collector (``Compiled.collector``), which
        makes, reads and finalizes the slot states."""
        if self._compiled is None:
            raise RuntimeError("service not staged: ingest a first "
                               "micro-batch or construct it with "
                               "item_spec=...")
        return self._compiled.collector

    def _compile(self, item_spec) -> None:
        """Stage the ingest (once) for items of one-item spec
        ``item_spec``."""
        batch_spec = pytree.tree_map(
            lambda a: pc.TensorSpec((self.batch_capacity,) + tuple(a.shape),
                                    a.dtype), item_spec)
        self._compiled = self.mr.lower(
            batch_spec, options=self.options, mode="streaming"
        ).optimize().compile()
        self._item_sig = pc.spec_sig_of(item_spec)
        self._state = _ServiceState(
            slots=tuple(self._compiled.init_state()
                        for _ in range(self.n_slots)),
            batch_id=0, n_items=0)

    # -- ingestion ------------------------------------------------------------

    def ingest(self, items) -> int:
        """Fold one micro-batch (at most ``batch_capacity`` items) into the
        live tables; returns the batch id (the 1-based count of batches
        ingested).  Writers serialize on the service lock; snapshots never
        wait on it."""
        if self._failed is not None:
            raise ServiceFailedError(
                f"service is marked failed "
                f"({type(self._failed).__name__}: {self._failed}); "
                f"snapshot() still serves, restore() a checkpoint to "
                f"resume ingestion") from self._failed
        items = to_device(items, self.device)
        n = eng.items_length(items)
        item_spec = pc.item_spec_of(pc.items_spec_of(items))
        if self._compiled is None:
            self._compile(item_spec)
        elif pc.spec_sig_of(item_spec) != self._item_sig:
            raise ValueError(
                f"micro-batch items {pc.spec_sig_of(item_spec)} do not "
                f"match the staged item spec {self._item_sig}")
        with self._lock:
            st = self._state
            b = st.batch_id  # 0-based id of the incoming batch
            slots = list(st.slots)
            if self.window is not None:
                i = self.window.slot_of(b)
                # the first batch of a slide period starts its slot afresh,
                # which expires the oldest period's tables
                seed = (self._compiled.init_state()
                        if b % self.window.slide == 0 else slots[i])
            else:
                i, seed = 0, slots[0]
            slots[i] = self._compiled.ingest_state(seed, items, n)
            new = _ServiceState(tuple(slots), b + 1, st.n_items + n)
            self._state = new  # the publish: snapshots see old or new
            if (self._ckpt_dir is not None and self.ckpt_every > 0
                    and new.batch_id % self.ckpt_every == 0):
                self._save(new)
        return new.batch_id

    # -- queries --------------------------------------------------------------

    def _live_slots(self, st: _ServiceState) -> list:
        """Live slot states, oldest period first: a fixed merge order,
        which makes restore-then-snapshot reproduce the bits."""
        if self.window is None or st.batch_id == 0:
            return [st.slots[0]] if self.window is None else []
        p = self.window.period_of(st.batch_id - 1)  # current period
        live = min(p + 1, self.window.n_slots)
        return [st.slots[(p - k) % self.window.n_slots]
                for k in range(live - 1, -1, -1)]

    def snapshot(self) -> MapReduceResult:
        """A consistent view of the live tables; ingestion is not paused.
        Reads the state reference once (one immutable generation) and
        finalizes or merges off that view."""
        if self._state is None:
            raise RuntimeError(
                "service not staged yet: ingest a first micro-batch or "
                "construct with item_spec=... to stage eagerly")
        st = self._state
        states = self._live_slots(st)
        comp = self._compiled
        with torch.no_grad():
            if len(states) <= 1:
                g = comp.finalize_state(states[0] if states
                                        else comp.init_state())
                keys, values, counts = g.keys, g.values, g.counts
            else:
                pairs = [comp.state_tables(s) for s in states]
                keys, values, counts = eng.merge_partial_tables(
                    self.app, self.spec, [t for t, _ in pairs],
                    [c for _, c in pairs])
        return MapReduceResult(keys, values, counts, plan=comp.plan,
                               batch_id=st.batch_id)

    @property
    def batch_id(self) -> int:
        """Micro-batches ingested so far."""
        return self._state.batch_id if self._state is not None else 0

    @property
    def n_items(self) -> int:
        """Items ingested so far."""
        return self._state.n_items if self._state is not None else 0

    # -- count exactness --------------------------------------------------------

    def count_limit(self) -> int:
        """The largest count a slot's count column holds exactly: 2^24 in
        the fused f32 accumulator (f32 has a 24-bit significand; the
        batch flow shares the bound), else 2^31 - 1 (int32 counts)."""
        return (1 << 24) if self.collector.fused_acc else (1 << 31) - 1

    def slot_pairs_bound(self) -> int:
        """The most pairs any one slot can hold so far: every pair
        ingested under ``window=None``, which never resets its table;
        at most ``slide`` micro-batches under a window."""
        items = self.n_items
        if self.window is not None:
            items = min(items, self.window.slide * self.batch_capacity)
        return items * max(self.app.emit_capacity, 1)

    @property
    def counts_exact(self) -> bool:
        """Whether every count is still guaranteed exact: no slot can have
        folded more pairs into one key than :meth:`count_limit`.  Past
        it, a fused accumulator's counts (and with them its means) may
        stop growing; a window bounds a slot's pairs, a global service
        does not."""
        return self.slot_pairs_bound() <= self.count_limit()

    # -- durability -----------------------------------------------------------

    def _state_tree(self, st: _ServiceState) -> dict:
        return {"slots": list(st.slots),
                "meta": np.asarray([st.batch_id, st.n_items], np.int64)}

    def _save(self, st: _ServiceState) -> str:
        return self._retried(
            f"checkpoint batch {st.batch_id}",
            lambda: ckpt.save(self._ckpt_dir, st.batch_id,
                              self._state_tree(st), keep=self.keep_ckpts))

    def checkpoint(self) -> str:
        """Save the current state to the checkpoint dir now (atomically);
        returns the written path."""
        if self._ckpt_dir is None:
            raise RuntimeError("service was built without ckpt_dir")
        if self._state is None:
            raise RuntimeError("nothing to checkpoint: service not staged")
        with self._lock:
            return self._save(self._state)

    def restore(self, ckpt_dir: str | None = None,
                *, step: int | None = None) -> int:
        """Warm restart: load the newest valid checkpoint (or ``step``) and
        resume bit for bit where the service that wrote it stood.

        Every checkpoint is checksummed (``checkpoint/ckpt.py``).  With an
        explicit ``step`` a torn or corrupt checkpoint raises
        ``CheckpointCorruptError`` naming the step and path (and is
        quarantined to ``*.corrupt``); with ``step=None`` corrupt
        candidates are quarantined and skipped.  ``retry_policy`` (if set)
        retries the read.

        The service must be staged (construct with ``item_spec=``), so
        that the state's structure is known; the checkpoint must hold this
        port's state (a reference service's tree crosses through
        ``repro_torch.interop.service_state_from_repro``).  A successful
        restore clears a ``failed`` mark.  Returns the restored batch
        id."""
        d = (ckpt.service_state_dir(ckpt_dir) if ckpt_dir is not None
             else self._ckpt_dir)
        if d is None:
            raise RuntimeError("no checkpoint dir: pass ckpt_dir=...")
        if self._compiled is None:
            raise RuntimeError(
                "service not staged: construct with item_spec=... so the "
                "carried-state structure is known before restore")
        example = self._state_tree(_ServiceState(
            slots=tuple(self._compiled.init_state()
                        for _ in range(self.n_slots)),
            batch_id=0, n_items=0))
        tree, step = self._retried(
            f"service restore from {d}",
            lambda: ckpt.restore(d, example, step=step, device=self.device))
        for got, want in zip(ckpt.flatten(tree["slots"])[0],
                             ckpt.flatten(example["slots"])[0]):
            if got.shape != want.shape or got.dtype != want.dtype:
                raise ValueError(
                    f"checkpoint step {step} under {d} holds a "
                    f"{got.dtype}{tuple(got.shape)} table where this "
                    f"service carries {want.dtype}{tuple(want.shape)}; a "
                    f"reference service's tree crosses through "
                    f"repro_torch.interop.service_state_from_repro")
        meta = tree["meta"].tolist()
        with self._lock:
            self._state = _ServiceState(
                slots=tuple(tree["slots"]), batch_id=int(meta[0]),
                n_items=int(meta[1]))
            if self._failed is not None:
                self._record(f"service failure mark cleared by restore of "
                             f"batch {step}")
                self._failed = None
        return step

    # -- introspection ---------------------------------------------------------

    def _table_bytes(self) -> int:
        """Bytes of one slot's carried state: the port's own tables once
        staged (integer sums in int64, ROADMAP C.5; a fused f32
        accumulator where the kernel folds sums), else the holder bytes
        the spec gives and int32 counts."""
        if self._state is not None:
            return sum(t.numel() * t.element_size()
                       for t in ckpt.flatten(self._state.slots[0])[0])
        _, holder_bytes = self.spec.holder_width(self.app.value_spec)
        return self.app.key_space * (holder_bytes + 4)

    def explain(self) -> str:
        """The service's decision record: the compiled plan (flow,
        combiner, tiling, plan-cache and compiled-cache provenance), then
        the serving configuration: window, table residency, the count
        column's exactness bound (:attr:`counts_exact`), checkpoint
        cadence."""
        from repro_torch.roofline import analysis

        lines = []
        if self._compiled is not None:
            lines.append(self._compiled.explain())
        else:
            lines.append(self.mr.explain())
            lines.append("mode: streaming (not staged yet — no item spec)")
        cap = max(self.app.emit_capacity, 1)
        lines.append(
            f"service: batch_capacity={self.batch_capacity} items "
            f"({self.batch_capacity * cap} pairs/ingest), ingested "
            f"{self.batch_id} batches / {self.n_items} items, on "
            f"{self.device}")
        lines.append("window: "
                     + (self.window.describe() if self.window is not None
                        else "global (no expiry)"))
        K = self.app.key_space
        vs = self.app.value_spec
        table = self._table_bytes()
        peak = analysis.mapreduce_flow_peak_bytes(
            "stream", n_pairs=self.batch_capacity * cap, key_space=K,
            value_bytes=vs.dtype.itemsize * max(1, int(np.prod(vs.shape))),
            holder_bytes=self.spec.holder_width(vs)[1],
            chunk_pairs=self.options.chunk_pairs)
        lines.append(
            f"residency: holder tables {table:,} B/slot x {self.n_slots} "
            f"slot(s) = {table * self.n_slots:,} B resident (the port's own "
            f"tables: integer sums in int64); ~{peak:,.0f} B peak per "
            f"ingest (roofline stream model, K={K})")
        if self._compiled is not None:
            limit, bound = self.count_limit(), self.slot_pairs_bound()
            layout = ("fused f32 accumulator" if self.collector.fused_acc
                      else "int32 counts")
            lines.append(
                f"counts: exact up to {limit:,} pairs a key in a slot "
                f"({layout}); a slot holds at most {bound:,} pairs so far"
                + (" (within the bound)" if bound <= limit else
                   " — PAST the bound: counts may have stopped being exact"
                   + ("; window=None never resets its table"
                      if self.window is None else "")))
        if self._ckpt_dir is not None and self.ckpt_every > 0:
            last = ckpt.latest_step(self._ckpt_dir)
            lines.append(
                f"checkpoint: {self._ckpt_dir} every {self.ckpt_every} "
                f"batches (keep={self.keep_ckpts}, last="
                f"{'none' if last is None else f'batch {last}'})")
        else:
            lines.append("checkpoint: off")
        if self._failed is not None:
            lines.append(f"state: FAILED ({type(self._failed).__name__}: "
                         f"{self._failed}) — snapshots only")
        for ev in self.events:
            lines.append(f"event: {ev}")
        return "\n".join(lines)
