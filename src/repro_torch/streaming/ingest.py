"""Bounded background ingestion front end for :class:`MapReduceService`.

Counterpart of ``repro/streaming/ingest.py``, unchanged.

The telemetry-server shape: producers enqueue micro-batches, one worker
thread drains the queue into ``service.ingest`` — so the service's
single-writer lock is never contended and producers get **backpressure**
(a full queue blocks ``put``) instead of unbounded buffering.  Snapshot
queries run concurrently against the service; they never touch the queue.

Failure posture: the worker
thread is the only consumer of a BOUNDED queue, so a worker that dies
silently strands every producer blocked in ``put`` forever.  Two distinct
failure classes are handled separately:

* **Poison batch** — ``service.ingest`` rejects one batch (bad shape,
  over capacity).  The batch is quarantined (recorded on ``quarantined``
  with its arrival sequence number and the exception), the error is
  surfaced on the next ``put``/``join``/``close``, and the worker KEEPS
  consuming — later good batches still fold, and the service keeps
  serving snapshots.  One bad producer does not take down the pipeline.
* **Fatal worker death** — anything that escapes the per-batch handler
  (``BaseException``: a ``MemoryError``, interpreter shutdown...).  The
  worker marks itself dead, marks the service failed
  (``service.fail(exc)``), and drains the queue so blocked producers
  unblock; every subsequent ``put`` raises ``WorkerDiedError``
  immediately instead of blocking on a queue nobody will ever drain.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time


class WorkerDiedError(RuntimeError):
    """The ingestion worker thread died fatally; the queue is closed."""


@dataclasses.dataclass(frozen=True)
class PoisonBatch:
    """One quarantined micro-batch: its arrival sequence number (1-based,
    the batch id it WOULD have been folded as next) and the exception
    ``service.ingest`` raised for it."""

    seq: int
    error: Exception


class IngestionQueue:
    """Single-consumer micro-batch queue feeding a MapReduceService.

    ``put(items)`` enqueues (blocking when ``maxsize`` batches are
    pending); the worker folds them in arrival order, preserving the
    service's deterministic fold sequence.  A worker-side exception is
    re-raised on the next ``put``/``join``/``close``; the offending batch
    is quarantined on ``quarantined`` and later batches still fold.
    """

    def __init__(self, service, *, maxsize: int = 8):
        self.service = service
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._err: Exception | None = None
        self._fatal: BaseException | None = None
        self._dead = False
        self._seq = 0
        self.quarantined: list[PoisonBatch] = []
        self._t = threading.Thread(target=self._worker, daemon=True)
        self._t.start()

    def _worker(self):
        try:
            while True:
                item = self._q.get()
                try:
                    if item is None:
                        return
                    seq, batch = item
                    try:
                        self.service.ingest(batch)
                    except Exception as e:  # poison batch: quarantine it
                        self.quarantined.append(PoisonBatch(seq, e))
                        if self._err is None:  # first error wins the raise
                            self._err = e
                finally:
                    self._q.task_done()
        except BaseException as e:  # fatal: unstrand producers, then die
            self._fatal = e
            self._dead = True
            fail = getattr(self.service, "fail", None)
            if fail is not None:
                try:
                    fail(e)
                except Exception:
                    pass
            while True:  # drain so producers blocked in put() unblock
                try:
                    self._q.get_nowait()
                    self._q.task_done()
                except queue.Empty:
                    return

    def _raise_pending(self):
        if self._fatal is not None:
            raise WorkerDiedError(
                f"ingestion worker died: {type(self._fatal).__name__}: "
                f"{self._fatal}") from self._fatal
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def put(self, items, *, timeout: float | None = None) -> None:
        """Enqueue one micro-batch; blocks while the queue is full.
        Raises the pending poison-batch error if one is queued, or
        ``WorkerDiedError`` immediately (no deadlock) if the worker died.
        """
        self._raise_pending()
        self._seq += 1
        item = (self._seq, items)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self._dead:
                self._raise_pending()
            wait = 0.05
            if deadline is not None:
                wait = min(wait, deadline - time.monotonic())
                if wait <= 0:
                    raise queue.Full
            try:
                self._q.put(item, timeout=wait)
                return
            except queue.Full:
                continue

    @property
    def pending(self) -> int:
        """Batches enqueued but not yet folded (approximate)."""
        return self._q.qsize()

    def join(self) -> None:
        """Block until every enqueued batch has been folded."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain, stop the worker and surface any pending error."""
        if not self._dead:
            try:
                self._q.put(None, timeout=5.0)
            except queue.Full:
                pass
        self._t.join(timeout=10.0)
        self._raise_pending()
