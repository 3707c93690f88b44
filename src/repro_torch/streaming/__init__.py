"""Continuous-ingestion streaming service over the staged plan.

Counterpart of ``repro/streaming``.  ``MapReduce(app,
streaming=True).serve(batch_capacity=...)`` stages the plan once and
returns a :class:`MapReduceService`: micro-batches fold incrementally into
persistent holder tables (N full micro-batches give the bits of one batch
run whose chunk is the micro-batch), with windowed aggregation
(:func:`tumbling` / :func:`sliding`), live
:meth:`~MapReduceService.snapshot` queries and checkpointed warm restarts.
:class:`IngestionQueue` is the bounded background front end; a poison
batch is quarantined (:class:`PoisonBatch`), a fatal worker death
surfaces as :class:`WorkerDiedError` and marks the service failed
(:class:`ServiceFailedError` on further ingests; snapshots keep serving).
"""

from repro_torch.streaming.ingest import (IngestionQueue, PoisonBatch,
                                          WorkerDiedError)
from repro_torch.streaming.service import (MapReduceService,
                                           ServiceFailedError)
from repro_torch.streaming.windows import Window, sliding, tumbling

__all__ = [
    "MapReduceService",
    "ServiceFailedError",
    "IngestionQueue",
    "PoisonBatch",
    "WorkerDiedError",
    "Window",
    "tumbling",
    "sliding",
]
