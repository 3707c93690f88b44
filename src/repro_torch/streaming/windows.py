"""Window configurations for the continuous-ingestion service.

Counterpart of ``repro/streaming/windows.py``, unchanged.

Windows are **count-based** over micro-batches (the service's unit of
arrival): a window covers the trailing ``size`` micro-batches and advances
every ``slide``.  The implementation is a ring of ``size // slide`` window
*slots*, each an independent carried combiner state accumulating one
slide-period of micro-batches:

* ingest   — the incoming batch folds into the current period's slot; on
  entering a new period the oldest slot is re-initialized first (that
  overwrite IS the expiry — no per-item timestamps, no re-scan).
* query    — the live slots' partial tables are merged with the derived
  combiner's merge (``engine.merge_partial_tables``), oldest first.  The
  combiner is a monoid, so the merged answer covers exactly the live
  micro-batches: counts, integer sums and max/min bit for bit with a
  batch run over them, float sums within rounding (the partial sums add
  in another order than one fold; ROADMAP C notes).  Only the window
  *boundary* is quantized to ``slide`` batches.

``tumbling(size)`` is the non-overlapping special case (``slide == size``,
one slot): queries during a period see that period's batches only, and the
table resets when the next period starts.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Window:
    """Count-based window: the trailing ``size`` micro-batches, advancing
    every ``slide`` (``slide == size`` -> tumbling).  ``size`` must be a
    multiple of ``slide``; the ring holds ``size // slide`` slots."""

    size: int
    slide: int

    def __post_init__(self):
        if self.size <= 0 or self.slide <= 0:
            raise ValueError(f"window size/slide must be positive, got "
                             f"size={self.size} slide={self.slide}")
        if self.size % self.slide != 0:
            raise ValueError(f"window size must be a multiple of slide "
                             f"(ring-of-slots expiry), got size={self.size} "
                             f"slide={self.slide}")

    @property
    def n_slots(self) -> int:
        return self.size // self.slide

    def period_of(self, batch_id: int) -> int:
        """Slide period the 0-based ``batch_id`` falls in."""
        return batch_id // self.slide

    def slot_of(self, batch_id: int) -> int:
        """Ring slot the 0-based ``batch_id`` folds into."""
        return self.period_of(batch_id) % self.n_slots

    def describe(self) -> str:
        kind = "tumbling" if self.slide == self.size else "sliding"
        return (f"{kind} size={self.size} slide={self.slide} batches "
                f"({self.n_slots} slot(s); expiry at slide granularity)")


def tumbling(size: int) -> Window:
    """Non-overlapping window of ``size`` micro-batches (one slot)."""
    return Window(size=size, slide=size)


def sliding(size: int, slide: int) -> Window:
    """Overlapping window: trailing ``size`` batches, advancing every
    ``slide`` (``size // slide`` ring slots)."""
    return Window(size=size, slide=slide)
