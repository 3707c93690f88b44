"""Cost model for execution-flow selection.

Counterpart of ``repro/core/cost_model.py``.  ``choose_flow`` ranks the
semantically equal flows for a workload size; the planner records the
report on the plan so that ``explain()`` shows why a flow was picked (the
paper's §3.2 step 6, made quantitative).  Each flow's estimate is a sum of
named terms in seconds, from one of two profiles:

* ``cpu`` — the reference's XLA:CPU coefficients and terms, as they are,
  kept so that plans on the CPU equal the reference's.  They are no
  measurement of the port's torch CPU path.
* ``cuda`` — terms from the port's own launch plans on the card, with
  coefficients fitted on an H100 (:data:`CUDA_COEFF`).  The stream fold
  takes the route of ``ops.fold_plan`` (in place, as the chunk loop
  folds): the tile route reads each chunk once per key tile × column
  tile (the lane-table or the index-order shape); the partitioned route
  moves it once through its partition pass(es), priced as the sort
  flow's, then reads the layout once per column tile; the sort flow moves
  each
  chunk once per pass of ``radix_partition.partition_passes`` (over the
  leaves of ``ops.plan_radix_levels``), then once through
  ``segment_reduce``; the combine flow takes one of the two over the
  whole pair buffer; the reduce flow sorts the pairs and gathers the
  ``[K, Lmax]`` windows.  Every flow pays a host cost per run and per
  chunk.

``default_backend(device)`` picks ``cuda`` for a CUDA device and ``cpu``
otherwise; nothing falls back from one to the other.

With ``num_shards > 1`` the shuffled flows (sort, reduce) pay a wire term:
the bytes a shard sends in the all-to-all under the codec
(``roofline.shuffle_wire_bytes``) over a link rate.  The ``cpu`` profile
divides by the reference's constant
(``roofline.REFERENCE_LINK_BYTES_PER_S``), so that its rankings equal the
reference's; the ``cuda`` profile by :data:`CUDA_EXCHANGE_BYTES_PER_S`,
measured on one card.  ``skew_factor`` (from ``core/skew.py``) scales the
shuffled flows by their hottest shard.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import autotune as at
from repro_torch.core import collector as col
from repro_torch.roofline import analysis as roofline

#: The reference's XLA:CPU per-term coefficients (seconds per unit), as
#: they are: measured for the JAX package on XLA:CPU, kept so that the
#: port's plans on the CPU equal the reference's.
#:   dispatch  — per-call fixed cost of a jitted executable
#:   pair      — map emission + per-pair plumbing (mask, reshape, premap)
#:   nk        — one element of the fused one-hot compare/accumulate sweep
#:   sortn     — one pair through one packed-sort comparator level
#:   seg       — one pair through the segmented-aggregate + run-end pass
#:   scatter   — one serialized scatter row update
#:   table     — one holder-table row touch (init/merge/finalize)
#:   window    — one padded reduce-flow window element (gather + reduce)
CPU_COEFF = {
    "dispatch": 60e-6,
    "pair": 3.0e-8,
    "nk": 1.8e-9,
    "sortn": 6.0e-9,
    "seg": 6.0e-8,
    "scatter": 1.0e-7,
    "table": 2.5e-9,
    "window": 4.0e-9,
}

#: The ``cuda`` profile.  ``dispatch`` and ``chunk`` are host seconds a run
#: and a chunk; each other coefficient is the device time of its kernels
#: over the time their bytes (:func:`cuda_work`) take at
#: :data:`roofline.H100_SXM_HBM_BYTES_PER_S`:
#:   map        — the map, the premap and the fold's input columns
#:   fold_lane  — a lane-table fold's tile passes, partials and table
#:   fold_table — an index-order fold's tile passes, partials and table
#:                (the partitioned route: its region fold and the table)
#:   partition  — the radix partition's passes (the sort flow's, and the
#:                partitioned route's)
#:   segment    — segment_reduce over the partitioned slots and the table
#:   reduce     — the reduce flow's stable sort and window gather
#: Fitted by ``chip_smoke.cost_refit`` (``fit_cost_profile``) on one
#: "NVIDIA H100 80GB HBM3, 700.00 W" (chip call 1 of the cost-model
#: findings in PERF.md §6):
#: the stream and sort flows of KeyedSum at K = 2^10..2^20 and 2^22 / 2^24
#: pairs, KMeans at 2^24 points and two reduce-flow runs; byte terms from
#: torch.profiler device time by kernel, the host terms from the walls
#: less device time.  ``chip_smoke.py``'s ``cost_profile`` line prints a
#: refit beside these on every run.  The stream fold's partitioned route
#: is priced with ``partition`` and ``fold_table``; a refit with the
#: route running (PERF.md §6) matched the measured winner at the same
#: swept shapes as these and made the ranking at K = 2^15 turn twice, so
#: these stand.
CUDA_COEFF = {
    "dispatch": 8.44e-4,
    "chunk": 3.13e-4,
    "map": 8.54,
    "fold_lane": 1.60,
    "fold_table": 7.24,
    "partition": 1.89,
    "segment": 7.96,
    "reduce": 8.80,
}

#: coefficients of each profile; a profile names every key its terms read
PROFILES = {"cpu": CPU_COEFF, "cuda": CUDA_COEFF}

#: The ``cuda`` profile's link rate, bytes per second: what
#: ``chip_smoke.py`` phase 12 measured for the all-to-all of a
#: ``LocalMesh`` on one "NVIDIA H100 80GB HBM3, 700.00 W" (the four
#: shards' wire bytes, 4 x 50331648, over the exchange's median wall of
#: 0.349 ms; KeyedSum K = 2^20, 2^24 pairs, S = 4; chip call 1 of the
#: distribution findings in PERF.md §6).  That exchange is a copy within
#: one card's memory, not a link between cards: an NVLink rate waits for a
#: machine with more than one card.
CUDA_EXCHANGE_BYTES_PER_S = 5.77e11


def link_bytes_per_s(backend: str) -> float:
    """The link rate the wire term of ``backend`` divides by."""
    if backend == "cpu":
        return roofline.REFERENCE_LINK_BYTES_PER_S
    return CUDA_EXCHANGE_BYTES_PER_S


@dataclasses.dataclass(frozen=True)
class FlowCost:
    """One flow's modeled cost for a workload."""

    flow: str
    est_s: float  # modeled wall-clock (backend profile)
    model_bytes: float  # analytic bytes (roofline flow model)
    terms: tuple[tuple[str, float], ...]  # named seconds contributions

    def describe(self) -> str:
        parts = " ".join(f"{k}={v * 1e6:.0f}us" for k, v in self.terms
                         if v * 1e6 >= 0.5)
        return (f"{self.flow}: est={self.est_s * 1e6:.0f}us "
                f"bytes={self.model_bytes / 1e6:.2f}MB ({parts})")


@dataclasses.dataclass(frozen=True)
class CostReport:
    """The planner's decision record: every candidate, ranked."""

    chosen: str
    n_pairs: int
    key_space: int
    backend: str
    costs: tuple[FlowCost, ...]  # sorted, cheapest first

    def cost_of(self, flow: str) -> FlowCost | None:
        for c in self.costs:
            if c.flow == flow:
                return c
        return None

    def describe(self) -> str:
        lines = [f"cost model [{self.backend}] N={self.n_pairs} "
                 f"K={self.key_space} -> {self.chosen}"]
        for c in self.costs:
            mark = "*" if c.flow == self.chosen else " "
            lines.append(f"  {mark} {c.describe()}")
        return "\n".join(lines)


def sort_radix_passes(n: int, key_space: int) -> int:
    """Packed-sort passes of the reference's pure-JAX stable key sort at
    this size (a copy of ``repro.core.collector.sort_radix_passes``, which
    the ``cpu`` profile's sort term reads; the port sorts with one
    ``torch.sort``): 1 while ``(key, index)`` fits one 31-bit word, else
    one pass per ``31 - idx_bits``-wide key digit."""
    idx_bits = max(n - 1, 0).bit_length()
    key_bits = max(key_space, 1).bit_length()  # sentinel == key_space
    if key_bits + idx_bits <= 31:
        return 1
    return -(-key_bits // max(31 - idx_bits, 1))


def _cpu_terms(flow: str, *, n, k, d, lmax, chunk_pairs, fused_combine,
               sort_passes=1):
    c = CPU_COEFF
    logn = max(math.log2(max(min(n, chunk_pairs), 2)), 1.0)
    terms = [("dispatch", c["dispatch"]), ("map", c["pair"] * n)]
    if flow == "stream":
        terms.append(("onehot", c["nk"] * n * k * d))
        terms.append(("table", c["table"] * k * d))
    elif flow == "sort":
        terms.append(("sort", c["sortn"] * n * logn * max(sort_passes, 1)))
        terms.append(("segments", c["seg"] * n * d))
        terms.append(("table", c["table"] * k * d))
    elif flow == "combine":
        if fused_combine:
            terms.append(("onehot", c["nk"] * n * k * d))
        else:
            terms.append(("scatter", c["scatter"] * n * (d + 1)))
        terms.append(("table", c["table"] * k * d))
    elif flow == "reduce":
        terms.append(("sort", c["sortn"] * n * logn))
        terms.append(("group", c["scatter"] * n))
        terms.append(("windows", c["window"] * k * lmax * d))
    else:
        raise ValueError(f"unknown flow {flow!r}")
    return terms


def _chunks(n: int, chunk: int) -> list[tuple[int, int]]:
    """``(pairs, how many)`` of the chunks of an ``n``-pair run."""
    full, last = divmod(n, chunk)
    return [(m, c) for m, c in ((chunk, full), (last, 1)) if m and c]


def _fold_bytes(m: int, k: int, cols: int, op: str) -> dict[str, float]:
    """Bytes by term of one keyed fold of ``m`` pairs into a ``[K, cols]``
    table as the stream flow launches it (an add's last column counts the
    pairs), with the key tile ``autotune_stream`` passes on, and the table
    read and written.  On the tile route each tile pass reads the chunk's
    keys and the tile's columns, and the segment partials are written and
    joined; on the partitioned route each partition pass reads the keys
    for its histogram, then the pairs, and writes them to their padded
    slots (``partition``), and each column tile reads the slots' keys and
    its value columns (``fold_table``)."""
    from repro_torch.kernels import ops

    blk = min(ops.auto_key_block(k), k)
    plan = ops.fold_plan(m, k, cols, op, blk if blk < k else None,
                         op == "add", True)
    table = 2 * k * cols * 4
    if plan.route == "partitioned":
        vd = cols - (op == "add")
        slots = plan.n_seg * plan.part.slots
        pair = 4 * (1 + vd)
        return {"partition": len(plan.part.passes) * (m * 4 + m * pair
                                                      + slots * pair),
                "fold_table": slots * 4 * (plan.col_tiles + vd) + table}
    passes = plan.key_tiles * plan.col_tiles
    partials = 2 * plan.n_seg * k * cols * 4 if plan.n_seg > 1 else 0
    nbytes = passes * m * 4 * (1 + plan.cols) + partials + table
    return {"fold_lane" if plan.shape == "lane" else "fold_table": nbytes}


def _sort_bytes(m: int, k: int, cols: int) -> tuple[float, float]:
    """(partition bytes, segment_reduce bytes) of one sort-flow fold of
    ``m`` pairs into a ``[K, cols]`` table: each partition pass reads the
    keys for its histogram, then the pairs, and writes them to their
    padded slots; segment_reduce reads the slots and reads and writes the
    table."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import radix_partition as rp

    plan = ops.plan_radix_levels(k, d=cols)
    leaf = plan.bucket_size if plan.feasible else k
    passes = rp.partition_passes(k, leaf, ops.KERNEL_MAX_LEVEL_BUCKETS)
    slots = rp.partition_slots(m, -(-k // leaf), 256)
    pair = 4 * (1 + cols)
    part = len(passes) * (m * 4 + m * pair + slots * pair)
    return part, slots * pair + 2 * k * cols * 4


def cuda_work(flow: str, *, n_pairs: int, key_space: int, d: int = 1,
              value_bytes: int = 4, chunk_pairs: int | None = None,
              max_values_per_key: int | None = None,
              fold_op: str = "add") -> dict[str, float]:
    """The units each ``cuda`` coefficient prices for one run: chunks (the
    host's per-chunk launches) and, per term, the bytes its kernels move.
    ``d`` is the holder's elements a key; the folds carry one more column
    (the counts).  ``fold_op`` is the stream fold's (``add`` takes the
    lane-table plan where it fits)."""
    n, k = max(int(n_pairs), 1), max(int(key_space), 1)
    cols = d + 1
    chunk = chunk_pairs or at.CUDA_CHUNK_PAIRS
    if flow in ("combine", "reduce"):
        chunk = n  # one map over every item, one pass over the buffer
    sizes = _chunks(n, chunk)
    work = {"chunk": float(sum(c for _, c in sizes)),
            "map": float(n * (4 + value_bytes + 4 * cols))}
    if flow == "combine":
        flow = "stream" if k <= col.ONEHOT_MAX_KEYS else "sort"
    if flow == "stream":
        for m, times in sizes:
            for name, nbytes in _fold_bytes(m, k, cols, fold_op).items():
                work[name] = work.get(name, 0.0) + times * nbytes
    elif flow == "sort":
        work["partition"] = work["segment"] = 0.0
        for m, times in sizes:
            part, seg = _sort_bytes(m, k, cols)
            work["partition"] += times * part
            work["segment"] += times * seg
    elif flow == "reduce":
        lmax = max_values_per_key or max(n // k, 1)
        # int64 keys and order through the stable sort; per window slot an
        # int64 index and the value read and written
        work["reduce"] = float(n * 8 * 4 + k * lmax * (8 + 2 * value_bytes))
    else:
        raise ValueError(f"unknown flow {flow!r}")
    return work


def _cuda_terms(work: dict[str, float]) -> list[tuple[str, float]]:
    c = CUDA_COEFF
    byte_s = 1.0 / roofline.H100_SXM_HBM_BYTES_PER_S
    terms = [("dispatch", c["dispatch"]),
             ("launch", c["chunk"] * work["chunk"])]
    terms += [(name, c[name] * work[name] * byte_s)
              for name in ("map", "fold_lane", "fold_table", "partition",
                           "segment", "reduce") if name in work]
    return terms


def estimate_flow_cost(
    flow: str,
    *,
    n_pairs: int,
    key_space: int,
    d: int = 1,
    value_bytes: int = 4,
    holder_bytes: int | None = None,
    chunk_pairs: int | None = None,
    max_values_per_key: int | None = None,
    backend: str = "cpu",
    skew_factor: float = 1.0,
    num_shards: int = 1,
    wire: str = "raw",
    shuffle_capacity: int | None = None,
    value_dtype: str = "int32",
    fold_op: str = "add",
) -> FlowCost:
    """Model one flow's cost for a workload (see the module docstring).

    ``skew_factor`` (>= 1.0) is the key distribution's imbalance: the
    shuffled flows (sort, reduce) scale by it, as in the reference.
    ``num_shards > 1`` adds the shuffled flows' wire term: the bytes a
    shard sends under the ``wire`` codec (``value_dtype`` the values',
    ``shuffle_capacity`` the send envelope) over the profile's link rate
    (:func:`link_bytes_per_s`).  ``fold_op`` is the ``cuda`` stream fold's
    monoid (add or max)."""
    if backend not in PROFILES:
        raise ValueError(f"unknown backend profile {backend!r}; the port "
                         f"has {sorted(PROFILES)}")
    n, k = max(int(n_pairs), 1), max(int(key_space), 1)
    lmax = max_values_per_key or max(n // k, 1)
    if backend == "cpu":
        chunk = chunk_pairs or n
        sort_levels = (sort_radix_passes(max(min(n, chunk), 1), k)
                       if flow == "sort" else 1)
        model_bytes = roofline.mapreduce_flow_bytes(
            flow, n_pairs=n, key_space=k, value_bytes=value_bytes,
            holder_bytes=holder_bytes, chunk_pairs=chunk,
            max_values_per_key=lmax, sort_levels=sort_levels)
        fused_combine = (n <= col.ADDITIVE_FOLD_PAIRS_FUSED
                         or k <= col.ONEHOT_MAX_KEYS)
        terms = _cpu_terms(flow, n=n, k=k, d=d, lmax=lmax,
                           chunk_pairs=chunk, fused_combine=fused_combine,
                           sort_passes=sort_levels)
    else:
        work = cuda_work(flow, n_pairs=n, key_space=k, d=d,
                         value_bytes=value_bytes, chunk_pairs=chunk_pairs,
                         max_values_per_key=lmax, fold_op=fold_op)
        model_bytes = roofline.mapreduce_flow_bytes(
            flow, n_pairs=n, key_space=k, value_bytes=value_bytes,
            holder_bytes=holder_bytes, chunk_pairs=chunk_pairs,
            max_values_per_key=lmax)
        terms = _cuda_terms(work)
    est = sum(v for _, v in terms)
    S = max(int(num_shards), 1)
    if S > 1 and flow in ("sort", "reduce"):
        # added before the skew scaling: a hot destination paces the
        # exchange as it paces the fold
        wire_s = roofline.shuffle_wire_bytes(
            wire, n_pairs=n, key_space=k, num_shards=S,
            value_bytes=value_bytes, value_dtype=value_dtype,
            capacity=shuffle_capacity) / link_bytes_per_s(backend)
        terms = list(terms) + [("wire", wire_s)]
        est += wire_s
    sf = max(float(skew_factor), 1.0)
    if sf > 1.0 and flow in ("sort", "reduce"):
        # the shuffled flows finish when their hottest shard does
        extra = est * (sf - 1.0)
        terms = list(terms) + [("skew", extra)]
        est += extra
    return FlowCost(flow=flow, est_s=est, model_bytes=model_bytes,
                    terms=tuple(terms))


def default_backend(device) -> str:
    """The profile of a run on ``device``: ``cuda`` for a CUDA device,
    ``cpu`` otherwise."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def choose_flow(
    *,
    n_pairs: int,
    key_space: int,
    d: int = 1,
    value_bytes: int = 4,
    holder_bytes: int | None = None,
    chunk_pairs: int | None = None,
    max_values_per_key: int | None = None,
    candidates: tuple[str, ...] = ("stream", "sort"),
    backend: str,
    skew_factor: float = 1.0,
    num_shards: int = 1,
    wire: str = "raw",
    shuffle_capacity: int | None = None,
    value_dtype: str = "int32",
    fold_op: str = "add",
) -> CostReport:
    """Rank ``candidates`` by modeled cost and pick the cheapest.

    ``backend`` names the profile (``default_backend(device)`` for a run's
    device).  The planner restricts ``candidates`` to the flows the
    derived combiner can run (no sort flow for coupled holders)."""
    costs = sorted(
        (estimate_flow_cost(f, n_pairs=n_pairs, key_space=key_space, d=d,
                            value_bytes=value_bytes,
                            holder_bytes=holder_bytes,
                            chunk_pairs=chunk_pairs,
                            max_values_per_key=max_values_per_key,
                            backend=backend, skew_factor=skew_factor,
                            num_shards=num_shards, wire=wire,
                            shuffle_capacity=shuffle_capacity,
                            value_dtype=value_dtype, fold_op=fold_op)
         for f in candidates),
        key=lambda fc: fc.est_s)
    return CostReport(chosen=costs[0].flow, n_pairs=n_pairs,
                      key_space=key_space, backend=backend,
                      costs=tuple(costs))


#: bytes per second of the ``cpu`` profile's pipeline handoff (the
#: reference's constant)
CPU_HANDOFF_BYTES_PER_S = 2.0e10


def pipeline_overhead_s(n_stages: int, *, handoff_bytes: float = 0.0,
                        fused: bool = True, backend: str) -> float:
    """The per-call overhead a pipeline's structure adds: a dispatch per
    program (one fused, one a stage unfused) and the handoff bytes
    (``roofline.pipeline_handoff_bytes`` summed over the edges).

    ``cpu`` is the reference's model: its fused program keeps the tables
    out of memory, so only the unfused form pays the bytes, at
    :data:`CPU_HANDOFF_BYTES_PER_S`.  ``cuda`` prices the port: a dispatch
    is the fitted host term of a run (``CUDA_COEFF["dispatch"]``), and the
    bytes go at the H100's HBM rate in both forms, since the fused path
    still writes and reads each table (ROADMAP C.33); pass the bytes of
    the path priced."""
    if backend not in PROFILES:
        raise ValueError(f"unknown backend profile {backend!r}; the port "
                         f"has {sorted(PROFILES)}")
    dispatches = 1 if fused else max(1, int(n_stages))
    if backend == "cpu":
        secs = dispatches * CPU_COEFF["dispatch"]
        if not fused and handoff_bytes:
            secs += float(handoff_bytes) / CPU_HANDOFF_BYTES_PER_S
        return secs
    return (dispatches * CUDA_COEFF["dispatch"]
            + float(handoff_bytes) / roofline.H100_SXM_HBM_BYTES_PER_S)
