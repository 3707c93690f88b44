"""First-order bytes models of the MapReduce flows.

Counterpart of the flow models in ``repro/roofline/analysis.py``:
:func:`mapreduce_flow_bytes`, :func:`mapreduce_flow_peak_bytes` and
:func:`stream_working_set_bytes` are the reference's arithmetic, and with an
explicit ``chunk_pairs`` they return its numbers exactly.  With
``chunk_pairs=None`` they take the port's own chunk on the card
(``core/autotune.CUDA_CHUNK_PAIRS``), not the reference engine's
defaults.

:func:`pipeline_handoff_bytes` and :func:`shuffle_wire_bytes` are the
reference's too (the latter from the port's ``distributed/wire.py``,
whose byte accounting equals the reference's).  The reference's HLO
parser is ``roofline/op_trace.py`` here, a trace of the port's own calls;
:func:`collective_stats` and :func:`analyze` read it as the reference's
read the compiled module.  :class:`Roofline` keeps the reference's fields
and terms, stated against an H100 SXM5 mesh's data-sheet rates (a model,
not a measurement); the dry-run fills it from one traced step under fake
tensors (:func:`analyze`).  :func:`model_flops_estimate` is the
reference's arithmetic.
"""

from __future__ import annotations

import dataclasses

#: HBM bandwidth of an H100 SXM (80 GB HBM3), bytes per second: the memory
#: rate the ``cuda`` cost profile states its byte terms against
H100_SXM_HBM_BYTES_PER_S = 3.35e12

#: dense bf16 tensor-core rate of an H100 SXM5, FLOP/s (NVIDIA's data
#: sheet, without sparsity, at the 700 W limit)
H100_SXM_BF16_FLOPS = 989.4e12

#: NVLink 4 of an H100 SXM5, bytes per second in each direction (NVIDIA's
#: data sheet: 900 GB/s both ways)
H100_SXM_NVLINK_BYTES_PER_S = 450e9

#: the link rate of the reference's roofline (``repro/roofline/analysis.py``
#: ``LINK_BW``), which its ``cpu`` cost profile divides the wire bytes by:
#: the reference's constant, kept so that the port's ``cpu`` plans equal
#: the reference's; no measurement of any machine the port runs on
REFERENCE_LINK_BYTES_PER_S = 50e9


def _default_chunk() -> int:
    from repro_torch.core.autotune import CUDA_CHUNK_PAIRS

    return CUDA_CHUNK_PAIRS


def mapreduce_flow_bytes(
    flow: str,
    *,
    n_pairs: int,
    key_space: int,
    value_bytes: int = 4,
    holder_bytes: int | None = None,
    chunk_pairs: int | None = None,
    key_block: int | None = None,
    max_values_per_key: int | None = None,
    sort_levels: int = 1,
) -> float:
    """First-order device-memory bytes of the four flows (the paper's
    Figs 8/9), each charged for what it materializes:

    * reduce  — writes and re-reads the pair stream around a sort (about 3
      passes of key + value), then gathers O(K·Lmax) padded windows.
    * combine — writes and re-reads the pair stream once, plus one table.
    * stream  — one pair chunk per step (written + read) and the carried
      O(K) tables re-touched (read + write) once per chunk; a key-blocked
      fold re-reads the chunk once per key block.
    * sort    — each chunk's pairs in and out once, the carried tables
      re-touched per chunk minus the first read, and one int32 key stream
      re-read and re-written per extra hierarchy level.
    """
    if chunk_pairs is None:
        chunk_pairs = _default_chunk()
    K, N = key_space, n_pairs
    pair = 4 + value_bytes  # int32 key + value
    hold = (holder_bytes if holder_bytes is not None else value_bytes) + 4
    table = K * hold  # holder tables + int32 counts
    if flow == "reduce":
        lmax = max_values_per_key or max(N // max(K, 1), 1)
        return 3.0 * N * pair + 2.0 * K * lmax * value_bytes + table
    if flow == "combine":
        return 2.0 * N * pair + table
    if flow == "stream":
        n_chunks = max(1, -(-N // max(chunk_pairs, 1)))
        chunk = min(N, chunk_pairs)
        n_blocks = 1
        if key_block is not None and 0 < key_block < K:
            n_blocks = -(-K // key_block)
        return (2.0 * n_chunks * chunk * pair * n_blocks
                + 2.0 * n_chunks * table)
    if flow == "sort":
        n_chunks = max(1, -(-N // max(chunk_pairs, 1)))
        return (2.0 * N * pair + (2.0 * n_chunks - 1.0) * table
                + (max(sort_levels, 1) - 1) * 2.0 * N * 4.0)
    raise ValueError(f"unknown flow {flow!r}")


def mapreduce_flow_peak_bytes(
    flow: str,
    *,
    n_pairs: int,
    key_space: int,
    value_bytes: int = 4,
    holder_bytes: int | None = None,
    chunk_pairs: int | None = None,
    key_block: int | None = None,
    max_values_per_key: int | None = None,
) -> float:
    """First-order peak residency: the stream and sort flows' peak is
    O(K + chunk_pairs) and independent of N; the combine and reduce flows
    grow with the whole pair stream."""
    if chunk_pairs is None:
        chunk_pairs = _default_chunk()
    K, N = key_space, n_pairs
    pair = 4 + value_bytes
    hold = (holder_bytes if holder_bytes is not None else value_bytes) + 4
    table = K * hold
    if flow == "reduce":
        lmax = max_values_per_key or max(N // max(K, 1), 1)
        return 2.0 * N * pair + K * lmax * value_bytes  # stream + sorted copy
    if flow == "combine":
        return N * pair + table
    if flow == "stream":
        del key_block  # blocking bounds the fold's working set, not the peak
        return min(N, chunk_pairs) * pair + table
    if flow == "sort":
        del key_block
        # chunk buffer + its partitioned copy + the carried tables
        return 2.0 * min(N, chunk_pairs) * pair + table
    raise ValueError(f"unknown flow {flow!r}")


def stream_working_set_bytes(
    *,
    chunk_pairs: int,
    key_block: int,
    d: int = 1,
    tile_n: int = 512,
    tile_d: int = 128,
) -> float:
    """Per-step residency of a key-blocked one-hot fold: the
    ``[key_block, tile_d]`` table block, the ``[tile_n, key_block]`` one-hot
    tile and the ``[tile_n, tile_d]`` value tile, all f32; ``d`` is the
    flattened holder width (channels + the counts column)."""
    tn = min(tile_n, max(chunk_pairs, 8))
    td = min(tile_d, max(d, 1))
    return 4.0 * (key_block * td + tn * key_block + tn * td)


def pipeline_handoff_bytes(key_space: int, *, value_bytes: int = 4,
                           dead_value: bool = False) -> float:
    """Device-memory bytes of one producer→consumer pipeline edge: the
    producer's dense ``[K]`` table of (int32 key, value, int32 count) rows
    written and read back, ``2 · K · row_bytes``; a dead value column
    (``StageSemantics.reads_value == False``) leaves the value out.  The
    reference's arithmetic.  In the port both of a pipeline's paths move
    the table (``core/pipeline.py``, ROADMAP C.33)."""
    row = 4 + 4 + (0 if dead_value else int(value_bytes))
    return 2.0 * float(key_space) * row


def shuffle_wire_bytes(codec: str = "raw", *, n_pairs: int, key_space: int,
                       num_shards: int, value_bytes: int = 4,
                       value_dtype: str = "int32",
                       capacity: int | None = None, plan=None) -> float:
    """Bytes a shard sends in one tiled all-to-all shuffle under a wire
    codec: the encoded tree's bytes (``wire.encoded_nbytes``, equal to the
    tree ``wire.encode`` makes) times ``(S - 1) / S``.  ``n_pairs`` is the
    global pair count, split evenly over the shards; ``capacity`` and
    ``plan`` follow the engine's capacity chain."""
    from repro_torch.distributed import wire as wirelib

    S = max(int(num_shards), 1)
    if S <= 1:
        return 0.0
    per = -(-max(int(n_pairs), 1) // S)
    itemsize = wirelib._itemsize(value_dtype)
    elems = max(1, int(value_bytes) // itemsize)

    class _Spec:  # one shard's value stream: [per, elems] of value_dtype
        shape = (per, elems)
        dtype = wirelib.dtype_name(value_dtype)

    fmt = wirelib.wire_format(
        key_space=int(key_space), num_shards=S, n_pairs=per,
        value_avals=_Spec(), codec=codec, capacity=capacity, plan=plan)
    return wirelib.wire_bytes_per_shard(fmt)


# ---------------------------------------------------------------------------
# LM cells: the reference's roofline terms, on H100 SXM5 data-sheet rates
# ---------------------------------------------------------------------------


def model_flops_estimate(cfg, shape_kind: str, seq: int, batch: int,
                         n_params: int, n_active: int) -> float:
    """6·N·D train; 2·N·D per generated token for decode/prefill."""
    del cfg, n_params
    tokens = seq * batch
    n = n_active
    if shape_kind == "train":
        return 6.0 * n * tokens
    if shape_kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * batch  # decode: one token per sequence


@dataclasses.dataclass
class Roofline:
    """One dry-run cell's terms, per chip: compute (FLOPs over the bf16
    peak), memory (bytes over HBM) and collective (wire bytes over one
    NVLink direction), each the data sheet's rate: a model of the mesh,
    not a measurement."""

    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float  # per chip
    bytes_accessed: float  # per chip
    collective_bytes: float  # wire bytes per chip
    collective_ops: dict
    model_flops: float  # 6·N·D (global), for the usefulness ratio
    peak_memory_bytes: float
    #: the traced call's ``op_trace.OpCost`` (:func:`analyze`), not part of
    #: the reference's fields
    cost: object = dataclasses.field(default=None, repr=False,
                                     compare=False)

    @property
    def compute_s(self) -> float:
        return self.flops / H100_SXM_BF16_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / H100_SXM_HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / H100_SXM_NVLINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step time: max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops × chips): remat/redundancy waste."""
        total = self.flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu(self) -> float:
        """Model-flops utilization at the roofline step time."""
        denom = self.step_s * self.chips * H100_SXM_BF16_FLOPS
        return self.model_flops / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes_per_chip": self.collective_bytes,
            "collective_ops": self.collective_ops,
            "model_flops": self.model_flops,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "step_s": self.step_s, "useful_ratio": self.useful_ratio,
            "mfu": self.mfu,
        }


def collective_stats(trace, default_group: int) -> tuple[float, dict]:
    """(wire bytes a chip, per-op ``{count, bytes}``) of a traced call
    (``op_trace.trace``): the counterpart of the reference's, which reads
    partitioned HLO.  ``default_group`` stands for a collective whose ranks
    the trace could not read."""
    from repro_torch.roofline import op_trace

    cost = op_trace.analyze_trace(trace, default_group=default_group)
    return cost.collective_bytes, cost.collective_ops


def analyze(fn, *, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, argument_bytes: float = 0.0) -> Roofline:
    """Roofline terms of one traced call of ``fn()`` a chip (the
    counterpart of the reference's ``analyze``, which reads the compiled
    module through ``hlo_parser``): FLOPs, bytes and wire bytes from
    ``op_trace.analyze_trace``, each op at its multiplicity (``repeat``,
    ``loop``), collectives of unknown ranks over ``chips``.  The peak is
    ``argument_bytes`` plus what the call allocated at most (the
    reference's argument + output + temp - alias, the state donated).
    ``Roofline.cost`` keeps the ``OpCost``, its ``warnings`` (first five)
    also in ``collective_ops["_warnings"]``."""
    from repro_torch.roofline import op_trace

    _, tr = op_trace.trace(fn)
    cost = op_trace.analyze_trace(tr, default_group=chips)
    per_op = {op: dict(v) for op, v in sorted(cost.collective_ops.items())}
    if cost.warnings:
        per_op["_warnings"] = cost.warnings[:5]
    return Roofline(arch=arch, shape=shape, mesh=mesh_name, chips=chips,
                    flops=cost.flops, bytes_accessed=cost.bytes_accessed,
                    collective_bytes=cost.collective_bytes,
                    collective_ops=per_op, model_flops=float(model_flops),
                    peak_memory_bytes=float(argument_bytes) + cost.peak_bytes,
                    cost=cost)
