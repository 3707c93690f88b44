"""Tiling of the stream and sort flows: chunk size, key block or radix
levels, and fold lowering.

Counterpart of ``repro/core/autotune.py::autotune_stream`` and
``autotune_sort``.  The reference sized chunks against its roofline model,
XLA's fused-contraction regime (2048 pairs per fold) and a ``lax.scan``
(2^14 pairs per sort chunk).  The port's chunk loop is a Python loop with a
few launches per chunk, so on the card a chunk holds
:data:`CUDA_CHUNK_PAIRS` pairs in either flow: 2^22 pairs of a 3-float
KMeans value are 64 MB, far above the launch overhead and far below device
memory.  The decision is recorded on the plan (``explain()``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import collector as col

#: emitted pairs per stream chunk on the card
CUDA_CHUNK_PAIRS = 1 << 22
#: emitted pairs per stream chunk on the CPU (the reference's chunk cap)
CPU_CHUNK_PAIRS = 1 << 16
#: emitted pairs per sort chunk on the CPU (the reference's sort chunk)
CPU_SORT_CHUNK_PAIRS = 1 << 14


def _chunk(app, device, chunk_pairs, cpu_default: int) -> int:
    if isinstance(chunk_pairs, int):
        chunk = int(chunk_pairs)
    else:
        chunk = (CUDA_CHUNK_PAIRS if torch.device(device).type == "cuda"
                 else cpu_default)
    return max(chunk, app.emit_capacity, 1)


@dataclasses.dataclass(frozen=True)
class StreamTiling:
    """The tiling decision, carried on the ExecutionPlan."""

    chunk_pairs: int
    key_block: int  # == key_space -> single block (unblocked)
    key_space: int
    mode: str  # the stream fold lowering (collector.stream_mode)
    source: str  # "auto" | "manual"
    notes: tuple[str, ...] = ()

    @property
    def n_key_blocks(self) -> int:
        return -(-self.key_space // self.key_block)

    @property
    def blocked(self) -> bool:
        return self.key_block < self.key_space

    def describe(self) -> str:
        blk = (f"key_block={self.key_block}×{self.n_key_blocks}"
               if self.blocked else f"key_block={self.key_block} (single)")
        return (f"chunk_pairs={self.chunk_pairs} {blk} mode={self.mode} "
                f"[{self.source}]")


def autotune_stream(app, spec, *, device, use_kernels: bool = False,
                    chunk_pairs: int | str = "auto",
                    key_block: int | str | None = "auto") -> StreamTiling:
    """Pick the stream-fold tiling for ``app`` under ``spec``.

    ``chunk_pairs`` / ``key_block`` take ints to pin either knob;
    ``key_block=None`` disables blocking."""
    notes: list[str] = []
    K = app.key_space
    kernel_additive = use_kernels and spec.kernel_additive_ok(app.value_spec)
    kernel_monoid = use_kernels and spec.kernel_monoid_ok(app.value_spec)
    manual_chunk = isinstance(chunk_pairs, int)
    chunk = _chunk(app, device, chunk_pairs, CPU_CHUNK_PAIRS)

    if key_block is None:
        blk = K
    elif isinstance(key_block, int):
        blk = max(1, min(int(key_block), K))
    elif kernel_additive or kernel_monoid:
        from repro_torch.kernels import ops

        blk = min(ops.auto_key_block(K), K)
        notes.append(f"fold kernels: {blk} keys per block, "
                     f"{-(-K // blk)} key block(s)")
    else:
        blk = col.choose_dense_key_block(K, chunk)

    dense_ok = kernel_monoid or chunk * blk <= col.DENSE_FOLD_ELEMS_BUDGET
    mode = col.stream_mode(spec, dense_ok=dense_ok,
                           additive_ok=kernel_additive or dense_ok)
    if spec.sum_lowerable and mode == "scatter":
        notes.append(f"FALLBACK: chunk_pairs={chunk} × key_block={blk} "
                     f"exceeds the dense fold budget; exact scatter fold")
    manual = manual_chunk and (key_block is None or isinstance(key_block, int))
    return StreamTiling(chunk_pairs=chunk, key_block=blk, key_space=K,
                        mode=mode, source="manual" if manual else "auto",
                        notes=tuple(notes))


@dataclasses.dataclass(frozen=True)
class SortTiling:
    """The sort flow's tiling: chunk size and the radix level plan."""

    chunk_pairs: int
    key_block: int  # the leaf bucket (== key_space: one bucket)
    key_space: int
    level_fanouts: tuple[int, ...]
    feasible: bool  # whether the kernel pipeline has a plan
    sort_mode: str  # the SortCombiner mode (monoid/first/size/sequential)
    use_kernel: bool  # whether the chunks go through the radix kernels
    source: str  # "auto" | "manual"
    notes: tuple[str, ...] = ()

    @property
    def levels(self) -> int:
        return len(self.level_fanouts)

    @property
    def n_buckets(self) -> int:
        return -(-self.key_space // self.key_block)

    def describe(self) -> str:
        if not self.feasible:
            radix = "radix plan INFEASIBLE"
        elif self.level_fanouts:
            fan = "·".join(str(b) for b in self.level_fanouts)
            radix = (f"buckets={self.n_buckets}×{self.key_block}keys "
                     f"levels={self.levels}({fan})")
        else:
            radix = "buckets=1 levels=0"
        fold = "radix kernels" if self.use_kernel else "sorted runs"
        return (f"chunk_pairs={self.chunk_pairs} {radix} mode=sort "
                f"({self.sort_mode}, {fold}) [{self.source}]")


def autotune_sort(app, spec, *, device, use_kernels: bool = False,
                  chunk_pairs: int | str = "auto") -> SortTiling:
    """Pick the sort-flow tiling for ``app`` under ``spec``: the chunk and
    the radix level plan (``ops.plan_radix_levels``: the leaf bucket and the
    per-level fan-outs) that the kernel pipeline partitions with.  A key
    space past the level budget is noted here; the run raises if it asks
    for the kernels."""
    from repro_torch.kernels import ops

    notes: list[str] = []
    K = app.key_space
    chunk = _chunk(app, device, chunk_pairs, CPU_SORT_CHUNK_PAIRS)
    d, _ = spec.holder_width(app.value_spec)
    plan = ops.plan_radix_levels(K, d=d + 1)
    sort_mode = col.sort_mode(spec)
    use_kernel = (use_kernels and sort_mode == "monoid"
                  and spec.kernel_monoid_ok(app.value_spec))
    if not plan.feasible:
        notes.append(f"LEVEL BUDGET: {plan.reason}; the radix kernels have "
                     f"no plan (a run with use_kernels raises)")
    elif plan.levels > 1:
        notes.append(f"hierarchical radix partition: {plan.describe()} — "
                     f"each level's fan-out at most {ops.MAX_RADIX_FANOUT}")
    if use_kernel:
        notes.append("fold: radix_partition"
                     + ("_multi" if plan.levels > 1 else "")
                     + " + segment_reduce per holder leaf, the counts "
                       "column with the first additive leaf")
    else:
        notes.append("fold: one stable torch.sort per chunk, one aggregate "
                     "per run merged at its key")
    return SortTiling(chunk_pairs=chunk, key_block=plan.bucket_size,
                      key_space=K, level_fanouts=plan.fanouts,
                      feasible=plan.feasible, sort_mode=sort_mode,
                      use_kernel=use_kernel,
                      source="manual" if isinstance(chunk_pairs, int)
                      else "auto", notes=tuple(notes))
