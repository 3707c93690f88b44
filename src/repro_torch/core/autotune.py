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

``probe=True`` (``autotune_stream``) times the stream fold at chunk/2,
chunk and 2·chunk on the run's device and keeps the fastest: CUDA events
on the card (the median of 3 after a warm-up), ``perf_counter`` on the
CPU.  A measured choice is kept in the tune cache file named by
``REPRO_TORCH_TUNE_CACHE`` (JSON; unset: nothing persists), keyed on the
app's shapes, its combiner, the lowering and the device (on the card its
name and power limit), so a later process reads it instead of measuring.
Unlike the reference's probe, a candidate that fails raises: a failure
there is a kernel's, and would otherwise hide.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import collector as col
from repro_torch.core import plan_cache as pc

#: emitted pairs per stream chunk on the card
CUDA_CHUNK_PAIRS = 1 << 22
#: emitted pairs per stream chunk on the CPU (the reference's chunk cap)
CPU_CHUNK_PAIRS = 1 << 16
#: emitted pairs per sort chunk on the CPU (the reference's sort chunk)
CPU_SORT_CHUNK_PAIRS = 1 << 14
#: the tune cache file's path (JSON); unset: probes are not persisted
TUNE_CACHE_ENV = "REPRO_TORCH_TUNE_CACHE"
#: timed runs of one probe candidate, after one warm-up run
PROBE_RUNS = 3


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
    source: str  # "model" | "probe" | "cache" | "manual"
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
                    key_block: int | str | None = "auto",
                    probe: bool = False) -> StreamTiling:
    """Pick the stream-fold tiling for ``app`` under ``spec``.

    ``chunk_pairs`` / ``key_block`` take ints to pin either knob;
    ``key_block=None`` disables blocking.  ``probe=True`` measures the
    chunk (module docstring) on synthetic items shaped to fit the app's
    map."""
    pc.STATS.autotunes += 1
    notes: list[str] = []
    K = app.key_space
    kernel_additive = use_kernels and spec.kernel_additive_ok(app.value_spec)
    kernel_int = use_kernels and spec.kernel_int_additive_ok(app.value_spec)
    kernel_monoid = use_kernels and spec.kernel_monoid_ok(app.value_spec)
    manual_chunk = isinstance(chunk_pairs, int)
    chunk = _chunk(app, device, chunk_pairs, CPU_CHUNK_PAIRS)

    def pick_block(chunk_now: int) -> int:
        if key_block is None:
            return K
        if isinstance(key_block, int):
            return max(1, min(int(key_block), K))
        if kernel_additive or kernel_monoid:
            from repro_torch.kernels import ops

            return min(ops.auto_key_block(K), K)
        return col.choose_dense_key_block(K, chunk_now)

    blk = pick_block(chunk)
    measured = cached = False
    if probe and not manual_chunk:
        path = tune_cache_path()
        ckey = tune_cache_key(app, spec, use_kernels=use_kernels,
                              device=device)
        hit = pc.load_json(path).get(ckey) if path is not None else None
        if isinstance(hit, dict) and isinstance(hit.get("chunk_pairs"), int):
            chunk, cached = hit["chunk_pairs"], True
            notes.append(f"probe cache hit: chunk={chunk} "
                         f"({hit.get('t_us', 0.0):.0f}us/fold measured by a "
                         f"previous run)")
        else:
            chunk, t_us = _probe_chunk(
                app, spec, chunk, device=device, use_kernels=use_kernels,
                key_block=None if blk >= K else blk, notes=notes)
            measured = t_us is not None
            if measured and path is not None and pc.store_json(
                    path, ckey, {"chunk_pairs": int(chunk), "t_us": t_us}):
                notes.append(f"probe cache: stored chunk={chunk} under "
                             f"{path}")
        blk = pick_block(chunk)
    if key_block == "auto" and (kernel_additive or kernel_monoid):
        notes.append(f"fold kernels: {blk} keys per block, "
                     f"{-(-K // blk)} key block(s)")

    dense_ok = kernel_monoid or chunk * blk <= col.DENSE_FOLD_ELEMS_BUDGET
    mode = col.stream_mode(spec, dense_ok=dense_ok,
                           additive_ok=kernel_additive or kernel_int
                           or dense_ok)
    if spec.sum_lowerable and mode == "scatter":
        notes.append(f"FALLBACK: chunk_pairs={chunk} × key_block={blk} "
                     f"exceeds the dense fold budget; exact scatter fold")
    manual = manual_chunk and (key_block is None or isinstance(key_block, int))
    source = ("manual" if manual else "cache" if cached
              else "probe" if measured else "model")
    return StreamTiling(chunk_pairs=chunk, key_block=blk, key_space=K,
                        mode=mode, source=source, notes=tuple(notes))


# ---------------------------------------------------------------------------
# The measured probe and its tune cache
# ---------------------------------------------------------------------------


def tune_cache_path() -> str | None:
    """The tune cache file, or None when it is off."""
    p = os.environ.get(TUNE_CACHE_ENV, "").strip()
    return p or None


def tune_cache_key(app, spec, *, use_kernels: bool, device) -> str:
    """The tune cache's key: the app's shapes and combiner, the lowering,
    and the device; on the card its name and power limit as ``nvidia-smi``
    prints them (a measurement holds for that card at that limit)."""
    from repro_torch.device import card_identity

    vs = app.value_spec
    dev = torch.device(device)
    where = card_identity(dev) if dev.type == "cuda" else dev.type
    return "|".join([
        type(app).__name__, f"K={app.key_space}", f"cap={app.emit_capacity}",
        f"v={str(vs.dtype).replace('torch.', '')}{tuple(vs.shape)}",
        f"spec={spec.describe or spec.strategy}", f"kern={int(use_kernels)}",
        f"device={where}"])


def synthetic_items(app, n_items: int, device, rng=None):
    """Items for the probe that fit ``app.map``: the first of three shapes
    a one-item map accepts — the reference's ``[n, *value]`` rows, one
    ``(key, value)`` pair an item, or ``(keys[cap], values[cap])`` — with
    keys uniform in ``[0, K)``.  ``(None, why)`` when none fits."""
    from repro_torch.core import engine as eng

    rng = np.random.default_rng(0) if rng is None else rng
    vs, cap, K = app.value_spec, max(app.emit_capacity, 1), app.key_space

    def vals(*lead):
        shape = lead + tuple(vs.shape)
        if vs.dtype.is_floating_point:
            a = rng.standard_normal(shape).astype(np.float32)
        else:
            a = rng.integers(0, max(K, 2), size=shape)
        return torch.from_numpy(a).to(vs.dtype)

    def keys(*lead):
        return torch.from_numpy(rng.integers(0, K, size=lead)
                                .astype(np.int32))

    why = []
    for make in (lambda n: vals(n), lambda n: (keys(n), vals(n)),
                 lambda n: (keys(n, cap), vals(n, cap))):
        try:  # does one item fit the map?  (the boundary to user code)
            eng.map_phase(app, make(1), "cpu")
        except Exception as e:
            why.append(f"{type(e).__name__}: {e}")
            continue
        return pytree.tree_map(lambda a: a.to(device), make(n_items)), ""
    return None, "; ".join(why)


def _time_fold(fn, device) -> float:
    """Seconds of one ``fn()``: after a warm-up, the median of
    :data:`PROBE_RUNS` runs, by CUDA events on the card."""
    fn()
    times = []
    cuda = torch.device(device).type == "cuda"
    for _ in range(PROBE_RUNS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _probe_chunk(app, spec, chunk: int, *, device, use_kernels: bool,
                 key_block: int | None, notes: list,
                 probe_pairs: int | None = None) -> tuple[int, float | None]:
    """Time the stream fold at chunk/2, chunk and 2·chunk on synthetic
    items of ``probe_pairs`` pairs (default: twice the largest candidate)
    and keep the fastest: ``(chunk, µs of its fold)``, or ``(chunk, None)``
    when the synthetic items fit no shape the map takes (noted).  A run
    that fails raises."""
    from repro_torch.core import engine as eng

    pc.STATS.probes += 1
    cap = max(app.emit_capacity, 1)
    candidates = sorted({max(chunk // 2, cap), chunk, chunk * 2})
    pairs = probe_pairs if probe_pairs is not None else 2 * candidates[-1]
    items, why = synthetic_items(app, max(pairs // cap, 4), device)
    if items is None:
        notes.append(f"probe: the synthetic items fit no item shape of the "
                     f"app's map ({why}); keeping the model's choice")
        return chunk, None
    times = {}
    for c in candidates:
        def fold(c=c):
            with torch.no_grad():
                return eng.stream_local_tables(
                    app, spec, items, chunk_pairs=c, device=device,
                    use_kernels=use_kernels, key_block=key_block)
        times[c] = _time_fold(fold, device)
    best = min(candidates, key=lambda c: times[c])
    notes.append("probe: measured " + ", ".join(
        f"{c}: {times[c] * 1e6:.0f}us" for c in candidates)
        + f" -> chunk={best} ({times[best] * 1e6:.0f}us/fold)")
    return best, times[best] * 1e6


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
    source: str  # "model" | "manual"
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

    pc.STATS.autotunes += 1
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
                      else "model", notes=tuple(notes))
