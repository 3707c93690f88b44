"""The stream and sort flows' collectors: pair chunks folded into carried
holder tables.

Counterpart of the stream- and sort-flow parts of
``repro/core/collector.py`` (``PairStream``, ``Grouped``,
``finalize_tables``, ``stream_mode``, ``choose_dense_key_block``,
``StreamCombiner``, ``_sequential_fold``, ``stable_sort_by_key``,
``segmented_scan``, ``_run_aggregate``, ``SortCombiner`` and
``sort_flow``).
Keys are dense int32 ids in ``[0, key_space)``; an invalid emission carries
the sentinel ``key_space`` and never lands.

Every fold is deterministic on the card: float sums go through the one-hot
contraction, the ``onehot_fold`` or ``segment_reduce`` kernel (no float
atomics) or the difference of a sorted chunk's running sum (one result per
run end, written without accumulation), integer sums through ``index_add_``
in the table's own integer dtype (integer atomics give the same result in
any order), and max/min follow JAX's NaN and signed-zero rules.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core import combiner as C

#: largest chunk_pairs × key_block masked expansion (elements) the pure
#: PyTorch dense folds materialize per key block (64 MB at f32); the same
#: budget as the reference.
DENSE_FOLD_ELEMS_BUDGET = 1 << 24


class LoweringFallbackWarning(UserWarning):
    """A sum-lowerable combiner degraded to the exact scatter fold."""


@dataclasses.dataclass(frozen=True)
class PairStream:
    """Flat emitted pairs. keys[i] == key_space marks an invalid slot."""

    keys: torch.Tensor  # [N] int32 in [0, key_space]
    values: torch.Tensor  # [N, *value_shape]
    key_space: int

    @property
    def valid(self) -> torch.Tensor:
        return (self.keys >= 0) & (self.keys < self.key_space)


@dataclasses.dataclass(frozen=True)
class Grouped:
    """Result table over the dense key space."""

    keys: torch.Tensor  # [K] == arange(K)
    values: Any  # [K, *out_shape] (pytree)
    counts: torch.Tensor  # [K] int32; 0 == key never emitted


def finalize_tables(spec: C.CombinerSpec, tables, counts,
                    key_space: int) -> Grouped:
    keys = torch.arange(key_space, dtype=torch.int32, device=counts.device)
    vals = torch.func.vmap(spec.finalize)(keys, tables, counts)
    return Grouped(keys, vals, counts)


def stream_mode(spec: C.CombinerSpec, *, dense_ok: bool = True,
                additive_ok: bool | None = None) -> str:
    """Pick the per-chunk fold lowering (same rule as the reference)."""
    if additive_ok is None:
        additive_ok = dense_ok
    if spec.strategy == C.STRATEGY_SIZE:
        return "size"
    if spec.strategy == C.STRATEGY_FIRST:
        return "first"
    if spec.sum_lowerable and additive_ok:
        return "additive"
    if spec.scatter_lowerable:
        return "dense" if dense_ok else "scatter"
    return "sequential"


def pow2_floor(x: int) -> int:
    return 1 << (max(int(x), 1).bit_length() - 1)


def choose_dense_key_block(key_space: int, chunk_pairs: int | None, *,
                           budget: int = DENSE_FOLD_ELEMS_BUDGET) -> int:
    """Largest power-of-two key block whose ``chunk × block`` masked
    expansion fits ``budget``; ``key_space`` when no blocking is needed."""
    if chunk_pairs is None or chunk_pairs * key_space <= budget:
        return key_space
    return pow2_floor(max(budget // max(chunk_pairs, 1), 8))


def _counts(keys: torch.Tensor, valid: torch.Tensor,
            key_space: int) -> torch.Tensor:
    """[K] int32 number of valid pairs per key (exact).  ``bincount`` with
    invalid pairs in an extra bin: no host sync for a boolean index, and no
    atomics contended on a few hot keys (``index_add_`` took 0.9 ms per
    2^22-pair chunk at K=100 on the H100)."""
    binned = torch.where(valid, keys, key_space).to(torch.int64)
    return torch.bincount(binned, minlength=key_space + 1)[:key_space].to(
        torch.int32)


def _rows_f32(chan: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, D]`` dense f32 rows of a channel, as the fold kernels take
    them (a premap may hand back a view: a transpose, an expand)."""
    return chan.reshape(n, -1).to(torch.float32).contiguous()


def _sequential_fold(spec: C.CombinerSpec, tables, counts, keys, values):
    """Fold a pair stream into carried holder tables, one pair at a time:
    the correctness path of coupled holders (e.g. logsumexp) that have no
    leafwise monoid.  A Python loop over the pairs, reading each key on
    the host: slow, and used by no derived combiner."""
    k_space = counts.shape[0]
    leaves, treedef = pytree.tree_flatten(tables)
    leaves = [l.clone() for l in leaves]
    counts = counts.clone()
    mapped = spec.premap(values)
    for i, k in enumerate(keys.tolist()):
        if not 0 <= k < k_space:
            continue
        h = pytree.tree_unflatten([l[k] for l in leaves], treedef)
        h2 = spec.combine(h, pytree.tree_map(lambda c: c[i], mapped),
                          counts[k])
        for l, new in zip(leaves, pytree.tree_leaves(h2)):
            l[k] = new
        counts[k] += 1
    return pytree.tree_unflatten(leaves, treedef), counts


class CarriedTables:
    """The carried state of the stream and sort collectors, in one of three
    layouts chosen by the collector's ``mode`` and ``fused_acc``:

    * ``size``  — ``[K]`` int32 counts alone;
    * fused     — one f32 ``[K, ΣD + 1]`` accumulator, counts in the last
      column (f32 caps exact sums, and the counts, at 2^24 per key);
    * otherwise ``(holder tables, counts)``, tables ``[K, *leaf]``.
    """

    mode: str

    def __init__(self, spec: C.CombinerSpec, key_space: int,
                 value_spec: C.ValueSpec, device):
        self.spec = spec
        self.key_space = key_space
        self.value_spec = value_spec
        self.device = torch.device(device)
        self._holder_leaves, self._holder_treedef = pytree.tree_flatten(
            spec.init(value_spec))

    @property
    def fused_acc(self) -> bool:
        raise NotImplementedError

    def _widths(self) -> list[int]:
        return [l.numel() for l in self._holder_leaves]

    def init_state(self):
        if self.mode == "size":
            return torch.zeros(self.key_space, dtype=torch.int32,
                               device=self.device)
        if self.fused_acc:
            return torch.zeros((self.key_space, sum(self._widths()) + 1),
                               dtype=torch.float32, device=self.device)
        return self.spec.init_tables(self.key_space, self.value_spec,
                                     self.device)

    def tables_counts(self, state) -> tuple[Any, torch.Tensor]:
        """Un-finalized (tables, counts) from the carried state."""
        if self.mode == "size":
            return (), state
        if self.fused_acc:
            tabs, off = [], 0
            for leaf, size in zip(self._holder_leaves, self._widths()):
                tabs.append(state[:, off:off + size]
                            .reshape((self.key_space,) + tuple(leaf.shape))
                            .to(leaf.dtype))
                off += size
            tables = pytree.tree_unflatten(tabs, self._holder_treedef)
            return tables, state[:, -1].to(torch.int32)
        return state

    def finalize(self, state) -> Grouped:
        tables, counts = self.tables_counts(state)
        return finalize_tables(self.spec, tables, counts, self.key_space)


class StreamCombiner(CarriedTables):
    """Chunked fold of a pair stream into carried holder tables.

    The engine loops over map chunks and calls :meth:`fold_chunk` on each,
    so the emitted-pair buffer only exists one chunk at a time.  Per-chunk
    lowerings, as in the reference:

    * additive   — float holders with ``fold_fn`` (the ``onehot_fold``
      kernel) fold into ONE fused f32 accumulator ``[K, ΣD + 1]`` whose last
      column counts the pairs; otherwise one fold per holder leaf: the
      one-hot contraction for float leaves, ``index_add_`` for integer ones.
    * dense      — max/min/mul/bool per leaf: ``monoid_fold_fn`` (the
      ``chunk_monoid_fold`` kernel) for f32 add/max/min leaves, else an
      identity-masked reduction one key block at a time.
    * first      — first occurrence per key, kept while the count is 0.
    * size       — counts only.
    * scatter    — exact monoid scatters, where the dense expansion would
      not fit :data:`DENSE_FOLD_ELEMS_BUDGET` even at the smallest block.
    * sequential — one pair at a time (coupled holders).

    ``key_block`` bounds the dense expansions (and is the kernels' keys per
    block); ``None`` means unblocked.  ``mode`` forces a lowering.
    """

    def __init__(self, spec: C.CombinerSpec, key_space: int,
                 value_spec: C.ValueSpec, *, device,
                 fold_fn: Callable | None = None,
                 monoid_fold_fn: Callable | None = None,
                 chunk_pairs: int | None = None,
                 key_block: int | None = None, mode: str | None = None):
        super().__init__(spec, key_space, value_spec, device)
        self.fold_fn = fold_fn
        self.monoid_fold_fn = monoid_fold_fn
        if key_block is not None:
            key_block = max(1, min(int(key_block), key_space))
            if key_block == key_space:
                key_block = None  # single block == unblocked
        self.key_block = key_block
        eff_block = key_block if key_block is not None else key_space
        kernel_additive = (fold_fn is not None
                           and spec.kernel_additive_ok(value_spec))
        kernel_monoid = (monoid_fold_fn is not None
                         and spec.kernel_monoid_ok(value_spec))
        self._dense_ok = (kernel_monoid or chunk_pairs is None or
                          chunk_pairs * eff_block <= DENSE_FOLD_ELEMS_BUDGET)
        additive_ok = kernel_additive or self._dense_ok
        self.mode = (mode if mode is not None else
                     stream_mode(spec, dense_ok=self._dense_ok,
                                 additive_ok=additive_ok))
        if mode is None and spec.sum_lowerable and self.mode == "scatter":
            warnings.warn(
                f"stream flow: dense fold budget exceeded at key_space="
                f"{key_space}, chunk_pairs={chunk_pairs}, key_block="
                f"{eff_block}; degrading to the exact scatter fold",
                LoweringFallbackWarning, stacklevel=2)

    @property
    def fused_acc(self) -> bool:
        """One f32 ``[K, ΣD + 1]`` accumulator (last column: counts).
        Float holders only: f32 caps exact integer sums, and the counts
        column, at 2^24 per key."""
        return (self.mode == "additive" and self.fold_fn is not None
                and all(l.is_floating_point() for l in self._holder_leaves))

    # -- per-chunk folds -----------------------------------------------------

    def _block_ranges(self):
        kb = self.key_block or self.key_space
        return [(lo, min(lo + kb, self.key_space))
                for lo in range(0, self.key_space, kb)]

    def _sum_fold(self, keys, flat):
        """[K, D] f32 per-key sums of ``flat`` rows (deterministic)."""
        zeros = torch.zeros((self.key_space, flat.shape[1]),
                            dtype=torch.float32, device=flat.device)
        if self.fold_fn is not None:
            return self.fold_fn(keys, flat, zeros)
        from repro_torch.kernels.onehot_combine import onehot_fold_plain

        return onehot_fold_plain(keys, flat, zeros, block_k=self.key_block)

    def fold_chunk(self, state, stream: PairStream):
        assert stream.key_space == self.key_space
        valid = stream.valid
        if self.mode == "size":
            return state + _counts(stream.keys, valid, self.key_space)
        if self.fused_acc:
            n = stream.keys.shape[0]
            cols = [l.reshape(n, -1).to(torch.float32) for l in
                    pytree.tree_leaves(self.spec.premap(stream.values))]
            cols.append(valid.to(torch.float32)[:, None])  # counts column
            return self.fold_fn(stream.keys, torch.cat(cols, dim=1), state)
        tables, counts = state
        if self.mode == "sequential":
            return _sequential_fold(self.spec, tables, counts, stream.keys,
                                    stream.values)
        new_counts = counts + _counts(stream.keys, valid, self.key_space)
        if self.mode == "additive":
            return self._fold_additive(tables, stream, valid), new_counts
        if self.mode == "dense":
            return self._fold_dense(tables, stream), new_counts
        if self.mode == "scatter":
            return self._fold_scatter(tables, stream), new_counts
        return self._fold_first(tables, counts, stream, valid), new_counts

    def _leaves(self, tables, stream):
        return (pytree.tree_leaves(tables),
                pytree.tree_leaves(self.spec.premap(stream.values)))

    def _fold_additive(self, tables, stream, valid):
        # integer leaves: exact index_add_ in the table's own dtype; float
        # leaves: the one-hot contraction (or onehot_fold), in f32
        n = stream.keys.shape[0]
        out = []
        for tab, chan in zip(*self._leaves(tables, stream)):
            if tab.is_floating_point():
                delta = self._sum_fold(stream.keys,
                                       _rows_f32(chan, n))
                out.append(tab + delta.reshape(tab.shape).to(tab.dtype))
            else:  # invalid pairs add 0 to row 0: exact, and no host sync
                vmask = valid.reshape((n,) + (1,) * (chan.ndim - 1))
                out.append(tab.index_add(
                    0, torch.where(valid, stream.keys, 0).to(torch.int64),
                    torch.where(vmask, chan, 0).to(tab.dtype)))
        return pytree.tree_unflatten(out, self._holder_treedef)

    def _fold_dense(self, tables, stream):
        tabs, chans = self._leaves(tables, stream)
        keys = stream.keys
        out = []
        for mono, tab, chan in zip(self.spec.monoids, tabs, chans):
            n = chan.shape[0]
            if (self.monoid_fold_fn is not None
                    and tab.dtype == torch.float32
                    and mono.name in ("add", "max", "min")):
                red = self.monoid_fold_fn(
                    keys, _rows_f32(chan, n),
                    tab.reshape(self.key_space, -1), mono.name)
                out.append(red.reshape(tab.shape).to(tab.dtype))
                continue
            ident = mono.identity(chan.dtype)
            blocks = []
            for lo, hi in self._block_ranges():
                iota = torch.arange(lo, hi, device=keys.device)
                hits = keys.long()[:, None] == iota[None, :]
                hits = hits.reshape(hits.shape + (1,) * (chan.ndim - 1))
                masked = torch.where(hits, chan[:, None],
                                     torch.tensor(ident, dtype=chan.dtype,
                                                  device=chan.device))
                blocks.append(mono.dense_reduce(masked, 0))
            out.append(mono.op(tab, torch.cat(blocks).to(tab.dtype)))
        return pytree.tree_unflatten(out, self._holder_treedef)

    def _fold_scatter(self, tables, stream):
        out = [mono.scatter(tab, stream.keys, chan)
               for mono, tab, chan in zip(self.spec.monoids,
                                          *self._leaves(tables, stream))]
        return pytree.tree_unflatten(out, self._holder_treedef)

    def _fold_first(self, tables, counts, stream, valid):
        n = stream.keys.shape[0]
        pos = torch.arange(n, device=stream.keys.device)
        # invalid pairs go to an extra row, cut off: no boolean index
        first_pos = torch.full((self.key_space + 1,), n, dtype=torch.int64,
                               device=stream.keys.device).scatter_reduce(
            0, torch.where(valid, stream.keys, self.key_space).long(), pos,
            "amin", include_self=True)[:self.key_space]
        fresh = (first_pos < n) & (counts == 0)
        safe = first_pos.clamp(max=max(n - 1, 0))
        out = []
        for tab, chan in zip(*self._leaves(tables, stream)):
            sel = fresh.reshape((self.key_space,) + (1,) * (chan.ndim - 1))
            out.append(torch.where(sel, chan[safe].to(tab.dtype), tab))
        return pytree.tree_unflatten(out, self._holder_treedef)


# ---------------------------------------------------------------------------
# Sort flow (radix-bucketed segment reduce)
# ---------------------------------------------------------------------------


def stable_sort_by_key(keys: torch.Tensor, key_space: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sorted_keys, order)`` of a stable sort; keys outside
    ``[0, key_space)`` become the sentinel ``key_space`` and sort last."""
    keys = torch.where((keys >= 0) & (keys < key_space), keys, key_space)
    sk, order = torch.sort(keys, stable=True)
    return sk, order


def segmented_scan(op: Callable, flags: torch.Tensor, vals: torch.Tensor
                   ) -> torch.Tensor:
    """Inclusive segmented scan: ``op``-accumulate, restarting at ``flags``.

    ``(fa, va) ⊕ (fb, vb) = (fa|fb, vb if fb else op(va, vb))`` applied at
    doubling offsets: log2(N) vectorized passes, no serial dependency."""
    f, v = flags.clone(), vals.clone()
    n, off = f.shape[0], 1
    while off < n:
        fb = f[off:].reshape((n - off,) + (1,) * (v.ndim - 1))
        v = torch.cat([v[:off], torch.where(fb, v[off:], op(v[:-off],
                                                              v[off:]))])
        f = torch.cat([f[:off], f[off:] | f[:-off]])
        off *= 2
    return v


def _run_aggregate(mono: C.Monoid, flat: torch.Tensor, is_start: torch.Tensor,
                   start_pos: torch.Tensor) -> torch.Tensor:
    """Per-run ``mono`` aggregate of a key-sorted channel, valid at run ends.

    Additive monoids take the cumsum difference (float channels in float64,
    so a long chunk keeps a short run's low bits; the reference differences
    in the channel's own float type); the rest :func:`segmented_scan`."""
    if mono.is_additive:
        wide = torch.float64 if flat.is_floating_point() else torch.int64
        csum = torch.cumsum(flat.to(wide), dim=0)
        prev = csum[(start_pos - 1).clamp(min=0)]
        prev = torch.where((start_pos > 0).reshape(
            (-1,) + (1,) * (flat.ndim - 1)), prev, torch.zeros_like(prev))
        return (csum - prev).to(flat.dtype)
    return segmented_scan(mono.op, is_start, flat)


def _at_keys(tgt: torch.Tensor, rows: torch.Tensor,
             key_space: int) -> torch.Tensor:
    """``[K, ...]`` rows holding ``rows[i]`` at key ``tgt[i]`` and zero
    elsewhere; a ``tgt`` of ``key_space`` is dropped.  Each key appears at
    most once (one run end, or start, per key), so this is a copy, not an
    accumulation: exact and the same on every run."""
    out = torch.zeros((key_space + 1,) + tuple(rows.shape[1:]),
                      dtype=rows.dtype, device=rows.device)
    return out.index_copy_(0, tgt.to(torch.int64), rows)[:key_space]


def sort_mode(spec: C.CombinerSpec) -> str:
    """The sort fold's lowering for ``spec`` (same rule as the reference)."""
    if spec.strategy == C.STRATEGY_SIZE:
        return "size"
    if spec.strategy == C.STRATEGY_FIRST:
        return "first"
    return "monoid" if spec.scatter_lowerable else "sequential"


class SortCombiner(CarriedTables):
    """Chunked sort-based fold: partition by key, reduce presorted runs.

    The sort flow (``flow="sort"``).  Per chunk, on the kernel path
    (``sort_fold_fn``, f32 add/max/min holders): the radix partition into
    padded leaf-bucket regions, one ``segment_reduce`` per holder leaf and
    the merge into the carried tables (``ops.sort_segment_fold``); the
    counts column rides with the first additive leaf, and specs with no
    additive leaf pay one more fold for the counts.  Elsewhere the chunk is
    sorted with ``torch.sort(stable=True)`` (the reference sorts with
    ``lax.sort`` there, outside any kernel), and one aggregate per run is
    merged into the tables at the run's key.  Modes:

    * ``monoid``     — run aggregates (cumsum difference for sums, a
      segmented scan otherwise) merged with each leaf's monoid scatter; an
      all-additive float spec off the kernel path carries ONE fused f32
      ``[K, ΣD + 1]`` accumulator whose last column counts the pairs;
    * ``first``      — the run start (the first-arrived pair, since the
      sort is stable), kept only where the carried count is still 0;
    * ``size``       — run lengths only;
    * ``sequential`` — coupled holders: the sorted pairs one at a time.

    Same interface as :class:`StreamCombiner` (init_state / fold_chunk /
    tables_counts / finalize), so the engine's chunk loop is shared.
    """

    def __init__(self, spec: C.CombinerSpec, key_space: int,
                 value_spec: C.ValueSpec, *, device,
                 sort_fold_fn: Callable | None = None):
        super().__init__(spec, key_space, value_spec, device)
        self.mode = sort_mode(spec)
        # the kernel pipeline accumulates f32 and takes add/max/min
        self.use_kernel = (sort_fold_fn is not None
                           and self.mode == "monoid"
                           and spec.kernel_monoid_ok(value_spec))
        self.sort_fold_fn = sort_fold_fn

    @property
    def fused_acc(self) -> bool:
        """The fused accumulator, off the kernel path, for all-additive
        float holders (as in the reference)."""
        return (self.mode == "monoid" and not self.use_kernel
                and self.spec.sum_lowerable
                and all(l.is_floating_point() for l in self._holder_leaves))

    # -- per-chunk fold ------------------------------------------------------

    def _run_layout(self, sk: torch.Tensor):
        """(is_start, start_pos, run_len, end_target, start_target) of the
        sorted runs; the targets are the run's key at its end (start) and
        the sentinel elsewhere, and sentinel runs drop themselves."""
        n = sk.shape[0]
        pos = torch.arange(n, device=sk.device)
        change = sk[1:] != sk[:-1]
        one = torch.ones(1, dtype=torch.bool, device=sk.device)
        is_start = torch.cat([one, change])
        is_end = torch.cat([change, one])
        start_pos = torch.cummax(torch.where(is_start, pos, 0), dim=0).values
        run_len = (pos - start_pos + 1).to(torch.int32)
        end_tgt = torch.where(is_end, sk, self.key_space)
        start_tgt = torch.where(is_start, sk, self.key_space)
        return is_start, start_pos, run_len, end_tgt, start_tgt

    def fold_chunk(self, state, stream: PairStream):
        assert stream.key_space == self.key_space
        n = stream.keys.shape[0]
        if n == 0:
            return state
        if self.use_kernel:
            return self._fold_kernel(state, stream)
        K = self.key_space
        sk, order = stable_sort_by_key(stream.keys, K)
        is_start, start_pos, run_len, tgt, start_tgt = self._run_layout(sk)
        if self.mode == "size":
            return state + _at_keys(tgt, run_len, K)
        svals = pytree.tree_map(lambda v: v[order], stream.values)
        if self.fused_acc:
            cols = [l.reshape(n, -1).to(torch.float32) for l in
                    pytree.tree_leaves(self.spec.premap(svals))]
            cols.append((sk < K).to(torch.float32)[:, None])  # counts
            agg = _run_aggregate(C.ADD, torch.cat(cols, dim=1), is_start,
                                 start_pos)
            return state + _at_keys(tgt, agg, K)
        tables, counts = state
        if self.mode == "sequential":
            return _sequential_fold(self.spec, tables, counts, sk, svals)
        mapped = pytree.tree_leaves(self.spec.premap(svals))
        cnt_delta = _at_keys(tgt, run_len, K)
        if self.mode == "first":
            fresh = (counts == 0) & (cnt_delta > 0)
            out = []
            for tab, chan in zip(pytree.tree_leaves(tables), mapped):
                cand = _at_keys(start_tgt, chan.to(tab.dtype), K)
                sel = fresh.reshape((K,) + (1,) * (chan.ndim - 1))
                out.append(torch.where(sel, cand, tab))
            return (pytree.tree_unflatten(out, self._holder_treedef),
                    counts + cnt_delta)
        out = []
        for mono, tab, chan in zip(self.spec.monoids,
                                   pytree.tree_leaves(tables), mapped):
            acc_dt = (tab.dtype if not tab.is_floating_point()
                      else torch.float32)
            agg = _run_aggregate(mono, chan.to(acc_dt), is_start, start_pos)
            out.append(mono.scatter(tab, tgt, agg.to(tab.dtype)))
        return (pytree.tree_unflatten(out, self._holder_treedef),
                counts + cnt_delta)

    def _fold_kernel(self, state, stream: PairStream):
        """Radix partition + segment_reduce per holder leaf.  The counts
        column rides with the first additive leaf (one partition serves the
        channel and the counts); an all-max/min spec folds the counts
        separately."""
        tables, counts = state
        n = stream.keys.shape[0]
        mapped = pytree.tree_leaves(self.spec.premap(stream.values))
        ones = stream.valid.to(torch.float32)[:, None]
        out = []
        new_counts = None
        for mono, tab, chan in zip(self.spec.monoids,
                                   pytree.tree_leaves(tables), mapped):
            flat = _rows_f32(chan, n)
            acc = tab.reshape(self.key_space, -1)
            if mono.name == "add" and new_counts is None:
                flat = torch.cat([flat, ones], dim=1)
                acc = torch.cat([acc, counts.to(torch.float32)[:, None]],
                                dim=1)
                red = self.sort_fold_fn(stream.keys, flat, acc, "add")
                new_counts = red[:, -1].to(torch.int32)
                red = red[:, :-1]
            else:
                red = self.sort_fold_fn(stream.keys, flat, acc.contiguous(),
                                        mono.name)
            out.append(red.reshape(tab.shape).to(tab.dtype))
        if new_counts is None:
            new_counts = self.sort_fold_fn(
                stream.keys, ones, counts.to(torch.float32)[:, None],
                "add")[:, 0].to(torch.int32)
        return pytree.tree_unflatten(out, self._holder_treedef), new_counts


def sort_flow(spec: C.CombinerSpec, stream: PairStream, *,
              sort_fold_fn: Callable | None = None) -> Grouped:
    """Single-shot sort flow: one chunk through :class:`SortCombiner`, on
    the stream's device."""
    value_spec = C.ValueSpec(tuple(stream.values.shape[1:]),
                             stream.values.dtype)
    sc = SortCombiner(spec, stream.key_space, value_spec,
                      device=stream.keys.device, sort_fold_fn=sort_fold_fn)
    return sc.finalize(sc.fold_chunk(sc.init_state(), stream))
