"""The collectors of the four flows.

Counterpart of ``repro/core/collector.py``:

* stream and sort flows — pair chunks folded into carried holder tables
  (``PairStream``, ``Grouped``, ``finalize_tables``, ``stream_mode``,
  ``choose_dense_key_block``, ``StreamCombiner``, ``_sequential_fold``,
  ``stable_sort_by_key``, ``segmented_scan``, ``_run_aggregate``,
  ``SortCombiner``, ``sort_flow``);
* combine flow — the whole pair buffer folded into fresh holder tables in
  one pass (``combine_flow`` with its ``onehot``, ``scatter``, ``first``
  and ``segment`` lowerings);
* reduce flow — the paper's baseline: the pairs sorted, grouped into
  padded windows and handed to the user's ``reduce`` (``reduce_flow``).

Keys are dense int32 ids in ``[0, key_space)``; an invalid emission carries
the sentinel ``key_space`` and never lands.

Every fold is deterministic on the card: float sums go through the one-hot
contraction, the ``onehot_fold``, ``onehot_combine``, ``combine_scatter`` or
``segment_reduce`` kernel (no float atomics), a sorted ``index_put_``, or
the difference of a sorted chunk's running sum (one result per run end,
written without accumulation), integer sums and pair counts through the
``int_fold`` kernel (integer atomics give the same result in any order) or
``index_add_`` in the table's own integer dtype, and max/min follow JAX's
NaN and signed-zero rules.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch import spans
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


def _add_counts(keys: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """``counts`` ([K] int32) plus the pairs of each key in ``[0, K)``,
    exact: ``ops.int_fold`` with no value columns (on the card one pass and
    no host sync; on the CPU ``bincount``)."""
    from repro_torch.kernels import ops

    empty = torch.empty((counts.shape[0], 0), dtype=torch.int64,
                        device=counts.device)
    return ops.int_fold(keys, keys.new_empty((keys.shape[0], 0)), empty,
                        counts)[1]


def _counts(keys: torch.Tensor, key_space: int) -> torch.Tensor:
    """[K] int32 number of pairs per key in ``[0, K)`` (exact)."""
    return _add_counts(keys, torch.zeros((key_space,), dtype=torch.int32,
                                         device=keys.device))


def _int_rows(chan: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, D]`` dense rows of an integer channel as ``int_fold`` takes
    them: int32 and int64 as they are, narrower integers widened to
    int32."""
    rows = chan.reshape(n, -1)
    if rows.dtype not in (torch.int32, torch.int64):
        rows = rows.to(torch.int32)
    return rows.contiguous()


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
        #: the identity holder's leaves on the device, copied there once
        self._identity: list[torch.Tensor] | None = None

    #: whether ``fold_chunk`` may write into the state it is given
    folds_in_place = False

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
        # ``spec.init_tables``, from the identity's copy on the device: after
        # the first state, a state's init copies nothing from the host (no
        # host sync, and a CUDA graph can capture it)
        if self._identity is None:
            self._identity = [l.to(self.device) for l in self._holder_leaves]
        tables = pytree.tree_unflatten(
            [l.expand((self.key_space,) + tuple(l.shape)).clone()
             for l in self._identity], self._holder_treedef)
        counts = torch.zeros((self.key_space,), dtype=torch.int32,
                             device=self.device)
        return tables, counts

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
      column counts the pairs: ``fold_fn(keys, rows, acc, counts=True)``
      takes the ``[n, ΣD]`` value rows and folds that column from the keys
      alone; otherwise one fold per holder leaf: the one-hot contraction
      for float leaves, ``int_fold`` for integer ones (with the counts in
      the same launch).  With ``fold_fn`` an all-integer sum is exempt from
      the dense budget, as the fused accumulator is: ``int_fold`` expands
      no one-hot.
    * dense      — max/min/mul/bool per leaf: ``monoid_fold_fn`` (the
      ``chunk_monoid_fold`` kernel) for f32 add/max/min leaves, else an
      identity-masked reduction one key block at a time.
    * first      — first occurrence per key, kept while the count is 0.
    * size       — counts only (``int_fold``, no value columns).
    * scatter    — exact monoid scatters, where the dense expansion would
      not fit :data:`DENSE_FOLD_ELEMS_BUDGET` even at the smallest block.
    * sequential — one pair at a time (coupled holders).

    Every lowering but the fused and the sequential ones counts the pairs
    with ``int_fold``.

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
        # integer sums fold through int_fold, which expands no one-hot
        kernel_int = (fold_fn is not None
                      and spec.kernel_int_additive_ok(value_spec))
        kernel_monoid = (monoid_fold_fn is not None
                         and spec.kernel_monoid_ok(value_spec))
        self._dense_ok = (kernel_monoid or chunk_pairs is None or
                          chunk_pairs * eff_block <= DENSE_FOLD_ELEMS_BUDGET)
        additive_ok = kernel_additive or kernel_int or self._dense_ok
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

    folds_in_place = True

    def fold_chunk(self, state, stream: PairStream):
        """The carried state after folding ``stream``: its ``premap`` span
        maps the values to holder channels (and, for the fused
        accumulator, builds the rows), its ``fold`` span folds them.  The
        caller hands ``state`` over: the fused accumulator and the
        kernels' dense f32 tables, where contiguous, are folded in place
        (``inplace``), and the result is what to keep."""
        assert stream.key_space == self.key_space
        if self.mode in ("size", "sequential"):  # no channels of their own
            with spans.span("fold"):
                if self.mode == "size":
                    return _add_counts(stream.keys, state)
                return _sequential_fold(self.spec, *state, stream.keys,
                                        stream.values)
        n = stream.keys.shape[0]
        with spans.span("premap"):
            chans = pytree.tree_leaves(self.spec.premap(stream.values))
            if self.fused_acc:
                rows = (_rows_f32(chans[0], n) if len(chans) == 1 else
                        torch.cat([c.reshape(n, -1).to(torch.float32)
                                   for c in chans], dim=1))
        with spans.span("fold"):
            if self.fused_acc:  # the kernel folds the counts column itself
                return self.fold_fn(stream.keys, rows, state, counts=True,
                                    inplace=state.is_contiguous())
            tables, counts = state
            tabs = pytree.tree_leaves(tables)
            if self.mode == "additive":
                return self._fold_additive(tabs, chans, counts, stream)
            new_counts = _add_counts(stream.keys, counts)
            if self.mode == "dense":
                return self._fold_dense(tabs, chans, stream), new_counts
            if self.mode == "scatter":
                return self._fold_scatter(tabs, chans, stream), new_counts
            return (self._fold_first(tabs, chans, counts, stream,
                                     stream.valid), new_counts)

    def _fold_additive(self, tabs, chans, counts, stream):
        """Float leaves: the one-hot contraction (or onehot_fold), in f32.
        Integer leaves: ``int_fold``, exact, into int64 tables as they are
        (a narrower table takes an int64 delta, cast back: the same wrap as
        a sum in its own dtype); the counts ride with the first integer
        leaf's launch, or take one of their own."""
        from repro_torch.kernels import ops

        n = stream.keys.shape[0]
        out, new_counts = [], None
        for tab, chan in zip(tabs, chans):
            if tab.is_floating_point():
                delta = self._sum_fold(stream.keys,
                                       _rows_f32(chan, n))
                out.append(tab + delta.reshape(tab.shape).to(tab.dtype))
                continue
            flat = tab.reshape(self.key_space, -1)
            start = (flat if flat.dtype == torch.int64
                     else torch.zeros(flat.shape, dtype=torch.int64,
                                      device=flat.device))
            rows = _int_rows(chan, n)
            if new_counts is None:
                red, new_counts = ops.int_fold(stream.keys, rows,
                                               start.contiguous(), counts)
            else:
                red = ops.int_fold(stream.keys, rows, start.contiguous())
            if flat.dtype != torch.int64:
                red = flat + red.to(flat.dtype)
            out.append(red.reshape(tab.shape))
        if new_counts is None:
            new_counts = _add_counts(stream.keys, counts)
        return pytree.tree_unflatten(out, self._holder_treedef), new_counts

    def _fold_dense(self, tabs, chans, stream):
        keys = stream.keys
        out = []
        for mono, tab, chan in zip(self.spec.monoids, tabs, chans):
            n = chan.shape[0]
            if (self.monoid_fold_fn is not None
                    and tab.dtype == torch.float32
                    and mono.name in ("add", "max", "min")):
                red = self.monoid_fold_fn(
                    keys, _rows_f32(chan, n),
                    tab.reshape(self.key_space, -1), mono.name,
                    inplace=tab.is_contiguous())
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

    def _fold_scatter(self, tabs, chans, stream):
        out = [mono.scatter(tab, stream.keys, chan)
               for mono, tab, chan in zip(self.spec.monoids, tabs, chans)]
        return pytree.tree_unflatten(out, self._holder_treedef)

    def _fold_first(self, tabs, chans, counts, stream, valid):
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
        for tab, chan in zip(tabs, chans):
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
        """The carried state after folding ``stream``, in a ``fold`` span
        (the holders' ``premap`` in a span of its own)."""
        assert stream.key_space == self.key_space
        n = stream.keys.shape[0]
        if n == 0:
            return state
        if self.use_kernel:
            return self._fold_kernel(state, stream)
        with spans.span("fold"):
            return self._fold_sorted(state, stream)

    def _fold_sorted(self, state, stream: PairStream):
        n = stream.keys.shape[0]
        K = self.key_space
        sk, order = stable_sort_by_key(stream.keys, K)
        is_start, start_pos, run_len, tgt, start_tgt = self._run_layout(sk)
        if self.mode == "size":
            return state + _at_keys(tgt, run_len, K)
        svals = pytree.tree_map(lambda v: v[order], stream.values)
        if self.fused_acc:
            with spans.span("premap"):
                cols = [l.reshape(n, -1).to(torch.float32) for l in
                        pytree.tree_leaves(self.spec.premap(svals))]
            cols.append((sk < K).to(torch.float32)[:, None])  # counts
            agg = _run_aggregate(C.ADD, torch.cat(cols, dim=1), is_start,
                                 start_pos)
            return state + _at_keys(tgt, agg, K)
        tables, counts = state
        if self.mode == "sequential":
            return _sequential_fold(self.spec, tables, counts, sk, svals)
        with spans.span("premap"):
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
        with spans.span("premap"):
            mapped = pytree.tree_leaves(self.spec.premap(stream.values))
            ones = stream.valid.to(torch.float32)[:, None]
        with spans.span("fold"):
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
                    red = self.sort_fold_fn(stream.keys, flat,
                                            acc.contiguous(), mono.name)
                out.append(red.reshape(tab.shape).to(tab.dtype))
            if new_counts is None:
                new_counts = self.sort_fold_fn(
                    stream.keys, ones, counts.to(torch.float32)[:, None],
                    "add")[:, 0].to(torch.int32)
            return (pytree.tree_unflatten(out, self._holder_treedef),
                    new_counts)


def sort_flow(spec: C.CombinerSpec, stream: PairStream, *,
              sort_fold_fn: Callable | None = None) -> Grouped:
    """Single-shot sort flow: one chunk through :class:`SortCombiner`, on
    the stream's device."""
    value_spec = C.ValueSpec(tuple(stream.values.shape[1:]),
                             stream.values.dtype)
    sc = SortCombiner(spec, stream.key_space, value_spec,
                      device=stream.keys.device, sort_fold_fn=sort_fold_fn)
    return sc.finalize(sc.fold_chunk(sc.init_state(), stream))


# ---------------------------------------------------------------------------
# Reduce flow (the paper's baseline: no combiner)
# ---------------------------------------------------------------------------

#: largest ``[keys, Lmax]`` window block the reduce flow gathers at once; the
#: user reduce runs one block of keys at a time (the same result: it is
#: vmapped over keys)
REDUCE_WINDOW_ELEMS = 1 << 24


def reduce_flow(reduce_fn: Callable, stream: PairStream, *,
                max_values_per_key: int, pad_value) -> Grouped:
    """Materialize → stable sort → group → per-key user reduce.

    Each key's values, in emission order, fill a window of
    ``max_values_per_key`` (Lmax) rows padded with ``pad_value``; the user
    ``reduce(key, window, min(count, Lmax))`` runs on every key under
    ``torch.func.vmap``.  A key with more than Lmax values reduces its
    first Lmax; the returned counts are not clipped (as in the reference).
    """
    K = stream.key_space
    lmax = int(max_values_per_key)
    keys = torch.where((stream.keys >= 0) & (stream.keys < K), stream.keys,
                       K).to(torch.int64)
    n = keys.shape[0]
    dev = keys.device
    # stable: order-dependent reducers see their values in emission order
    order = torch.argsort(keys, stable=True)
    counts = _counts(stream.keys, K)
    offsets = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    clipped = counts.clamp(max=lmax)
    slot = torch.arange(lmax, device=dev)
    block = max(1, REDUCE_WINDOW_ELEMS // max(lmax, 1))
    outs = []
    for lo in range(0, K, block):
        hi = min(lo + block, K)
        inside = slot[None, :] < counts[lo:hi, None]  # [kb, Lmax]
        pos = (offsets[lo:hi, None] + slot[None, :]).clamp(max=max(n - 1, 0))
        idx = order[pos] if n else pos

        def window(v, inside=inside, idx=idx):
            pad = torch.tensor(pad_value, dtype=v.dtype, device=dev)
            if v.shape[0] == 0:
                return pad.expand(idx.shape + tuple(v.shape[1:])).clone()
            m = inside.reshape(inside.shape + (1,) * (v.ndim - 1))
            return torch.where(m, v[idx], pad)

        wins = pytree.tree_map(window, stream.values)
        keys_blk = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        outs.append(torch.func.vmap(reduce_fn)(keys_blk, wins,
                                               clipped[lo:hi]))
    values = pytree.tree_map(lambda *xs: torch.cat(xs), *outs)
    return Grouped(torch.arange(K, dtype=torch.int32, device=dev), values,
                   counts)


# ---------------------------------------------------------------------------
# Combine flow (the optimizer's single-shot flow)
# ---------------------------------------------------------------------------

#: key-space cutoff of the combine flow's one-hot lowering (the reference's
#: value): with a one-hot kernel the flow takes it up to this many keys
#: only, and past it degrades to the scatter lowering
ONEHOT_MAX_KEYS = 2048

#: pair count up to which the combine flow keeps the plain one-hot
#: contraction past :data:`ONEHOT_MAX_KEYS` (the reference's value, which
#: it measured as XLA's fused-contraction regime); the plain contraction's
#: ``[N, K]`` one-hot stays at most ``2048 × K``
ADDITIVE_FOLD_PAIRS_FUSED = 2048


def _emit_fallback(msg: str, on_fallback: Callable | None) -> None:
    """Route a fallback diagnostic to ``on_fallback`` (the plan's sink:
    warn once per plan, record every message) when given, else warn."""
    if on_fallback is not None:
        on_fallback(msg)
    else:
        warnings.warn(msg, LoweringFallbackWarning, stacklevel=3)


def _premap_stream(spec: C.CombinerSpec, values):
    """(channels, treedef): the batched premap's leaves ``[N, *leaf]`` and
    the structure of the spec's holder, which the tables take."""
    holder = spec.init(C.ValueSpec(tuple(values.shape[1:]), values.dtype))
    return (pytree.tree_leaves(spec.premap(values)),
            pytree.tree_structure(holder))


#: key count, per monoid, from which the scatter lowering's f32 leaves take
#: the sort route (``sort_segment_fold``: the radix partition and the
#: segment reduce, O(N)) instead of the ``combine_scatter`` kernel, whose
#: first pass compares every pair with every key of its block (O(N·K)).
#: Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py: the
#: route sweep (2^22 pairs, D = 1) has the sort route at 0.37-0.45 ms at
#: every K from 64 to 2^16; combine_scatter's add 0.29 ms at K = 64 and
#: 0.33 at 128 but 0.46 at 256, its max 0.53 ms already at K = 64.  The
#: BoundingBox combine run (max and min, D = 3, K = 100, 2^24 points) took
#: 9.59 ms on combine_scatter and 5.15 ms on the sort route.  So max and
#: min take the sort route at every K, add from 256 keys.
SCATTER_SORT_MIN_KEYS = {"add": 256, "max": 1, "min": 1}


def scatter_route(key_space: int, d: int, op: str, *, kernels: bool) -> str:
    """What the scatter lowering runs for an f32 ``op`` leaf of ``d``
    columns: ``"sort_segment_fold"`` from :data:`SCATTER_SORT_MIN_KEYS`
    keys on (when the radix plan is feasible), else ``"combine_scatter"``;
    the monoid's exact scatter without the kernels."""
    if not kernels:
        return "exact scatter"
    if key_space >= SCATTER_SORT_MIN_KEYS[op]:
        from repro_torch.kernels import ops

        if ops.plan_radix_levels(key_space, d=max(d, 1)).feasible:
            return "sort_segment_fold"
    return "combine_scatter"


def combine_scatter(spec: C.CombinerSpec, stream: PairStream, *,
                    scatter_fn: Callable | None = None,
                    sort_fold_fn: Callable | None = None,
                    routes: list[str] | None = None
                    ) -> tuple[Any, torch.Tensor]:
    """Holder tables by ``identity.at[keys].<monoid>(channel)`` scatters.

    With the kernels, f32 add/max/min leaves take ``scatter_fn(keys, mat,
    K, op)`` (the ``combine_scatter`` kernel) or, where
    :func:`scatter_route` says so and ``sort_fold_fn`` is given,
    ``sort_fold_fn(keys, mat, identity, op)`` (``ops.sort_segment_fold``
    folded onto the identity table); both drop keys outside ``[0, K)``.
    The other leaves, and every leaf without the kernels, take the monoid's
    exact scatter.  Counts: ``int_fold``.  ``routes``, when given,
    receives ``"<monoid> <route>"`` for each leaf, in leaf order."""
    assert spec.monoids is not None
    K = stream.key_space
    n = stream.keys.shape[0]
    chans, treedef = _premap_stream(spec, stream.values)
    tables = []
    for mono, chan in zip(spec.monoids, chans):
        route = "exact scatter"
        if (scatter_fn is not None and chan.dtype == torch.float32
                and mono.name in ("add", "max", "min")):
            mat = _rows_f32(chan, n)
            shape = (K,) + tuple(chan.shape[1:])
            route = "combine_scatter"
            if (sort_fold_fn is not None and scatter_route(
                    K, mat.shape[1], mono.name,
                    kernels=True) == "sort_segment_fold"):
                route = "sort_segment_fold"
                ident = mono.identity_like((K, mat.shape[1]), torch.float32,
                                           device=chan.device)
                tab = sort_fold_fn(stream.keys, mat, ident, mono.name)
            else:
                tab = scatter_fn(stream.keys, mat, K, mono.name)
            tables.append(tab.reshape(shape))
        else:
            init = mono.identity_like((K,) + tuple(chan.shape[1:]),
                                      chan.dtype, device=chan.device)
            tables.append(mono.scatter(init, stream.keys, chan))
        if routes is not None:
            routes.append(f"{mono.name} {route}")
    counts = _counts(stream.keys, K)
    return pytree.tree_unflatten(tables, treedef), counts


def combine_onehot(spec: C.CombinerSpec, stream: PairStream, *,
                   onehot_fn: Callable | None = None
                   ) -> tuple[Any, torch.Tensor]:
    """Additive holders by the one-hot contraction ``one_hot(keys)ᵀ @ chan``.

    ``onehot_fn(keys, mat, K)`` (the ``onehot_combine`` kernel) takes every
    channel in f32, integer ones too (exact up to 2^24 per key, ROADMAP
    C.6), and the counts, as in the reference.  Without it float channels
    take the plain contraction in f32 and integer channels an exact
    ``index_add_`` in their own dtype (ROADMAP C.5); counts ``int_fold``."""
    assert spec.sum_lowerable
    K = stream.key_space
    n = stream.keys.shape[0]
    valid = stream.valid
    chans, treedef = _premap_stream(spec, stream.values)
    tables = []
    for chan in chans:
        shape = (K,) + tuple(chan.shape[1:])
        if onehot_fn is not None:
            tab = onehot_fn(stream.keys, _rows_f32(chan, n), K)
        elif chan.is_floating_point():
            from repro_torch.kernels.onehot_combine import onehot_combine_plain

            tab = onehot_combine_plain(stream.keys, _rows_f32(chan, n), K)
        else:  # invalid pairs add 0 to row 0: exact, and no host sync
            vmask = valid.reshape((n,) + (1,) * (chan.ndim - 1))
            tab = torch.zeros(shape, dtype=chan.dtype,
                              device=chan.device).index_add_(
                0, torch.where(valid, stream.keys, 0).to(torch.int64),
                torch.where(vmask, chan, 0))
        tables.append(tab.reshape(shape).to(chan.dtype))
    if onehot_fn is not None:
        counts = onehot_fn(stream.keys, valid.to(torch.float32)[:, None],
                           K)[:, 0].to(torch.int32)
    else:
        counts = _counts(stream.keys, K)
    return pytree.tree_unflatten(tables, treedef), counts


def combine_first(spec: C.CombinerSpec, stream: PairStream
                  ) -> tuple[Any, torch.Tensor]:
    """First-element idiom: each key's first-arrived value (a scatter-min
    of arrival positions).  An absent key holds the last pair's value, as
    in the reference; its count is 0."""
    K = stream.key_space
    n = stream.keys.shape[0]
    valid = stream.valid
    chans, treedef = _premap_stream(spec, stream.values)
    pos = torch.arange(n, device=stream.keys.device)
    first_pos = torch.full((K + 1,), n, dtype=torch.int64,
                           device=stream.keys.device).scatter_reduce(
        0, torch.where(valid, stream.keys, K).long(), pos, "amin",
        include_self=True)[:K]
    safe = first_pos.clamp(max=max(n - 1, 0))
    tables = [chan[safe] for chan in chans]
    return (pytree.tree_unflatten(tables, treedef),
            _counts(stream.keys, K))


def combine_segment(spec: C.CombinerSpec, stream: PairStream
                    ) -> tuple[Any, torch.Tensor]:
    """Coupled holders: the stably key-sorted pairs folded one at a time
    (:func:`_sequential_fold`)."""
    sk, order = stable_sort_by_key(stream.keys, stream.key_space)
    svals = pytree.tree_map(lambda v: v[order], stream.values)
    value_spec = C.ValueSpec(tuple(stream.values.shape[1:]),
                             stream.values.dtype)
    tables0, counts0 = spec.init_tables(stream.key_space, value_spec,
                                        stream.keys.device)
    return _sequential_fold(spec, tables0, counts0, sk, svals)


def choose_combine_impl(spec: C.CombinerSpec, key_space: int, n_pairs: int,
                        *, onehot_kernel: bool) -> tuple[str, str | None]:
    """``(impl, fallback reason)`` of ``combine_flow(impl="auto")``: the
    reference's rule.  The reason is set when a sum-lowerable spec
    degrades to the scatter lowering."""
    onehot_ok = (key_space <= ONEHOT_MAX_KEYS
                 or (not onehot_kernel
                     and n_pairs <= ADDITIVE_FOLD_PAIRS_FUSED))
    if spec.strategy == C.STRATEGY_SIZE:
        return "scatter", None  # counts only
    if spec.strategy == C.STRATEGY_FIRST:
        return "first", None
    if spec.sum_lowerable and onehot_ok:
        return "onehot", None
    if not spec.scatter_lowerable:
        return "segment", None
    if not spec.sum_lowerable:
        return "scatter", None
    if onehot_kernel:
        reason = (f"key_space={key_space} > {ONEHOT_MAX_KEYS}, the key-space "
                  f"cutoff of the onehot_combine kernel (the reference's "
                  f"rule, kept)")
    else:
        reason = (f"key_space={key_space} > {ONEHOT_MAX_KEYS} and more than "
                  f"{ADDITIVE_FOLD_PAIRS_FUSED} pairs, past which the plain "
                  f"one-hot contraction is not taken")
    return "scatter", reason


def combine_flow(spec: C.CombinerSpec, stream: PairStream, *,
                 impl: str = "auto", onehot_fn: Callable | None = None,
                 scatter_fn: Callable | None = None,
                 sort_fold_fn: Callable | None = None,
                 on_fallback: Callable | None = None,
                 on_lowering: Callable | None = None) -> Grouped:
    """The combining collector over a whole pair buffer, with the lowering
    ``impl`` (``"auto"``: :func:`choose_combine_impl`): ``onehot``,
    ``scatter``, ``first`` or ``segment``.  A sum-lowerable spec that
    degrades to ``scatter`` reports it to ``on_fallback`` (else a
    :class:`LoweringFallbackWarning`).  The scatter lowering's kernels are
    ``scatter_fn`` and ``sort_fold_fn`` (:func:`combine_scatter`).
    ``on_lowering``, when given, receives the lowering this run took and,
    for ``scatter``, each leaf's route."""
    K = stream.key_space
    if impl == "auto":
        impl, reason = choose_combine_impl(
            spec, K, stream.keys.shape[0], onehot_kernel=onehot_fn is not None)
        if reason is not None:
            _emit_fallback(
                f"combine flow: {reason}; degrading to the exact scatter "
                f"fallback. The chunked stream flow keeps large pair "
                f"streams on the one-hot fold.", on_fallback)
    taken = impl
    if impl == "scatter":
        if spec.strategy == C.STRATEGY_SIZE:
            tables, counts = (), _counts(stream.keys, K)
            taken = "scatter (counts only)"
        else:
            routes: list[str] = []
            tables, counts = combine_scatter(spec, stream,
                                             scatter_fn=scatter_fn,
                                             sort_fold_fn=sort_fold_fn,
                                             routes=routes)
            taken = f"scatter (K={K}: {', '.join(routes)})"
    elif impl == "onehot":
        if not spec.sum_lowerable:
            raise ValueError(f"combine impl 'onehot' needs a sum-lowerable "
                             f"combiner, got {spec.describe}")
        tables, counts = combine_onehot(spec, stream, onehot_fn=onehot_fn)
        taken = ("onehot (onehot_combine)" if onehot_fn is not None
                 else "onehot (plain contraction)")
    elif impl == "first":
        tables, counts = combine_first(spec, stream)
    elif impl == "segment":
        tables, counts = combine_segment(spec, stream)
    else:
        raise ValueError(f"unknown combine impl {impl!r}")
    if on_lowering is not None:
        on_lowering(taken)
    return finalize_tables(spec, tables, counts, K)
