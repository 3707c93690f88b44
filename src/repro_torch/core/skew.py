"""Skew-adaptive shuffle planning: sampled histograms -> balanced ranges.

Counterpart of ``repro/core/skew.py``.  The planner samples the emitted
key distribution, derives balanced range boundaries for the sort and
reduce flows' all-to-all in place of the fixed-width ``k // ceil(K/S)``
ranges, and splits hot keys over several destination shards (exact
because the derived combiner is a monoid: the destinations' partial
tables of one key merge into the unsplit answer).

The user surface is :class:`ShuffleOptions`, carried as
``ExecutionOptions.shuffle``: ``capacity`` / ``strict`` (the deprecated
flat ``shuffle_capacity`` / ``strict_shuffle`` forward here),
``skew="auto"`` (sample at ``lower()`` time, memoize the decision in the
process and, when ``REPRO_TORCH_TUNE_CACHE`` names a file, there), explicit
``boundaries=`` (no sampling), and the ``wire`` codec.  The resolved
record's ``repr`` goes into the compiled-stage key.

The derivation is the reference's host-side numpy, line for line:
boundaries, hot keys, ways, the capacity envelope and
:attr:`ShufflePlan.epoch` equal the reference's for the same histogram.
The histogram itself is taken through the port's ``engine.map_phase``.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import zlib

import numpy as np
import torch
from torch.utils import _pytree as pytree

#: hard cap on the sampled pair count
SAMPLE_PAIR_CAP = 4096
#: fixed-width imbalance at or below this keeps the fixed-width ranges
SNAP_IMBALANCE = 1.25
#: a key holding more than this fraction of a uniform shard share is hot
HOT_KEY_FRACTION = 0.5
#: at most this many keys are split
MAX_HOT_KEYS = 8
#: headroom on the sampled largest destination load for the capacity
CAPACITY_SLACK = 1.5
#: per-range load cap (x the uniform share) the boundary cuts balance to
BOUNDARY_LOAD_SLACK = 1.25
#: prefix of the planner's entries in the tune cache file
SKEW_KEY_PREFIX = "skew|"

#: monoids whose dense reduction is order-insensitive: the exactness
#: envelope of hot-key splitting
_COMMUTATIVE_MONOIDS = frozenset({"add", "max", "min", "and", "or", "mul"})

#: how many histogram probes ran and how many resolutions a memo served
SKEW_STATS = {"samples": 0, "cache_hits": 0, "resolves": 0}

#: in-process memo of resolved decisions, keyed by content
_MEMO: dict[str, dict] = {}


def stats_snapshot() -> dict:
    return dict(SKEW_STATS)


def clear_memo() -> None:
    _MEMO.clear()


# ---------------------------------------------------------------------------
# The options record (ExecutionOptions.shuffle)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShuffleOptions:
    """The shuffle's options (``ExecutionOptions.shuffle``).  The first
    block is the user's intent; the second the resolved planning state
    that :func:`resolve_shuffle_options` fills in (or the caller passes)."""

    #: send capacity a destination; None derives it
    capacity: int | None = None
    #: raise on shuffle overflow instead of warning
    strict: bool = False
    #: "auto" samples a key histogram at lower() time; "off" keeps the
    #: fixed-width ranges
    skew: str = "off"
    #: fraction of items the probe maps (capped at SAMPLE_PAIR_CAP pairs)
    sample_fraction: float = 0.25
    #: most destination shards one hot key is split over (>= 2 splits)
    hot_key_split_max: int = 4
    #: the wire codec ("raw" | "delta" | "packed"; ``distributed/wire.py``)
    wire: str = "raw"
    # -- resolved planning state -------------------------------------------
    #: S + 1 ascending key cuts; None means fixed-width ranges
    boundaries: tuple[int, ...] | None = None
    hot_keys: tuple[int, ...] = ()
    hot_ways: tuple[int, ...] = ()
    #: the sample's fixed-width imbalance (largest range load / share)
    imbalance: float | None = None
    #: largest destination load fraction under the derived plan
    max_dest_frac: float | None = None
    #: provenance: "sample" | "cache" | "file-cache" | "explicit"
    source: str | None = None

    def __post_init__(self):
        if self.skew not in ("auto", "off"):
            raise ValueError(f"ShuffleOptions.skew must be 'auto' or 'off', "
                             f"got {self.skew!r}")
        from repro_torch.distributed import wire as wirelib

        if self.wire not in wirelib.CODECS:
            raise ValueError(
                f"ShuffleOptions.wire must be one of {wirelib.CODECS}, "
                f"got {self.wire!r}")
        if self.boundaries is not None:
            object.__setattr__(self, "boundaries",
                               tuple(int(b) for b in self.boundaries))
        object.__setattr__(self, "hot_keys",
                           tuple(int(k) for k in self.hot_keys))
        object.__setattr__(self, "hot_ways",
                           tuple(int(w) for w in self.hot_ways))
        if len(self.hot_keys) != len(self.hot_ways):
            raise ValueError("hot_keys and hot_ways must pair up")


@dataclasses.dataclass(frozen=True)
class SkewProfile:
    """What the histogram probe saw (``explain()`` provenance)."""

    n_sampled_pairs: int
    imbalance: float
    #: (key, sampled count) of the heaviest keys, descending
    top_keys: tuple[tuple[int, int], ...]
    source: str

    def describe(self) -> tuple[str, ...]:
        top = ", ".join(f"{k}:{c}" for k, c in self.top_keys)
        return (
            f"histogram: {self.n_sampled_pairs} sampled pairs "
            f"({self.source}); fixed-width imbalance "
            f"{self.imbalance:.2f}x; heavy hitters [{top}]",
        )


# ---------------------------------------------------------------------------
# The engine's resolved plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShufflePlan:
    """The boundaries and hot splits the engine routes by.  ``width`` is the
    static per-shard range span: narrower ranges pad with zero-count rows,
    as the fixed-width ``ceil(K/S)`` ranges do."""

    key_space: int
    num_shards: int
    boundaries: tuple[int, ...]
    hot_keys: tuple[int, ...] = ()
    hot_ways: tuple[int, ...] = ()
    imbalance: float | None = None
    max_dest_frac: float | None = None

    def __post_init__(self):
        b, S, K = self.boundaries, self.num_shards, self.key_space
        if len(b) != S + 1:
            raise ValueError(f"need {S + 1} boundaries for {S} shards, "
                             f"got {len(b)}")
        if b[0] != 0 or b[-1] != K:
            raise ValueError(f"boundaries must span [0, {K}], got "
                             f"[{b[0]}, {b[-1]}]")
        if any(b[i + 1] <= b[i] for i in range(S)):
            raise ValueError("boundaries must be strictly increasing")
        for k, w in zip(self.hot_keys, self.hot_ways):
            if not 0 <= k < K:
                raise ValueError(f"hot key {k} outside [0, {K})")
            if w < 2:
                raise ValueError(f"hot key {k} split {w} ways (<2)")
        if len(self.hot_keys) != len(set(self.hot_keys)):
            raise ValueError("duplicate hot keys")

    @property
    def width(self) -> int:
        """Static per-shard range width: the widest boundary span."""
        b = self.boundaries
        return max(b[i + 1] - b[i] for i in range(self.num_shards))

    @property
    def epoch(self) -> int:
        """Content fingerprint of the boundary and hot layout (the
        reference's)."""
        return zlib.crc32(repr((self.boundaries, self.hot_keys,
                                self.hot_ways)).encode())

    def hot_owner(self, key: int) -> int:
        """The shard whose boundary span holds ``key``."""
        return bisect.bisect_right(self.boundaries, key) - 1

    def hot_dests(self, i: int) -> tuple[int, ...]:
        owner = self.hot_owner(self.hot_keys[i])
        return tuple((owner + m) % self.num_shards
                     for m in range(self.hot_ways[i]))

    def capacity_for(self, n_pairs: int) -> int:
        """Send capacity a destination: the sampled largest destination
        load with :data:`CAPACITY_SLACK` headroom, never below twice the
        uniform share."""
        from repro_torch.distributed import wire as wirelib

        S = self.num_shards
        legacy = wirelib.shuffle_bucket_capacity(n_pairs, S)
        if self.max_dest_frac is None:
            return legacy
        frac = min(1.0, float(self.max_dest_frac))
        cap = int(np.ceil(n_pairs * frac * CAPACITY_SLACK))
        return max(min(n_pairs, max(cap, 8)), legacy)

    def describe(self) -> tuple[str, ...]:
        b = self.boundaries
        spans = [b[i + 1] - b[i] for i in range(self.num_shards)]
        lines = [
            f"boundaries: {self.num_shards} ranges over K={self.key_space}"
            f" width={self.width} (spans {min(spans)}..{max(spans)})"
            + (f" imbalance={self.imbalance:.2f}x"
               if self.imbalance is not None else "")
            + (f" p-max dest {self.max_dest_frac:.3f}"
               if self.max_dest_frac is not None else "")]
        if self.hot_keys:
            parts = ", ".join(
                f"{k}x{w}@{self.hot_dests(i)}"
                for i, (k, w) in enumerate(zip(self.hot_keys,
                                               self.hot_ways)))
            lines.append(f"hot keys split: {parts} "
                         f"(partial-aggregate recombine in phase B)")
        return tuple(lines)


def hot_split_ok(flow: str, spec, value_spec) -> bool:
    """Hot-key splitting is exact only on the sort flow, with a ``merge``
    and a commutative monoid (add, max, min, and, or, mul) on every holder
    leaf: the split destinations' partial tables merge through
    ``engine.merge_tables_collective``."""
    if flow != "sort" or spec is None:
        return False
    if spec.merge is None or spec.monoids is None:
        return False
    leaves = pytree.tree_leaves(spec.init(value_spec))
    return (len(spec.monoids) == len(leaves)
            and all(m.name in _COMMUTATIVE_MONOIDS for m in spec.monoids))


# ---------------------------------------------------------------------------
# Sampling and derivation
# ---------------------------------------------------------------------------


def _sample_indices(n_items: int, sample_fraction: float,
                    emit_capacity: int) -> np.ndarray:
    """A strided subsample of the item axis, capped at
    :data:`SAMPLE_PAIR_CAP` pairs; an input within the cap is taken
    whole."""
    cap_items = max(1, SAMPLE_PAIR_CAP // max(emit_capacity, 1))
    want = int(np.ceil(n_items * max(min(sample_fraction, 1.0), 0.0)))
    want = max(want, min(n_items, cap_items))
    want = max(1, min(want, cap_items))
    stride = max(1, n_items // want)
    return np.arange(0, n_items, stride)[:want]


def _take(items, idx: np.ndarray, device):
    def one(a):
        t = torch.as_tensor(a)
        return t[torch.as_tensor(idx, device=t.device)].to(device)

    return pytree.tree_map(one, items)


def sample_key_histogram(app, items, *, sample_fraction: float = 0.25,
                         device=None) -> np.ndarray:
    """Map a strided item subsample (``engine.map_phase`` on ``device``)
    and histogram its valid emitted keys: ``[K]`` int64."""
    from repro_torch.core import engine as eng

    n = eng.items_length(items)
    idx = _sample_indices(n, sample_fraction,
                          int(getattr(app, "emit_capacity", 16)))
    dev = torch.device(device) if device is not None else torch.device("cpu")
    with torch.no_grad():
        stream = eng.map_phase(app, _take(items, idx, dev), dev)
    keys = stream.keys.cpu().numpy()
    valid = stream.valid.cpu().numpy()
    SKEW_STATS["samples"] += 1
    return np.bincount(keys[valid], minlength=app.key_space
                       ).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SkewDecision:
    """The derivation's raw output."""

    boundaries: tuple[int, ...] | None
    hot_keys: tuple[int, ...]
    hot_ways: tuple[int, ...]
    imbalance: float
    max_dest_frac: float | None
    top_keys: tuple[tuple[int, int], ...]
    n_sampled_pairs: int


def _balanced_cuts(residual: np.ndarray, K: int, S: int,
                   rtotal: int, n_pairs: int | None = None) -> list[int]:
    """S contiguous ranges covering [0, K): each range's load capped at a
    slack times the uniform share, and under the cap the widest span as
    small as a binary search finds (every shard's range table is as wide
    as the widest span).  With ``n_pairs`` the slack candidates are scored
    by the estimated rows a shard folds (S receive buckets of the
    envelope and one table); without it, the cap rises until the widest
    span meets about 1.25x the uniform span."""
    cum = np.cumsum(residual)
    min_span = -(-K // S)
    span_budget = min_span + min_span // 4

    def cuts_for(load_cap: float, span_cap: int) -> list[int] | None:
        bounds = [0]
        for _ in range(S):
            start = bounds[-1]
            if start >= K:
                break
            base = float(cum[start - 1]) if start else 0.0
            b = int(np.searchsorted(cum, base + load_cap, side="right"))
            b = max(start + 1, min(b, start + span_cap, K))
            bounds.append(b)
        return bounds if bounds[-1] == K else None

    def min_span_cuts(load_cap: float) -> list[int] | None:
        if cuts_for(load_cap, K) is None:
            return None
        lo, hi = min_span, K
        while lo < hi:
            mid = (lo + hi) // 2
            if cuts_for(load_cap, mid) is not None:
                hi = mid
            else:
                lo = mid + 1
        return cuts_for(load_cap, lo)

    candidates = []
    for slack in (BOUNDARY_LOAD_SLACK, 1.5, 2.0, 3.0, 4.0, 8.0, float(S)):
        # one key's mass cannot be split across contiguous cuts
        cap = max(slack * rtotal / S, float(residual.max()))
        got = min_span_cuts(cap)
        if got is not None:
            candidates.append(got)
    if not candidates:
        candidates = [min_span_cuts(float(rtotal) + 1.0)]

    if n_pairs is not None:
        def phase_b_rows(b) -> float:
            width = int(max(np.diff(b)))
            loads = np.add.reduceat(residual, np.asarray(b[:-1]))
            frac = float(loads.max()) / max(rtotal, 1)
            envelope = (n_pairs / S) * frac * CAPACITY_SLACK
            return S * envelope + width

        bounds = min(candidates, key=phase_b_rows)
    else:
        bounds = candidates[-1]
        for got in candidates:
            if max(np.diff(got)) <= span_budget:
                bounds = got
                break
    # fewer than S ranges: split the widest until there are S
    while len(bounds) - 1 < S:
        spans = np.diff(bounds)
        i = int(spans.argmax())
        bounds.insert(i + 1, bounds[i] + int(spans[i]) // 2)
    return bounds


def derive(hist: np.ndarray, num_shards: int, *,
           hot_key_split_max: int = 4,
           mergeable: bool = False,
           n_pairs: int | None = None) -> SkewDecision:
    """Balanced boundaries and hot-key splits from a key histogram (host
    numpy, deterministic).  ``n_pairs`` is the run's emitted pair count
    when known."""
    hist = np.asarray(hist, np.int64)
    K = int(hist.shape[0])
    S = int(num_shards)
    total = int(hist.sum())
    order = np.argsort(hist)[::-1]
    top = tuple((int(k), int(hist[k])) for k in order[:5] if hist[k] > 0)

    def identity(imb: float) -> SkewDecision:
        return SkewDecision(None, (), (), imb, None, top, total)

    if total == 0 or S <= 1 or K < S:
        return identity(1.0)

    uniform = total / S
    K_local = -(-K // S)
    fixed_loads = np.add.reduceat(hist, np.arange(0, K, K_local))
    imbalance = float(fixed_loads.max() / uniform)
    if imbalance <= SNAP_IMBALANCE:
        return identity(imbalance)

    hot_keys: list[int] = []
    hot_ways: list[int] = []
    if mergeable and hot_key_split_max >= 2 and S >= 2:
        thresh = HOT_KEY_FRACTION * uniform
        for k in order[:MAX_HOT_KEYS]:
            if hist[k] > thresh:
                hot_keys.append(int(k))
                hot_ways.append(int(min(
                    hot_key_split_max, S,
                    max(2, int(np.ceil(hist[k] / max(thresh, 1.0)))))))
    residual = hist.copy()
    residual[hot_keys] = 0
    rtotal = int(residual.sum())

    bounds = _balanced_cuts(residual, K, S, rtotal, n_pairs=n_pairs)

    # largest destination load fraction: residual range loads plus each
    # hot key's mass spread over its destinations
    starts = np.asarray(bounds[:-1])
    loads = np.add.reduceat(residual, starts).astype(np.float64)
    for k, w in zip(hot_keys, hot_ways):
        owner = bisect.bisect_right(bounds, k) - 1
        share = hist[k] / w
        for m in range(w):
            loads[(owner + m) % S] += share
    max_dest_frac = float(loads.max() / total)
    return SkewDecision(tuple(int(b) for b in bounds), tuple(hot_keys),
                        tuple(hot_ways), imbalance, max_dest_frac, top,
                        total)


# ---------------------------------------------------------------------------
# Resolution at lower() time: options -> resolved options (+ profile)
# ---------------------------------------------------------------------------


def _resolve_memo_key(app, num_shards: int, options: ShuffleOptions,
                      items, *, mergeable: bool) -> str:
    """The memo's content key: the app's shapes, the shard count, the
    derivation's gates, the item count and the bytes of the strided
    sample (hashed before any mapping, so a warm hit maps nothing)."""
    from repro_torch.distributed.wire import dtype_name

    vs = app.value_spec
    head = "|".join([
        "skew", type(app).__name__, f"K={app.key_space}",
        f"cap={app.emit_capacity}",
        f"v={dtype_name(vs.dtype)}{tuple(vs.shape)}",
        f"S={num_shards}", f"frac={options.sample_fraction}",
        f"split={options.hot_key_split_max}",
        f"merge={int(mergeable)}",
    ])
    h = hashlib.sha256(head.encode())
    leaves = pytree.tree_leaves(items)
    n = int(leaves[0].shape[0])
    h.update(f"n={n}".encode())
    idx = _sample_indices(n, options.sample_fraction,
                          int(getattr(app, "emit_capacity", 16)))
    h.update(np.asarray(idx).tobytes())
    for leaf in leaves:
        t = torch.as_tensor(leaf)
        sub = t[torch.as_tensor(idx, device=t.device)].cpu().contiguous()
        h.update(sub.view(torch.uint8).numpy().tobytes()
                 if sub.numel() else b"")
    return f"{SKEW_KEY_PREFIX}{h.hexdigest()[:16]}"


def _decision_entry(d: SkewDecision) -> dict:
    return {
        "boundaries": list(d.boundaries) if d.boundaries is not None
        else None,
        "hot_keys": list(d.hot_keys), "hot_ways": list(d.hot_ways),
        "imbalance": d.imbalance, "max_dest_frac": d.max_dest_frac,
        "top_keys": [list(t) for t in d.top_keys],
        "n_sampled_pairs": d.n_sampled_pairs,
    }


def _entry_decision(e: dict) -> SkewDecision:
    return SkewDecision(
        tuple(e["boundaries"]) if e.get("boundaries") is not None else None,
        tuple(e.get("hot_keys", ())), tuple(e.get("hot_ways", ())),
        float(e.get("imbalance", 1.0)), e.get("max_dest_frac"),
        tuple((int(k), int(c)) for k, c in e.get("top_keys", ())),
        int(e.get("n_sampled_pairs", 0)))


def resolve_shuffle_options(app, plan, items, *, num_shards: int,
                            options: ShuffleOptions | None, device=None
                            ) -> tuple[ShuffleOptions, SkewProfile | None]:
    """Fill a ``ShuffleOptions`` record's planning state from the data, at
    ``lower()`` time.  Explicit boundaries pass through; ``skew="auto"``
    on a multi-shard sort or reduce plan samples (or recalls) the key
    histogram and puts the derived decision in the returned record.  The
    probe maps its sample on ``device``."""
    opts = options if options is not None else ShuffleOptions()
    if opts.boundaries is not None:
        src = opts.source or "explicit"
        return (dataclasses.replace(opts, source=src),
                SkewProfile(0, opts.imbalance or 0.0, (), src))
    if (opts.skew != "auto" or num_shards <= 1
            or plan.flow not in ("sort", "reduce")):
        return opts, None

    from repro_torch.core import autotune as at
    from repro_torch.core import plan_cache as pc

    mergeable = (opts.hot_key_split_max >= 2
                 and hot_split_ok(plan.flow, plan.spec, app.value_spec))
    key = _resolve_memo_key(app, num_shards, opts, items,
                            mergeable=mergeable)
    decision = None
    source = "sample"
    path = at.tune_cache_path()
    if key in _MEMO:
        decision = _entry_decision(_MEMO[key])
        source = "cache"
        SKEW_STATS["cache_hits"] += 1
    else:
        if path is not None:
            e = pc.load_json(path).get(key)
            if isinstance(e, dict):
                decision = _entry_decision(e)
                source = "file-cache"
                SKEW_STATS["cache_hits"] += 1
        if decision is None:
            hist = sample_key_histogram(
                app, items, sample_fraction=opts.sample_fraction,
                device=device)
            n_items = int(pytree.tree_leaves(items)[0].shape[0])
            decision = derive(
                hist, num_shards,
                hot_key_split_max=opts.hot_key_split_max,
                mergeable=mergeable,
                n_pairs=n_items * int(getattr(app, "emit_capacity", 1)))
        _MEMO[key] = _decision_entry(decision)
        if path is not None and source == "sample":
            pc.store_json(path, key, _MEMO[key])
    SKEW_STATS["resolves"] += 1

    profile = SkewProfile(decision.n_sampled_pairs, decision.imbalance,
                          decision.top_keys, source)
    resolved = dataclasses.replace(
        opts, boundaries=decision.boundaries,
        hot_keys=decision.hot_keys if mergeable else (),
        hot_ways=decision.hot_ways if mergeable else (),
        imbalance=decision.imbalance,
        max_dest_frac=decision.max_dest_frac, source=source)
    return resolved, profile


def plan_from_options(key_space: int, num_shards: int,
                      options: ShuffleOptions | None, *,
                      flow: str | None = None, spec=None,
                      value_spec=None) -> ShufflePlan | None:
    """The engine's :class:`ShufflePlan` from resolved options; ``None``
    (no boundaries) keeps the fixed-width ranges.  Hot keys on a plan
    that cannot merge split partials exactly raise."""
    if options is None or options.boundaries is None:
        return None
    if options.hot_keys and flow is not None:
        if not hot_split_ok(flow, spec, value_spec):
            raise ValueError(
                f"hot-key splitting needs the sort flow with a fully "
                f"commutative-monoid combiner (flow={flow!r}); drop "
                f"hot_keys from ShuffleOptions or let skew='auto' gate it")
    return ShufflePlan(
        key_space=key_space, num_shards=num_shards,
        boundaries=options.boundaries, hot_keys=options.hot_keys,
        hot_ways=options.hot_ways, imbalance=options.imbalance,
        max_dest_frac=options.max_dest_frac)
