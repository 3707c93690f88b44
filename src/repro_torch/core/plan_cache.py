"""Content-keyed plan cache of the staged API.

Counterpart of ``repro/core/plan_cache.py``.  ``MapReduce`` used to derive
the combiner and tile the flow on every construction; the staged path
(``core/api.py``: ``lower() -> optimize() -> compile()``) keys what it
resolves by *content*, not object identity:

    reduce graph x map graph x K x value dtype/shape x N-bucket x flow
    x lowering knobs x device

so repeat traffic of equal apps at equal shapes never derives, tunes or
prepares a run again, however many ``MapReduce`` or ``Pipeline`` objects
the caller builds.

Two layers, as in the reference:

* **in-memory** (``_PLANS`` / ``_COMPILED``): the cached ``ExecutionPlan``
  (with its live ``CombinerSpec`` closures), the tiling and the prepared
  run (``engine.LocalRun``) are reused as they are.  A hit derives
  nothing, tunes nothing and prepares nothing (:data:`STATS`).
* **file** (opt-in through ``REPRO_TORCH_PLAN_CACHE``): a JSON file of the
  plan *decisions* (flow, chunk, key block, radix levels) across
  processes.  Closures do not serialize, so a file hit still derives, but
  pins the tiling.  It is advisory and corrupt-safe: an unreadable file, a
  malformed or stale entry, an unknown flow, and an entry made on another
  card all read as no entry.

Fingerprints come from the torch graph (``make_fx`` on fake tensors), not
a jaxpr: the graph's code plus a sha256 of every tensor constant's bytes,
so two closures that differ only in a captured table do not collide.  A
function the tracer refuses keys on a per-instance uid.

:data:`STATS` is bumped where the cache is meant to save work:
``optimizer.derive_combiner`` (``derives``), ``autotune_stream`` /
``autotune_sort`` (``autotunes``), the measured probe (``probes``) and
``Optimized._build`` (``compiles``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import os
from typing import Any

import torch
from torch.utils import _pytree as pytree

#: the file layer's path (JSON); unset: plan decisions are not persisted
PLAN_CACHE_ENV = "REPRO_TORCH_PLAN_CACHE"


@dataclasses.dataclass
class CacheStats:
    """Process-wide event counters.

    ``derives`` counts optimizer runs, ``autotunes`` tiling calls,
    ``probes`` measured probes, ``compiles`` prepared runs (the staged
    compile).  ``hits``/``misses`` are compiled-stage lookups,
    ``plan_hits``/``plan_misses`` plan-stage lookups, ``file_hits`` the
    file layer's hits."""

    derives: int = 0
    autotunes: int = 0
    probes: int = 0
    compiles: int = 0
    hits: int = 0
    misses: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    file_hits: int = 0

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


STATS = CacheStats()


def stats_snapshot() -> dict:
    """Copy of the counters: diff two snapshots to assert what a call did."""
    return STATS.snapshot()


# ---------------------------------------------------------------------------
# Content fingerprints
# ---------------------------------------------------------------------------

#: identity of an untraceable app: a counter stored on the app, never
#: reused (``id(app)`` can be, once the app is collected)
_FALLBACK_UIDS = itertools.count()


def _memo(app) -> dict:
    return app.__dict__.setdefault("_plan_cache_fp", {})


def _fallback_uid(app) -> int:
    memo = _memo(app)
    if "uid" not in memo:
        memo["uid"] = next(_FALLBACK_UIDS)
    return memo["uid"]


def _digest(*parts: str) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
        h.update(b"\x00")
    return h.hexdigest()[:16]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _spec_part(shape, dtype) -> str:
    return f"{_dtype_name(dtype)}{tuple(int(s) for s in shape)}"


def graph_sig(gm: torch.fx.GraphModule) -> str:
    """Content signature of a traced graph: its code plus a hash of every
    tensor constant's bytes (``_tensor_constant*`` attributes), which the
    code names but does not hold."""
    parts = [gm.code]
    for node in gm.graph.nodes:
        if node.op != "get_attr":
            continue
        const = getattr(gm, node.target, None)
        if isinstance(const, torch.Tensor):
            t = const.detach().cpu().contiguous()
            raw = (t.reshape(-1).view(torch.uint8).numpy().tobytes()
                   if t.numel() else b"")
            parts.append(f"{node.target}:{_spec_part(t.shape, t.dtype)}:"
                         + hashlib.sha256(raw).hexdigest()[:12])
        else:
            parts.append(f"{node.target}:{const!r}")
    return "\x00".join(parts)


def _trace(fn, *args) -> torch.fx.GraphModule:
    from torch.fx.experimental.proxy_tensor import make_fx

    return make_fx(fn, tracing_mode="fake",
                   _allow_non_fake_inputs=True)(*args)


def _app_attr_sig(app) -> str:
    vs = app.value_spec
    return "|".join([
        f"K={app.key_space}",
        f"v={_spec_part(vs.shape, vs.dtype)}",
        f"cap={app.emit_capacity}",
        f"lmax={getattr(app, 'max_values_per_key', 0)}",
        f"pad={app.pad_value!r}",
    ])


def reduce_fingerprint(app) -> str:
    """Content hash of the app's reduce: the fake-tensor graph of
    ``reduce(key, values[4, ...], count)`` (traced once, memoized on the
    app) plus the attributes the planner keys on."""
    memo = _memo(app)
    if "reduce" not in memo:
        vs = app.value_spec
        try:
            gm = _trace(lambda k, v, c: app.reduce(k, v, c),
                        torch.zeros((), dtype=torch.int32),
                        torch.zeros((4,) + tuple(vs.shape), dtype=vs.dtype),
                        torch.zeros((), dtype=torch.int32))
            sig = graph_sig(gm)
        except Exception:  # untraceable reduce: key on the app's identity
            sig = f"uid:{_fallback_uid(app)}:{type(app).__qualname__}"
        memo["reduce"] = _digest(sig, _app_attr_sig(app))
    return memo["reduce"]


def _zeros_of(spec):
    return pytree.tree_map(
        lambda s: torch.zeros(tuple(s.shape), dtype=s.dtype), spec)


def map_graph(app, item_spec) -> torch.fx.GraphModule:
    """The fake-tensor graph of ``map(item, emit)`` over one item of
    ``item_spec`` through a recording emitter; its outputs are the
    emitter's ``(keys, values)``."""
    from repro_torch.core import engine as eng

    def one(item):
        em = eng.Emitter(app.emit_capacity, app.key_space, app.value_spec,
                         "cpu")
        app.map(item, em)
        return em.pairs()

    return _trace(one, _zeros_of(item_spec))


def map_fingerprint(app, item_spec) -> str:
    """Content hash of the app's map over one item of ``item_spec``
    (traced once per item spec, memoized on the app)."""
    spec_sig = spec_sig_of(item_spec)
    memo = _memo(app)
    key = f"map:{spec_sig}"
    if key not in memo:
        try:
            sig = graph_sig(map_graph(app, item_spec))
        except Exception:  # untraceable map: key on the app's identity
            sig = f"uid:{_fallback_uid(app)}:{type(app).__qualname__}"
        memo[key] = _digest(sig, spec_sig)
    return memo[key]


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one leaf of an items pytree (the reference's
    ShapeDtypeStruct)."""

    shape: tuple[int, ...]
    dtype: torch.dtype


def spec_sig_of(spec_tree) -> str:
    leaves, treedef = pytree.tree_flatten(spec_tree)
    return f"{treedef}:" + ",".join(_spec_part(x.shape, x.dtype)
                                    for x in leaves)


def items_spec_of(items):
    """:class:`TensorSpec` pytree of ``items`` (tensors or numpy arrays;
    specs pass through)."""
    def one(a):
        if isinstance(a, TensorSpec):
            return a
        t = torch.as_tensor(a) if not isinstance(a, torch.Tensor) else a
        return TensorSpec(tuple(t.shape), t.dtype)
    return pytree.tree_map(one, items)


def item_spec_of(items_spec):
    """One-item spec: ``items_spec`` without its leading (batch) axis."""
    return pytree.tree_map(lambda a: TensorSpec(tuple(a.shape[1:]), a.dtype),
                           items_spec)


def bucket_items(n: int, policy: str = "exact") -> int:
    """The N-bucket of the compiled key: ``"exact"`` keeps the item count;
    ``"pow2"`` rounds it up to the next power of two, so that nearby batch
    sizes share one compiled entry."""
    if policy == "exact":
        return int(n)
    if policy == "pow2":
        b = 1
        while b < n:
            b <<= 1
        return b
    raise ValueError(f"unknown items bucket policy {policy!r}")


#: module constants the planner and the collectors size their plans from;
#: the plan key names their values, so a change (a tuning, a test's patch)
#: never serves a plan made under others
PLANNER_CONSTANTS = {
    "repro_torch.kernels.ops": (
        "MAX_RADIX_LEVELS", "MAX_RADIX_FANOUT", "LEAF_BUCKET_CAP",
        "SEGMENT_TABLE_BYTES", "KERNEL_MAX_LEVEL_BUCKETS",
        "FOLD_TABLE_FLOATS", "FOLD_LANE_MAX_KEYS"),
    "repro_torch.core.autotune": (
        "CUDA_CHUNK_PAIRS", "CPU_CHUNK_PAIRS", "CPU_SORT_CHUNK_PAIRS"),
    "repro_torch.core.collector": (
        "DENSE_FOLD_ELEMS_BUDGET", "ONEHOT_MAX_KEYS",
        "ADDITIVE_FOLD_PAIRS_FUSED", "SCATTER_SORT_MIN_KEYS"),
    "repro_torch.core.cost_model": ("CPU_COEFF", "CUDA_COEFF"),
}


def planner_sig() -> str:
    import importlib

    return ";".join(
        f"{name}={getattr(importlib.import_module(mod), name)!r}"
        for mod, names in PLANNER_CONSTANTS.items() for name in names)


def _manual_sig(app) -> str:
    """A manual combiner's part of the plan key: the spec object itself
    (kept alive by the cached plan, so its id is not reused)."""
    spec = getattr(app, "manual_combiner", None)
    return "none" if spec is None else f"{spec.describe}@{id(spec)}"


def plan_key(app, *, flow: str, trust_semantics: bool,
             n_pairs_hint: int | None, use_kernels: bool,
             combine_impl: str, chunk_pairs, key_block,
             autotune_probe: bool, device, streaming: bool = False) -> str:
    """Key of the plan stage (derivation, flow choice, tiling): everything
    ``MapReduce`` resolves before it sees item shapes, with the device type
    (the ``cpu`` and ``cuda`` cost profiles and tilings plan differently),
    the resolved ``use_kernels``, a manual combiner, the streaming pin
    (a streaming plan and a local one of the same app never share an
    entry) and :func:`planner_sig`."""
    return _digest(
        "plan", reduce_fingerprint(app), _app_attr_sig(app),
        f"flow={flow}", f"trust={trust_semantics}",
        f"hint={n_pairs_hint}", f"kern={use_kernels}",
        f"impl={combine_impl}", f"chunk={chunk_pairs}",
        f"blk={key_block}", f"probe={autotune_probe}",
        f"streaming={streaming}",
        f"dev={torch.device(device).type}", f"manual={_manual_sig(app)}",
        planner_sig())


def compiled_key(app, items_spec, *, plan_key: str, flow: str,
                 n_bucket: int, device, mode: str = "local", mesh=None,
                 extra: tuple = ()) -> str:
    """Key of the compiled stage: the plan key x the map graph over the item
    spec x the (bucketed) batch shape x the device (``cuda:0``) x the mesh
    (its kind, size, axis and backend) x the mode and the resolved lowering
    knobs."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh_sig = "none" if mesh is None else mesh.signature()
    return _digest(
        "compiled", plan_key,
        map_fingerprint(app, item_spec_of(items_spec)),
        spec_sig_of(items_spec), f"N={n_bucket}", f"flow={flow}",
        f"device={dev}", f"mesh={mesh_sig}", f"mode={mode}",
        *[str(x) for x in extra])


# ---------------------------------------------------------------------------
# In-memory layers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanEntry:
    """The cached plan stage: the plan (a template) and its tiling."""

    plan: Any
    tiling: Any


@dataclasses.dataclass
class CompiledEntry:
    """The cached compile stage: the prepared run (mode "local" and
    "pipeline"; mode "distributed", an ``engine.DistributedRun``) or the
    ingest (mode "streaming", an ``engine.StreamIngest``, whose
    ``combiner`` is the reference's ``aux``).  Mode "resilient" builds one
    (its driver) but never caches it."""

    executable: Any
    mode: str  # "local" | "pipeline" | "streaming" | "distributed" | ...
    #: the warm-up call's ``torch.cuda.max_memory_allocated`` (card only)
    warmup_peak_bytes: int | None = None


_PLANS: dict[str, PlanEntry] = {}
_COMPILED: dict[str, CompiledEntry] = {}


def plan_get(key: str) -> PlanEntry | None:
    hit = _PLANS.get(key)
    if hit is None:
        STATS.plan_misses += 1
    else:
        STATS.plan_hits += 1
    return hit


def plan_put(key: str, entry: PlanEntry) -> None:
    _PLANS[key] = entry


def compiled_get(key: str) -> CompiledEntry | None:
    hit = _COMPILED.get(key)
    if hit is None:
        STATS.misses += 1
    else:
        STATS.hits += 1
    return hit


def compiled_put(key: str, entry: CompiledEntry) -> None:
    _COMPILED[key] = entry


def clear() -> None:
    """Drop both in-memory layers (the file layer stays)."""
    _PLANS.clear()
    _COMPILED.clear()


def sizes() -> tuple[int, int]:
    return len(_PLANS), len(_COMPILED)


# ---------------------------------------------------------------------------
# File layer (plan decisions across processes)
# ---------------------------------------------------------------------------

#: fields an entry must carry, with these types, to be read
_FILE_SCHEMA = {"flow": str, "chunk_pairs": int}
_FILE_OPTIONAL = {"key_block": int, "bucket_size": int,
                  "level_fanouts": list, "card": str}


def plan_cache_path() -> str | None:
    p = os.environ.get(PLAN_CACHE_ENV, "").strip()
    return p or None


def load_json(path: str) -> dict:
    """A JSON object from ``path``; IO and parse failures read as {}."""
    try:
        with open(path) as f:
            data = json.load(f)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def store_json(path: str, key: str, entry: dict) -> bool:
    """Merge one entry into the JSON file at ``path`` (atomic replace;
    best effort: a cache must never break a run)."""
    try:
        data = load_json(path)
        data[key] = entry
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return True
    except OSError:
        return False


def _entry_valid(entry) -> bool:
    if not isinstance(entry, dict):
        return False
    for field, typ in _FILE_SCHEMA.items():
        if not isinstance(entry.get(field), typ):
            return False
    for field, typ in _FILE_OPTIONAL.items():
        if entry.get(field) is not None and not isinstance(entry[field], typ):
            return False
    return entry["flow"] in ("stream", "sort", "combine", "reduce")


def file_get(key: str, device) -> dict | None:
    """The file layer's entry for ``key``, or None: no file, corrupt JSON,
    a malformed or stale entry, or an entry made on another card than the
    one ``device`` names."""
    path = plan_cache_path()
    if path is None:
        return None
    entry = load_json(path).get(key)
    if not _entry_valid(entry):
        return None
    if entry.get("card") is not None and entry["card"] != _card_of(device):
        return None
    STATS.file_hits += 1
    return entry


def file_put(key: str, entry: dict) -> bool:
    path = plan_cache_path()
    if path is None:
        return False
    return store_json(path, key, entry)


def _card_of(device) -> str | None:
    from repro_torch.device import card_identity

    dev = torch.device(device)
    return card_identity(dev) if dev.type == "cuda" else None


def file_entry_from(plan, tiling, device) -> dict:
    """The file layer's record of a resolved plan stage; a stream or sort
    entry made on the card names the card (name, power limit)."""
    entry: dict[str, Any] = {"flow": plan.flow}
    if tiling is None:
        entry["chunk_pairs"] = 0
        return entry
    entry["chunk_pairs"] = int(tiling.chunk_pairs)
    entry["key_block"] = int(tiling.key_block)
    entry["level_fanouts"] = [int(f) for f in
                              getattr(tiling, "level_fanouts", ())]
    card = _card_of(device)
    if card is not None:
        entry["card"] = card
    return entry
