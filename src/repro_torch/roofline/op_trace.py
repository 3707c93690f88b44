"""Cost accounting over a trace of the port's own calls.

Counterpart of ``repro/roofline/hlo_parser.py``.  The reference re-derives
FLOPs, bytes accessed and collective wire bytes from the text of XLA's
compiled module.  The port has no compiled module: its program is the
stream of ATen ops, kernel launches and collectives that one call
dispatches, so this module records that stream while the call runs, and
:func:`analyze_trace` applies the reference's rules to it.

* :func:`trace` runs ``fn`` for real, on whatever device its tensors are
  on (or under the caller's ``FakeTensorMode``), under a
  ``TorchDispatchMode`` that records one :class:`OpRecord` an ATen op, and
  ``MemTracker`` for the peak of what the call holds beyond its
  arguments.
* Each kernel entry point of ``kernels/ops.py`` records itself as one op,
  ``repro_torch::<kernel>`` (:func:`kernel`), and hides the ops inside it:
  on the card a kernel is an extension call the dispatcher never sees, on
  the CPU the same call runs its plain version's ATen ops.  A kernel op's
  bytes are its tensor inputs read once and outputs written once, so a
  call counts the same ops and bytes on either device.
* The shard mesh's collectives (``distributed/mesh.py``) record
  themselves the same way (:func:`collective`, ``mesh::<method>``), and
  ``torch.distributed``'s collectives are recorded where they reach the
  dispatcher (``c10d::*``, ``_c10d_functional::*``: the dry-run's DTensor
  redistributions).
* :func:`repeat` is the reference's while-loop trip count: the ops
  recorded inside it count ``n`` times.  :func:`loop` marks a loop body
  whose trip count the tracer's caller sets with :func:`trips` (the
  dry-run's microbatch: one traced microbatch stands for M).

Accounting (the reference's rules, restated for eager PyTorch):

* FLOPs: a contraction (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  attention, convolution: ``FlopCounterMode``'s formulas) counts
  2·|out|·|contracted|; elementwise and transcendental ops |out|;
  reductions |in|; data movement and views none.  A kernel counts the
  formula it registers: ``flash_decode.traced_flops`` for B8, |values|
  (the elements its fold reads) for B1–B7, and ``int_fold`` an add a
  pair and column and one for its count (n·(D + 1) with counts).
* Bytes: each op |out| + Σ|operands|; views and metadata none
  (:data:`NO_BYTES`).  A tensor is counted at its own size (a broadcast
  view at its distinct elements), so an in-place
  write into a view (``x.narrow(...).copy_(y)``, the decode's cache write)
  counts the view, not its base, and an overwrite (``copy_``, ``fill_``)
  does not read its destination: the reference's in-place
  dynamic-update-slice rule.  Gathers (``index_select``, ``gather``,
  ``embedding``, ``index``) count 2·|out|; scatters (``index_add_``,
  ``scatter_add_``, ``scatter_reduce_``, ``index_put_``, ...) count
  3·|updates|.
* Where the port departs from the TPU rule on purpose (ROADMAP C.72): the
  reference gives standalone elementwise ops no bytes because XLA:TPU
  fuses them; an eager step does not fuse, so they count here.
* Wire bytes: a collective counts its per-shard buffer times the
  reference's ring factor (:func:`_wire_factor`) times its multiplicity,
  ``n`` the process group's or the mesh's size.  The buffer is the larger
  of a shard's input and output: the output for an all-reduce, all-gather
  and all-to-all, as the reference; a reduce-scatter's input, since its
  output is the 1/n shard and a ring moves (n-1)/n of the whole
  (ROADMAP C.72).

A trace is per thread (the dispatch mode stack and the hooks' context are
the tracing thread's).  With no trace active, a hook costs one context
variable read and a call.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ATen ops that move no bytes (views and metadata)
NO_BYTES = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "t", "transpose", "permute",
    "slice", "select", "unsqueeze", "squeeze", "detach", "alias",
    "as_strided", "split", "split_with_sizes", "chunk", "unbind", "narrow",
    "view_as", "lift_fresh", "empty", "empty_like", "empty_strided",
    "new_empty", "new_empty_strided", "_reshape_alias", "diagonal",
    "unfold", "view_as_real", "view_as_complex", "movedim", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "record_stream", "_wrap_tensor_autograd", "wait_tensor",
    "resize_", "set_"})

#: ops that read only what they emit: 2·|out| (the reference's gather)
GATHERS = frozenset({"index_select", "gather", "embedding", "index",
                     "_unsafe_index"})

#: ops that write rows of their destination: 3·|updates| (the reference's
#: scatter, a read-modify-write of the touched rows)
SCATTERS = frozenset({
    "index_add", "index_add_", "scatter_add", "scatter_add_",
    "scatter_reduce", "scatter_reduce_", "index_put", "index_put_",
    "_index_put_impl_", "scatter", "scatter_", "index_copy", "index_copy_"})

#: in-place ops that overwrite their destination without reading it
OVERWRITES = frozenset({"copy_", "fill_", "zero_", "normal_", "uniform_",
                        "random_", "bernoulli_", "exponential_"})

#: reductions: |in| FLOPs
REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "all", "any", "norm", "linalg_vector_norm", "var", "std", "var_mean",
    "std_mean", "logsumexp", "cumsum", "cumprod", "nansum",
    "count_nonzero"})

#: data movement, creation and random numbers: bytes only, no FLOPs (the
#: reference's copy, concatenate, gather, scatter, iota, rng, sort, ...)
MOVES = GATHERS | SCATTERS | OVERWRITES | frozenset({
    "_to_copy", "clone", "contiguous", "cat", "stack", "sort", "argsort",
    "topk", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "fill", "arange", "new_zeros", "new_ones", "new_full", "repeat",
    "repeat_interleave", "constant_pad_nd", "flip", "roll", "slice_scatter",
    "select_scatter", "diagonal_scatter", "as_strided_scatter", "randn",
    "rand", "randint", "randperm", "normal", "bernoulli", "nonzero",
    "unique", "_unique2", "unique_consecutive", "_local_scalar_dense",
    "lift_fresh_copy", "scalar_tensor", "masked_select", "tril", "triu"})

#: collectives by the reference's opcode: the ``c10d`` / ``_c10d_functional``
#: ops that reach the dispatcher, and the mesh's methods
COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
    "psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
    "all_gather": "all-gather", "all_to_all": "all-to-all",
    "psum_scatter": "reduce-scatter"}

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

#: dispatcher ops that are no work on tensors (``prim::device``, the
#: profiler's markers)
_SILENT_NAMESPACES = ("prim", "profiler")


def _wire_factor(op: str, n: int) -> float:
    """The reference's ring factor of collective ``op`` over ``n`` ranks
    (``hlo_parser._wire_factor``)."""
    if n <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (n - 1) / n
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return float(n - 1) / n
    return 1.0


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One op of a traced call.

    ``in_bytes`` / ``out_bytes`` (and ``_elems``) are what the op reads and
    writes (an overwrite's destination is written, not read); ``upd_bytes``
    a scatter's updates.  ``inplace``: the output is the op's first
    argument.  A collective has its reference opcode in ``collective``, the
    ranks of its ring in ``group`` (0: unknown) and, on a ``LocalMesh``,
    the shards one call stands for in ``shards``.  ``mult`` is the
    multiplicity (:func:`repeat`)."""

    name: str
    in_bytes: int = 0
    out_bytes: int = 0
    in_elems: int = 0
    out_elems: int = 0
    flops: float = 0.0
    upd_bytes: int = 0
    inplace: bool = False
    collective: str | None = None
    group: int = 1
    shards: int = 1
    mult: float = 1.0


@dataclasses.dataclass(frozen=True)
class Trace:
    """The ops of one traced call, in order, and the peak of what it
    allocated (``MemTracker``'s, bytes; 0.0 when it saw no allocation)."""

    ops: tuple
    peak_bytes: float = 0.0
    warnings: tuple = ()

    def count(self, name: str) -> float:
        """Calls of op ``name``, each at its multiplicity."""
        return sum(op.mult for op in self.ops if op.name == name)


@dataclasses.dataclass
class OpCost:
    """The counterpart of ``hlo_parser.HloCost``: totals, per-collective
    ``{count, bytes}``, and where the bytes and FLOPs live by op name;
    ``peak_bytes`` the trace's peak (the reference reads it from
    ``memory_analysis()``)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: dict = dataclasses.field(default_factory=dict)
    warnings: list = dataclasses.field(default_factory=list)
    bytes_by_op: dict = dataclasses.field(default_factory=dict)
    flops_by_op: dict = dataclasses.field(default_factory=dict)
    op_counts: dict = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0

    def top_bytes(self, n: int = 8):
        return sorted(self.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]


# ---------------------------------------------------------------------------
# Tensors and their bytes
# ---------------------------------------------------------------------------


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _tensors(tree) -> list:
    from torch.utils import _pytree as pytree

    return [_local(x) for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _size(ts) -> tuple[int, int]:
    """(bytes, elements) of a list of tensors, each at its distinct
    elements: a broadcast view (stride 0) is read once an element it
    holds."""
    n = b = 0
    for t in ts:
        k = t.numel()
        if k > 1 and 0 in t.stride():
            k = 1
            for size, stride in zip(t.shape, t.stride()):
                if stride:
                    k *= size
        n += k
        b += k * t.element_size()
    return b, n


# ---------------------------------------------------------------------------
# The recorder and its dispatch mode
# ---------------------------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.ops: list[OpRecord] = []
        self.warnings: list[str] = []
        self.mult = 1.0
        self.depth = 0  # > 0 inside a kernel or mesh collective
        self.trips: dict[str, int] = {}

    def add(self, **fields) -> None:
        self.ops.append(OpRecord(mult=self.mult, **fields))

    def opaque(self, name, fn, args, kw, *, flops=None, collective=None,
               group=1, shards=1):
        """Run ``fn(*args, **kw)`` as one op ``name``; the ops inside are
        hidden."""
        self.depth += 1
        try:
            out = fn(*args, **kw)
        finally:
            self.depth -= 1
        if self.depth == 0:
            ins, outs = _tensors((args, kw)), _tensors(out)
            ib, ie = _size(ins)
            ob, oe = _size(outs)
            self.add(name=name, in_bytes=ib, out_bytes=ob, in_elems=ie,
                     out_elems=oe,
                     flops=float(flops(ins, outs)) if flops else 0.0,
                     collective=collective, group=group, shards=shards)
        return out


_ACTIVE: contextvars.ContextVar[_Recorder | None] = contextvars.ContextVar(
    "repro_torch_op_trace", default=None)


def _op_flops(func, name, args, kwargs, out, out_elems) -> float:
    from torch.utils.flop_counter import flop_registry

    formula = flop_registry.get(func.overloadpacket)
    if formula is not None:
        from torch.utils import _pytree as pytree

        a, k, o = pytree.tree_map(_local, (args, kwargs, out))
        return float(formula(*a, **k, out_val=o))
    if name in MOVES or name in NO_BYTES:
        return 0.0
    if name in REDUCTIONS:
        first = next(iter(_tensors(args)), None)
        return float(first.numel()) if first is not None else 0.0
    return float(out_elems)


def _group_size(func, args) -> int:
    """The ranks of a ``c10d`` / ``_c10d_functional`` collective (0 when it
    names none the tracer can read)."""
    import torch.distributed as dist

    for a, v in zip(func._schema.arguments, args):
        if a.name == "group_size":
            return int(v)
        if "ProcessGroup" in str(a.type):
            try:
                return dist.ProcessGroup.unbox(v).size()
            except (AttributeError, RuntimeError, TypeError):
                return int(v.size())
        if a.name == "group_name":
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)

            return _resolve_process_group(v).size()
    return 0


def _collective_io(func, args, kwargs, out):
    """(inputs, outputs) of a ``c10d`` / ``_c10d_functional`` collective:
    the in-place ``c10d`` ops name them in their schema (``tensors`` is
    both), the functional ones return their output."""
    if func.namespace == "_c10d_functional":
        return _tensors((args, kwargs)), _tensors(out)
    ins, outs = [], []
    for a, v in zip(func._schema.arguments, args):
        if a.name.startswith("output"):
            outs += _tensors(v)
        elif a.name.startswith("input") or a.name == "tensors":
            ins += _tensors(v)
            if a.name == "tensors":
                outs += _tensors(v)
    return ins, outs


class _Mode(TorchDispatchMode):
    """The dispatch mode of :func:`trace`: one record an ATen op outside a
    kernel or mesh collective."""

    def __init__(self, rec: _Recorder):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        super().__init__()
        self.rec = rec
        self.dtensor = DTensor
        self.active_fake_mode = active_fake_mode
        self.fake = active_fake_mode()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        # DTensor desugars into local ops and collectives, which come back
        # here at a rank's shapes (MemTracker's rule)
        if any(t is self.dtensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # a rank's ops only: not those DTensor's sharding propagation runs
        # under a fake mode of its own
        if self.rec.depth == 0 and self.active_fake_mode() is self.fake:
            _record_aten(self.rec, func, args, kwargs, out)
        return out


def _record_aten(rec: _Recorder, func, args, kwargs, out) -> None:
    ns = func.namespace
    name = func.overloadpacket.__name__
    full = f"{ns}::{name}"
    if ns in _COLLECTIVE_NAMESPACES:
        kind = COLLECTIVE_OPS.get(name)
        if kind is None:
            if _tensors((args, kwargs)) and name not in NO_BYTES:
                rec.warnings.append(f"unaccounted collective {full}")
            return
        ins, outs = _collective_io(func, args, kwargs, out)
        ib, ie = _size(ins)
        ob, oe = _size(outs)
        rec.add(name=full, in_bytes=ib, out_bytes=ob, in_elems=ie,
                out_elems=oe, collective=kind,
                group=_group_size(func, args))
        return
    if ns in _SILENT_NAMESPACES:
        return
    outs = _tensors(out)
    dest = kwargs.get("out")
    mutable = bool(func._schema.arguments) and (
        func._schema.arguments[0].alias_info is not None
        and func._schema.arguments[0].alias_info.is_write)
    operands = [a for i, a in enumerate(args)
                if not (i == 0 and mutable and name in OVERWRITES)]
    ins = _tensors((operands, {k: v for k, v in kwargs.items()
                               if k != "out"}))
    if dest is not None:
        outs = _tensors(dest)
    ib, ie = _size(ins)
    ob, oe = _size(outs)
    upd = 0
    if name in SCATTERS:
        for a, v in zip(func._schema.arguments, args):
            if a.name in ("values", "source", "src") and isinstance(
                    v, torch.Tensor):
                upd = _size([_local(v)])[0]
        if not upd and len(args) > 2 and isinstance(args[2], torch.Tensor):
            # a scalar scattered at every index: the index's rows
            upd = args[2].numel() * (outs[0].element_size() if outs else 4)
    rec.add(name=full, in_bytes=ib, out_bytes=ob, in_elems=ie,
            out_elems=oe, upd_bytes=upd, inplace=mutable,
            flops=_op_flops(func, name, args, kwargs, out, oe))


# ---------------------------------------------------------------------------
# The public surface
# ---------------------------------------------------------------------------


def trace(fn, *args, **kw):
    """Run ``fn(*args, **kw)`` and record what it dispatches:
    ``(result, Trace)``.  Under the caller's ``FakeTensorMode`` nothing is
    computed.  The peak is ``MemTracker``'s over the call less the
    arguments' storages (the tensors in ``args`` and ``kw``, live
    throughout): the most the call itself held at once.  A tensor the call
    reaches otherwise (a closure's) counts once the call makes a view of
    it, as ``MemTracker`` counts it."""
    from torch.distributed._tools.mem_tracker import MemTracker

    rec = _Recorder()
    tracker = MemTracker()
    tracker.track_external(*_tensors((args, kw)))
    base = {dev: float(v["Total"])
            for dev, v in tracker.get_tracker_snapshot().items()}
    token = _ACTIVE.set(rec)
    try:
        with tracker, _Mode(rec):
            result = fn(*args, **kw)
    finally:
        _ACTIVE.reset(token)
    peak = max((float(v["Total"]) - base.get(dev, 0.0) for dev, v in
                tracker.get_tracker_snapshot("peak").items()), default=0.0)
    return result, Trace(tuple(rec.ops), peak_bytes=peak,
                         warnings=tuple(rec.warnings))


@contextlib.contextmanager
def repeat(n: int):
    """Ops recorded inside count ``n`` times (nested repeats multiply): the
    counterpart of a while loop's ``known_trip_count``.  Outside a trace it
    does nothing."""
    rec = _ACTIVE.get()
    if rec is None:
        yield
        return
    prev = rec.mult
    rec.mult = prev * n
    try:
        yield
    finally:
        rec.mult = prev


@contextlib.contextmanager
def trips(**counts: int):
    """Set the trip counts :func:`loop` bodies of the active trace take
    (``trips(microbatch=M)``: one traced microbatch stands for M)."""
    rec = _ACTIVE.get()
    if rec is None:
        yield
        return
    prev = dict(rec.trips)
    rec.trips.update(counts)
    try:
        yield
    finally:
        rec.trips = prev


def loop(name: str):
    """A loop body: :func:`repeat` of the trip count the active trace's
    caller set for ``name`` (:func:`trips`; 1 when it set none)."""
    rec = _ACTIVE.get()
    return repeat(rec.trips.get(name, 1) if rec is not None else 1)


def _kernel_flops(name: str):
    if name == "flash_decode":
        def flops(ins, outs):
            from repro_torch.kernels.flash_decode import traced_flops

            return traced_flops(*(tuple(t.shape) for t in ins[:4]))
    elif name == "onehot_fold":
        def flops(ins, outs):  # an add per pair and column of acc: with
            return ins[0].numel() * ins[2].shape[1]  # counts, one past D
    elif name == "int_fold":
        def flops(ins, outs):  # an add per pair and column, and its count
            return ins[0].numel() * (ins[1].shape[1] + (len(ins) > 3))
    else:
        def flops(ins, outs):  # the elements the fold reads: its values
            return ins[1].numel() if len(ins) > 1 else 0
    return flops


def kernel(name: str, fn, *args, **kw):
    """Run a kernel (or, on the CPU, its plain version) as one op
    ``repro_torch::<name>`` of the active trace; ``fn(*args, **kw)``
    otherwise."""
    rec = _ACTIVE.get()
    if rec is None:
        return fn(*args, **kw)
    return rec.opaque(f"repro_torch::{name}", fn, args, kw,
                      flops=_kernel_flops(name))


def collective(name: str, group: int, shards: int, fn, *args):
    """Run a mesh collective as one op ``mesh::<name>`` of the active
    trace over ``group`` ranks, standing for ``shards`` shards' calls (a
    ``LocalMesh`` runs them all); ``fn(*args)`` otherwise."""
    rec = _ACTIVE.get()
    if rec is None:
        return fn(*args)
    return rec.opaque(f"mesh::{name}", fn, args, {},
                      collective=COLLECTIVE_OPS[name], group=group,
                      shards=shards)


def _op_bytes(op: OpRecord) -> float:
    short = op.name.split("::", 1)[1]
    if short in NO_BYTES:
        return 0.0
    if op.name.startswith("aten::"):
        if short in GATHERS:
            return 2.0 * op.out_bytes
        if short in SCATTERS:
            return 3.0 * op.upd_bytes
    return float(op.in_bytes + op.out_bytes)


def analyze_trace(trace: Trace, *, default_group: int = 1) -> OpCost:
    """FLOPs, bytes accessed and collective wire bytes of a trace, each op
    at its multiplicity (the counterpart of ``hlo_parser.analyze_text``).
    ``default_group`` stands for a collective whose ranks the trace could
    not read."""
    cost = OpCost(peak_bytes=trace.peak_bytes, warnings=list(trace.warnings))
    for op in trace.ops:
        m = op.mult
        b = m * _op_bytes(op)
        f = m * op.flops
        cost.flops += f
        cost.bytes_accessed += b
        cost.bytes_by_op[op.name] = cost.bytes_by_op.get(op.name, 0.0) + b
        if f:
            cost.flops_by_op[op.name] = cost.flops_by_op.get(op.name,
                                                             0.0) + f
        cost.op_counts[op.name] = cost.op_counts.get(op.name, 0.0) + m
        if op.collective is not None:
            n = op.group or default_group
            shard = max(op.in_bytes, op.out_bytes) / max(op.shards, 1)
            wire = m * shard * _wire_factor(op.collective, n)
            cost.collective_bytes += wire
            rec = cost.collective_ops.setdefault(
                op.collective, {"count": 0.0, "bytes": 0.0})
            rec["count"] += m
            rec["bytes"] += wire
    return cost
