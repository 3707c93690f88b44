"""Semantic analysis of a PyTorch ``reduce`` by walking its aten graph.

Counterpart of ``repro/core/semantics.py``, which slices the reducer's
jaxpr.  Here ``reduce(key, values[L], count)`` is traced with
``make_fx(..., tracing_mode="fake")`` on fake tensors (no user code runs on
data), and the aten graph is sliced into

    ``premap``   (pointwise and shape ops, per value — map side)
  ∘ ``frontier`` (sum/prod/amax/amin/max/min/all/any over dim 0, or the
                  idioms: ``values[0]`` only, or the count only)
  ∘ ``finalize`` (anything after the frontier).

A node is *tainted* when its value varies along the values axis (dim 0).
Tainted nodes must be premap ops that keep dim 0 in place, or frontiers.
Because every premap op keeps the values axis at dim 0, the premap runs on
a whole batch ``[n, *value_shape]`` with the graph's own ops: only ops that
spell out the size ``L`` (view, reshape, expand, a full slice of dim 0)
are rewritten for ``n``.

The reference's scan-fold strategy (a ``lax.scan`` over values) has no
aten counterpart: a Python loop over values unrolls into selects of
positions other than 0, and ``cumsum``-style scans run over dim 0; both
are an :class:`ExtractionFailure` that names it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.fx import Node
from torch.fx.experimental.proxy_tensor import make_fx

from repro_torch import numerics
from repro_torch.core import combiner as C

aten = torch.ops.aten


def _overloads(*names: str) -> list:
    out = []
    for name in names:
        packet, _, overload = name.partition(".")
        op = getattr(getattr(aten, packet, None), overload or "default", None)
        if op is not None:
            out.append(op)
    return out


#: dim-0 reductions the frontier maps onto monoids
REDUCE_MONOIDS = {}
for _names, _monoid in (
        (("sum.dim_IntList", "sum.default"), C.ADD),
        (("prod.dim_int", "prod.default"), C.MUL),
        (("amax.default", "max.default"), C.MAX),
        (("amin.default", "min.default"), C.MIN),
        (("all.default", "all.dim", "all.dims"), C.AND),
        (("any.default", "any.dim", "any.dims"), C.OR)):
    for _op in _overloads(*_names):
        REDUCE_MONOIDS[_op] = _monoid

#: value-preserving ops that are not tagged pointwise
COPIES = set(_overloads("_to_copy.default", "clone.default", "alias.default",
                        "detach.default", "lift_fresh_copy.default"))
SCANS = set(_overloads("cumsum.default", "cumprod.default", "cummax.default",
                       "cummin.default", "logcumsumexp.default"))
VIEWS = set(_overloads("view.default", "reshape.default",
                       "_unsafe_view.default"))
EXPAND = aten.expand.default
SELECT = aten.select.int
SLICE = aten.slice.Tensor
UNSQUEEZE = aten.unsqueeze.default
SQUEEZES = set(_overloads("squeeze.dim", "squeeze.dims"))
PERMUTE = aten.permute.default
TRANSPOSE = aten.transpose.int

SCAN_FOLD_MSG = ("the reference's scan-fold strategy has no aten "
                 "counterpart in the port")


class ExtractionFailure(Exception):
    """Raised when the reduce fn cannot be sliced into a combiner triple."""


def _shape(x) -> tuple[int, ...]:
    return tuple(x.meta["val"].shape)


def _ndim(x) -> int:
    return len(_shape(x))


def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def _arg(node: Node, i: int, name: str, default=None):
    if len(node.args) > i:
        return node.args[i]
    return node.kwargs.get(name, default)


def _nodes_in(args) -> list[Node]:
    out: list[Node] = []
    torch.fx.node.map_arg(args, out.append)
    return out


def _reduce_dims(node: Node) -> tuple[tuple[int, ...], bool]:
    """(normalized reduced dims, keepdim) of a frontier-table reduction."""
    ndim = _ndim(node.args[0])
    name = node.target.overloadpacket.__name__
    overload = node.target._overloadname
    if overload == "default" and name in ("sum", "prod", "max", "min", "all",
                                          "any"):
        return tuple(range(ndim)), False
    dim = _arg(node, 1, "dim")
    keepdim = bool(_arg(node, 2, "keepdim", False))
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return tuple(range(ndim)), keepdim
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    return tuple(sorted(_norm(d, ndim) for d in dims)), keepdim


@dataclasses.dataclass
class Frontier:
    kind: str  # "monoid" | "first"
    node: Node
    monoid: C.Monoid | None = None
    #: reduced dims other than the values axis, in batched-channel
    #: coordinates (dim 0 is the batch); reduced in the premap
    extra_dims: tuple[int, ...] = ()
    #: dtype the channel is cast to and the holder accumulates in: the
    #: frontier's output dtype (torch sums integers into int64), except
    #: that sums and products over half precision accumulate in f32
    dtype: torch.dtype | None = None


def _holder_dtype(monoid: C.Monoid, dtype: torch.dtype) -> torch.dtype:
    """A half-precision sum or product holds f32 (``numerics``'s rule);
    ``finalize`` casts the holder back to the frontier's dtype."""
    if monoid.name in ("add", "mul") and dtype in numerics.HALF_DTYPES:
        return torch.float32
    return dtype


@dataclasses.dataclass
class Analysis:
    """Everything the optimizer needs to synthesize a CombinerSpec."""

    gm: torch.fx.GraphModule
    invars: list[Node]  # [key, values, count]
    output: Node
    frontiers: list[Frontier]
    premap_nodes: set


def trace(reduce_fn: Callable, key_spec: C.ValueSpec,
          value_spec: C.ValueSpec, max_len: int) -> torch.fx.GraphModule:
    values = C.ValueSpec((max_len,) + tuple(value_spec.shape),
                         value_spec.dtype).zeros(device="cpu")
    count = torch.zeros((), dtype=torch.int32)

    def fn(key, values, count):  # make_fx counts a bound method's self
        return reduce_fn(key, values, count)

    try:
        return make_fx(fn, tracing_mode="fake")(key_spec.zeros(device="cpu"),
                                                values,
                                                count)
    except Exception as e:  # the boundary to user code: whatever the
        # tracer refuses (data-dependent control flow, an op without a fake
        # implementation, an error in the reducer) means no combiner
        raise ExtractionFailure(
            f"reduce could not be traced on fake tensors: "
            f"{type(e).__name__}: {e}") from e


def analyze(reduce_fn: Callable, key_spec: C.ValueSpec,
            value_spec: C.ValueSpec, *, max_len: int = 8) -> Analysis:
    """Trace + slice ``reduce_fn(key, values, count)``.

    Raises :class:`ExtractionFailure` when the function is not expressible
    as premap ∘ frontier ∘ finalize under the rules in the module
    docstring."""
    gm = trace(reduce_fn, key_spec, value_spec, max_len)
    invars = [n for n in gm.graph.nodes if n.op == "placeholder"]
    if len(invars) != 3:
        raise ExtractionFailure("reduce must take exactly (key, values, "
                                "count)")
    key_node, values_node, count_node = invars
    L = max_len
    tainted = {values_node}
    count_tainted = {count_node}
    key_tainted = {key_node}
    frontiers: list[Frontier] = []
    premap_nodes: set = set()
    output = None

    for node in gm.graph.nodes:
        if node.op == "output":
            output = node
            continue
        if node.op != "call_function":
            continue
        ins = _nodes_in((node.args, node.kwargs))
        if not any(x in tainted for x in ins):
            if any(x in count_tainted for x in ins):
                count_tainted.add(node)
            if any(x in key_tainted for x in ins):
                key_tainted.add(node)
            continue
        op = node.target
        if any(x in count_tainted for x in ins):
            raise ExtractionFailure(
                f"{op}: count flows into the per-value (map-side) slice; a "
                "streaming combine cannot know the final count")
        if any(x in key_tainted for x in ins):
            raise ExtractionFailure(
                f"{op}: key flows into the per-value slice (keyed premap "
                "unsupported)")
        src = node.args[0] if node.args else None

        def premap():
            premap_nodes.add(node)
            tainted.add(node)

        if op in REDUCE_MONOIDS:
            if _shape(src)[:1] != (L,):
                raise ExtractionFailure(f"{op}: operand lost the values axis")
            dims, _ = _reduce_dims(node)
            if 0 in dims:
                monoid = REDUCE_MONOIDS[op]
                frontiers.append(Frontier(
                    "monoid", node, monoid=monoid,
                    extra_dims=tuple(d for d in dims if d != 0),
                    dtype=_holder_dtype(monoid, node.meta["val"].dtype)))
                continue
            premap()  # positionwise reduction over value dims
            continue

        if op in SCANS:
            if _norm(_arg(node, 1, "dim"), _ndim(src)) == 0:
                raise ExtractionFailure(f"{op} over the values axis: "
                                        f"{SCAN_FOLD_MSG}")
            premap()
            continue

        if op == SELECT:
            dim = _norm(node.args[1], _ndim(src))
            if dim != 0:
                premap()
                continue
            if _norm(node.args[2], L) == 0:
                frontiers.append(Frontier("first", node))  # idiom: values[0]
                continue
            raise ExtractionFailure(
                f"values[{node.args[2]}]: a position other than 0 (a fold "
                f"over the values positions: {SCAN_FOLD_MSG})")

        if op == SLICE:
            dim = _norm(_arg(node, 1, "dim", 0), _ndim(src))
            start = _arg(node, 2, "start") or 0
            end = _arg(node, 3, "end")
            step = _arg(node, 4, "step", 1)
            if dim != 0:
                premap()
                continue
            if start == 0 and step == 1 and (end is None or end >= L):
                premap()  # values[:] — identity along the values axis
                continue
            if start == 0 and step == 1 and end == 1:
                frontiers.append(Frontier("first", node))  # values[0:1]
                continue
            raise ExtractionFailure("slice of values other than values[0:1] "
                                    "or a full slice")

        if op == UNSQUEEZE:
            if _norm(node.args[1], _ndim(node)) == 0:
                raise ExtractionFailure("unsqueeze moves the values axis")
            premap()
            continue

        if op in SQUEEZES:
            dims = node.args[1]
            dims = (dims,) if isinstance(dims, int) else tuple(dims)
            if 0 in {_norm(d, _ndim(src)) for d in dims}:
                raise ExtractionFailure("squeeze removes the values axis")
            premap()
            continue

        if op in VIEWS or op == EXPAND:
            # row i of the values stays row i: dim 0 is L before and after
            if _shape(src)[:1] == (L,) and _shape(node)[:1] == (L,):
                premap()
                continue
            raise ExtractionFailure(f"{op} folds or moves the values axis")

        if op == PERMUTE:
            if _norm(node.args[1][0], _ndim(src)) != 0:
                raise ExtractionFailure("permute moves the values axis")
            premap()
            continue

        if op == TRANSPOSE:
            nd = _ndim(src)
            if 0 in (_norm(node.args[1], nd), _norm(node.args[2], nd)):
                raise ExtractionFailure("transpose moves the values axis")
            premap()
            continue

        if op in COPIES or torch.Tag.pointwise in getattr(op, "tags", ()):
            out_nd = _ndim(node)
            for x in ins:
                if "val" not in x.meta or not isinstance(x.meta["val"],
                                                         torch.Tensor):
                    continue
                shp = _shape(x)
                if x in tainted:
                    if len(shp) != out_nd or shp[:1] != (L,):
                        raise ExtractionFailure(
                            f"{op}: tainted operand lost the values axis")
                elif len(shp) >= out_nd and shp[:1] != (1,) and out_nd:
                    raise ExtractionFailure(
                        f"{op}: untainted operand carries the values axis "
                        "(possibly position-dependent, e.g. arange)")
            premap()
            continue

        raise ExtractionFailure(f"op {op} not allowed on values")

    out_nodes = _nodes_in(output.args)
    if any(x in tainted for x in out_nodes):
        raise ExtractionFailure("raw values escape to the reducer output")
    return Analysis(gm=gm, invars=invars, output=output,
                    frontiers=frontiers, premap_nodes=premap_nodes)


# ---------------------------------------------------------------------------
# Evaluators: the generated method bodies
# ---------------------------------------------------------------------------


def _constant(gm: torch.fx.GraphModule, node: Node, device):
    val = getattr(gm, node.target)
    return val.to(device) if isinstance(val, torch.Tensor) else val


def _call(node: Node, args, kwargs, device):
    if "device" in kwargs:  # factory ops traced on the CPU
        kwargs = dict(kwargs, device=device)
    return numerics.call(node.target, args, kwargs)


def build_premap(an: Analysis) -> Callable:
    """premap(values[n, ...]) -> tuple of frontier channels, each [n, ...]."""
    values_node = an.invars[1]
    gm = an.gm
    order = [n for n in gm.graph.nodes if n in an.premap_nodes]
    fronts = an.frontiers

    def premap(values: torch.Tensor) -> tuple:
        device = values.device
        env: dict = {values_node: values}

        def read(x):
            if not isinstance(x, Node):
                return x
            if x not in env:  # untainted producer chain (constants)
                if x.op == "get_attr":
                    env[x] = _constant(gm, x, device)
                else:
                    args, kwargs = torch.fx.node.map_arg(
                        (x.args, x.kwargs), read)
                    env[x] = _call(x, args, kwargs, device)
            return env[x]

        for node in order:
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs),
                                                 read)
            n = args[0].shape[0] if args and isinstance(
                args[0], torch.Tensor) else None
            if node.target in VIEWS:
                args = (args[0], [n] + list(args[1])[1:]) + tuple(args[2:])
            elif node.target == EXPAND:
                args = (args[0], [-1] + list(args[1])[1:]) + tuple(args[2:])
            elif node.target == SLICE and _norm(
                    _arg(node, 1, "dim", 0), _ndim(node.args[0])) == 0:
                env[node] = args[0]
                continue
            env[node] = _call(node, args, kwargs, device)

        out = []
        for f in fronts:
            x = read(f.node.args[0])
            if f.kind == "monoid":
                x = x.to(f.dtype)
                if f.extra_dims:
                    x = f.monoid.dense_reduce(x, f.extra_dims)
            out.append(x)
        # ``read`` calls itself, so it and ``env`` form a reference cycle:
        # emptied here, env's tensors go with this call, not at the next
        # garbage collection (device memory on the card)
        env.clear()
        return tuple(out)

    return premap


def build_finalize(an: Analysis) -> Callable:
    """finalize(key, holders, count) -> reducer output, for ONE key.

    Each frontier's output is replaced by its holder leaf (reshaped when
    the trace kept size-1 dims, and cast back to the frontier's dtype when
    it accumulated in f32); nodes that feed only the premap slice are
    skipped."""
    key_node, _, count_node = an.invars
    gm = an.gm
    skip = an.premap_nodes | {f.node for f in an.frontiers}
    order = [n for n in gm.graph.nodes
             if n.op in ("call_function", "get_attr") and n not in skip]
    fronts = [f.node for f in an.frontiers]
    output = an.output

    def finalize(key, holders, count):
        device = count.device
        env: dict = {key_node: key, count_node: count}
        for node, leaf in zip(fronts, holders):
            want = _shape(node)
            if tuple(leaf.shape) != want and leaf.numel() == int(
                    torch.Size(want).numel()):
                leaf = leaf.reshape(want)
            env[node] = leaf.to(node.meta["val"].dtype)

        def read(x):
            if isinstance(x, Node):
                return env[x]
            return x

        for node in order:
            if node.op == "get_attr":
                env[node] = _constant(gm, node, device)
                continue
            try:
                args, kwargs = torch.fx.node.map_arg(
                    (node.args, node.kwargs), read)
            except KeyError:
                continue  # feeds only the premap slice
            env[node] = _call(node, args, kwargs, device)
        return torch.fx.node.map_arg(output.args[0], read)

    return finalize
