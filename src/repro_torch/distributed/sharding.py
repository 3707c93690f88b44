"""Sharding rules: parameters, optimizer state, batches, decode state.

Counterpart of ``repro/distributed/sharding.py``, rule for rule: DP over
('pod', 'data'); the tensor-parallel dims of column/row pairs over 'model';
ZeRO-3 FSDP of the other param dim over the DP axes; experts over 'model';
KV caches head-sharded when the kv head count divides the model axis, else
sequence-sharded.  Every rule falls back to replication when a dim is not
divisible (``pick``), so every shard is even.

The specs are :class:`~repro_torch.models.common.P` trees in the structure
of the tree they describe, computed from the leaves' shapes alone (tensors,
fake or meta tensors), walked in JAX's leaf order (``ckpt.flatten``).  On a
``torch.distributed`` ``DeviceMesh`` whose dimension names are the spec's
axes, :func:`placements` turns a spec into DTensor placements: a tensor
dim sharded over a tuple of axes is ``Shard(d)`` on each of those mesh
dims, major to minor, which is how DTensor nests shards of one dim.
:func:`distribute` stores a tree so (ZeRO-3 at rest); the models compute
on plain tensors (``training.train_step``, ROADMAP C.70).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.models.common import ModelConfig, P, dp_axes, mesh_shape, pick

# ---------------------------------------------------------------------------
# Trees with paths, in JAX's order
# ---------------------------------------------------------------------------


def _walk_paths(x, path: tuple, out: list) -> None:
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _walk_paths(x[k], path + (str(k),), out)
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _walk_paths(v, path + (str(i),), out)
    else:
        out.append((path, x))


def leaves_with_paths(tree) -> list[tuple[tuple[str, ...], Any]]:
    """``(keys, leaf)`` in JAX's flatten order (``ckpt.flatten``'s)."""
    out: list = []
    _walk_paths(tree, (), out)
    return out


def _map_with_path(fn, tree):
    return unflatten(tree, [fn(path, leaf)
                            for path, leaf in leaves_with_paths(tree)])


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def _rule_for(path: tuple[str, ...], shape: tuple[int, ...], mesh,
              fsdp: bool) -> P:
    """Spec of the TRAILING dims the rule understands; leading stacking
    dims (layers / groups) are padded with None by the caller."""
    dp = dp_axes(mesh) if fsdp else ()
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""

    def fs(dim):
        return pick(mesh, dim, dp or None, dp[-1] if dp else None)

    def mp(dim):
        return pick(mesh, dim, "model")

    if name == "table" or (name == "w" and parent == "head"):  # [V, E]
        v, e = shape
        if mp(v) is not None:
            return P(mp(v), fs(e))
        return P(fs(v), mp(e))
    if name in ("wq", "wk", "wv"):  # [E, H*D] column-parallel
        return P(fs(shape[0]), mp(shape[1]))
    if name == "wo":  # [H*D, E] row-parallel
        return P(mp(shape[0]), fs(shape[1]))
    if name in ("bq", "bk", "bv"):
        return P(mp(shape[0]))
    if name in ("w_gate", "w_up"):
        if len(shape) == 3:  # MoE experts [X, E, F]
            return P(mp(shape[0]), fs(shape[1]), None)
        return P(fs(shape[0]), mp(shape[1]))  # dense [E, F]
    if name == "w_down":
        if len(shape) == 3:  # [X, F, E]
            return P(mp(shape[0]), None, fs(shape[2]))
        return P(mp(shape[0]), fs(shape[1]))  # [F, E]
    if name == "router":  # [E, X]
        return P(fs(shape[0]), None)
    if name == "w1":  # whisper mlp
        return P(fs(shape[0]), mp(shape[1]))
    if name == "w2":
        return P(mp(shape[0]), fs(shape[1]))
    if name == "b1":
        return P(mp(shape[0]))
    if name == "b2":
        return P(None)
    if name == "in_proj":  # ssm [E, O]
        return P(fs(shape[0]), mp(shape[1]))
    if name == "out_proj":  # ssm [d_in, E]
        return P(mp(shape[0]), fs(shape[1]))
    if name == "conv_w":  # [W, Ch]
        return P(None, mp(shape[1]))
    if name == "conv_b":
        return P(mp(shape[0]))
    if name in ("A_log", "D", "dt_bias"):
        return P(mp(shape[0]))
    if name == "pos_dec":  # [dec_len, E]
        return P(None, fs(shape[1]))
    # norms / scalars: replicated
    return P(*([None] * len(shape)))


_STACK_KEYS = ("layers", "groups", "tail", "enc_layers", "dec_layers")


def param_pspecs(params, mesh, *, fsdp: bool = True):
    """Tree of :class:`P` matching ``params`` (or an optimizer state whose
    ``master`` / ``m`` / ``v`` are parameter trees: the rules read the last
    two keys of a path)."""

    def one(keys, leaf):
        n_stack = 0
        for k in keys:
            if k in _STACK_KEYS:
                n_stack += 1
                if k == "groups":
                    n_stack += 1  # zamba groups are [G, k, ...]
        shape = _shape(leaf)
        spec = _rule_for(keys, shape[n_stack:], mesh, fsdp)
        return P(*([None] * n_stack + list(spec)))

    return _map_with_path(one, params)


# ---------------------------------------------------------------------------
# Batch / decode-state rules
# ---------------------------------------------------------------------------


def batch_pspecs(batch, mesh):
    """Shard the global batch dim over the DP axes; seq replicated."""
    dp = dp_axes(mesh)

    def one(keys, leaf):
        shape = _shape(leaf)
        b = shape[0] if shape else 1
        ax = pick(mesh, b, dp or None, dp[-1] if dp else None)
        return P(*([ax] + [None] * (len(shape) - 1)))

    return _map_with_path(one, batch)


def decode_state_pspecs(state, mesh, cfg: ModelConfig):
    """KV caches [L,B,S,Kv,D]: batch over DP; heads over model when
    divisible, else sequence over model.  SSM states [L,B,H,N,P]: heads
    over model.  pos: replicated."""
    del cfg
    dp = dp_axes(mesh)

    def one(keys, leaf):
        name = keys[-1] if keys else ""
        shp = _shape(leaf)

        def b_of(n):
            return pick(mesh, n, dp or None, dp[-1] if dp else None)

        if name in ("k", "v", "k_scale", "v_scale") or name.startswith(
                "cross_"):  # [L, B, S, Kv, D(|1)]
            b_ax = b_of(shp[1])
            if pick(mesh, shp[3], "model") is not None:
                return P(None, b_ax, None, "model", None)
            seq_axes = ("model",) if b_ax else ("data", "model")
            s_ax = pick(mesh, shp[2], seq_axes if b_ax is None else "model")
            return P(None, b_ax, s_ax, None, None)
        if name == "ssm":  # [L, B, H, N, P]
            return P(None, b_of(shp[1]), pick(mesh, shp[2], "model"), None,
                     None)
        if name == "conv":  # [L, B, W-1, Ch]
            return P(None, b_of(shp[1]), None, pick(mesh, shp[3], "model"))
        if name == "pos":
            return P()
        # fallback: shard dim 1 (batch-like) if possible
        if len(shp) >= 2:
            return P(*([None, b_of(shp[1])] + [None] * (len(shp) - 2)))
        return P(*([None] * len(shp)))

    return _map_with_path(one, state)


def tokens_pspec(batch: int, mesh) -> P:
    dp = dp_axes(mesh)
    return P(pick(mesh, batch, dp or None, dp[-1] if dp else None))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: DTensor placements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """A leaf's layout on a mesh: the ``DeviceMesh``, its DTensor
    ``placements`` (one a mesh dim) and the :class:`P` they come from (the
    counterpart of a ``NamedSharding``)."""

    mesh: Any
    placements: tuple
    spec: P


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh`` whose
    dimension names are the spec's axes): ``Shard(d)`` on every mesh dim
    that tensor dim ``d`` is sharded over, ``Replicate()`` on the others.
    A dim sharded over several axes takes them in the mesh's order, major
    to minor, as DTensor nests them."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, which the "
                                 f"mesh {names} lacks")
            if not isinstance(out[names.index(a)], Replicate):
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of a dim must come in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def shardings_of(specs, mesh):
    """A :class:`Sharding` for each :class:`P` of a spec tree."""
    return unflatten(specs, [Sharding(mesh, placements(s, mesh), s)
                             for s in flatten(specs)[0]])


def param_shardings(params, mesh, *, fsdp: bool = True):
    """``(mesh, placements)`` of every parameter leaf (a :class:`Sharding`
    each): the counterpart of the reference's ``NamedSharding`` tree."""
    return shardings_of(param_pspecs(params, mesh, fsdp=fsdp), mesh)


def local_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one rank's shard: each dim divided by the sizes of the
    axes it is sharded over (the rules shard evenly; an uneven dim takes
    the largest shard, DTensor's first)."""
    sizes = mesh_shape(mesh)
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        k = 1
        for a in axes:
            k *= sizes[a]
        out.append(-(-n // k))
    return tuple(out)


def local_nbytes(tree, shardings=None) -> int:
    """Bytes of one rank's shards of ``tree``: a DTensor leaf's local
    tensor, else the leaf's shard under its :class:`Sharding` (or whole
    when ``shardings`` is ``None``).  Python numbers count nothing."""
    from torch.distributed.tensor import DTensor

    leaves = flatten(tree)[0]
    shs = flatten(shardings)[0] if shardings is not None else [None] * len(
        leaves)
    total = 0
    for x, sh in zip(leaves, shs):
        if isinstance(x, DTensor):
            total += x.to_local().numel() * x.element_size()
        elif isinstance(x, torch.Tensor):
            shape = (local_shape(x.shape, sh.spec, sh.mesh) if sh is not None
                     else tuple(x.shape))
            n = 1
            for s in shape:
                n *= s
            total += n * x.element_size()
    return total


def distribute(tree, shardings):
    """``tree`` stored as DTensors in ``shardings`` (a :class:`Sharding`
    a leaf).  A tensor leaf is the same whole tensor on every rank, and
    each rank keeps its own shard of it (no communication); a Python
    number stays as it is."""
    from torch.distributed.tensor import distribute_tensor

    leaves = flatten(tree)[0]
    shs = flatten(shardings)[0]
    if len(shs) != len(leaves):
        raise ValueError(f"{len(shs)} shardings for {len(leaves)} leaves")
    out = []
    for x, sh in zip(leaves, shs):
        if not isinstance(x, torch.Tensor):  # a number (a state's pos)
            out.append(x)
        else:
            out.append(distribute_tensor(x, sh.mesh, list(sh.placements),
                                         src_data_rank=None))
    return unflatten(tree, out)


# ---------------------------------------------------------------------------
# Collectives of the sharded train step (ZeRO-3 over these layouts)
# ---------------------------------------------------------------------------


def _axis_sizes(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_axes(entry) -> tuple:
    """The axis names of one spec entry."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _count(comm, op: str, nbytes: float) -> None:
    if comm is not None:
        comm[op] = comm.get(op, 0.0) + float(nbytes)


def gather_full(x, dtype, comm=None) -> torch.Tensor:
    """The whole of a DTensor leaf, cast to ``dtype`` on its shard first
    (so that the all-gather moves ``dtype``), as a fresh plain tensor.
    ``comm`` counts the wire bytes a rank receives: ``(k - 1) / k`` of the
    whole over k shards."""
    from torch.distributed.tensor import DTensor

    local = x.to_local().to(dtype, copy=True)
    k = x.numel() // max(local.numel(), 1)
    _count(comm, "all_gather", (k - 1) * local.numel() * local.element_size())
    if k == 1:
        return local
    full = DTensor.from_local(local, x.device_mesh, x.placements,
                              shape=x.shape, stride=x.stride(),
                              run_check=False).full_tensor()
    return full


def reduce_to_shard(g: torch.Tensor, mesh, partial_axes: tuple,
                    target: tuple, comm=None) -> torch.Tensor:
    """Each rank's whole ``g``, summed over the mesh axes ``partial_axes``
    (the DP axes the batch is sharded over; the ranks of every other axis
    hold the same ``g``), as this rank's shard under the placements
    ``target``.  DTensor reduce-scatters over the partial axes a dim is
    sharded over and all-reduces over those it is replicated over, in its
    own fixed order: the mesh dims in turn, each partial axis's
    reduce-scatter or all-reduce on the tensor as the earlier dims left it,
    a dim sharded without a partial axis cut locally.  ``comm`` counts a
    rank's wire bytes so: ``(n - 1) / n`` of the tensor a reduce-scatter
    over n ranks takes, ``2 (n - 1) / n`` of it for an all-reduce."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    src = [Partial() if n in partial_axes else Replicate() for n in names]
    if not partial_axes and all(not isinstance(p, Shard) for p in target):
        return g
    out = DTensor.from_local(g, mesh, src, run_check=False).redistribute(
        mesh, list(target)).to_local()
    if comm is not None:
        size = float(g.numel() * g.element_size())
        for n, p in zip(names, target):
            k = mesh.size(names.index(n))
            if n in partial_axes:
                if isinstance(p, Shard):
                    _count(comm, "reduce_scatter", (k - 1) / k * size)
                else:
                    _count(comm, "all_reduce", 2.0 * (k - 1) / k * size)
            if isinstance(p, Shard):
                size /= k
    return out


def sum_over(x: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """``x`` summed over the ranks of the mesh ``axes``, one all-reduce an
    axis in the mesh's order (a fresh tensor; ``x`` is unchanged)."""
    import torch.distributed as dist

    out = x.detach().clone()
    names = tuple(mesh.mesh_dim_names)
    for n in names:
        if n in axes and mesh.size(names.index(n)) > 1:
            dist.all_reduce(out, group=mesh.get_group(n))
    return out


def sum_of_squares(x) -> torch.Tensor:
    """The f32 sum of squares of a whole DTensor: its shard's, summed over
    the mesh axes it is sharded over (:func:`sum_over`)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    axes = tuple(n for n, p in zip(mesh.mesh_dim_names, x.placements)
                 if isinstance(p, Shard))
    local = torch.sum(torch.square(x.to_local().to(torch.float32)))
    return sum_over(local, mesh, axes) if axes else local


def local_part(x, mesh, spec: P) -> torch.Tensor:
    """This rank's shard of a batch leaf: a DTensor's local tensor, or the
    rank's slice of a plain tensor that is whole on every rank."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(x, DTensor):
        return x.to_local()
    return distribute_tensor(torch.as_tensor(x), mesh,
                             list(placements(spec, mesh)),
                             src_data_rank=None).to_local()


def full_of_shards(local: torch.Tensor, like, target: tuple, mesh) -> Any:
    """A DTensor with the global shape of ``like`` whose shard on each rank
    is ``local``, in the placements ``target`` on ``mesh``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(like.shape)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, list(target), shape=shape,
                              stride=tuple(reversed(stride)),
                              run_check=False)
