"""Carry a stream or sort fold's state between ``repro`` and the port.

The collectors' carried state is the system's only long-lived data (what
weights are to a model).  ``repro`` keeps it as numpy-convertible arrays
in one of three layouts, and so do the port's
:class:`~repro_torch.core.collector.StreamCombiner` and
:class:`~repro_torch.core.collector.SortCombiner`:

* fused   — one f32 ``[K, ΣD + 1]`` accumulator, counts in the last column
            (additive float holders: the stream flow's ``onehot_fold``
            kernel, the sort flow's plain path);
* tables  — ``(holder tables, counts)``, the tables a pytree of
            ``[K, *leaf]`` arrays (the sort flow's kernel path too);
* size    — ``[K]`` int32 counts alone.

:func:`state_from_repro` turns a reference state (as numpy) into the
port's state for a given combiner, converting between the fused and the
per-leaf layouts when the two sides chose differently; a fold seeded with
it continues exactly as the reference's next fold would.
:func:`state_to_repro` goes back.  :func:`service_state_from_repro`
carries a streaming service's checkpoint tree, slot by slot, and
:func:`shard_partial_from_repro` a resilient run's shard partial.  Holder
dtypes follow the port's combiner (torch sums integers into int64, the
reference into int32).  The combine and reduce flows keep no state
between runs, so there is nothing of theirs to carry.

For the models, :func:`params_from_repro` turns the reference's parameter
pytree (numpy leaves, layers stacked ``[L, ...]``) into the port's, key for
key, and :func:`decode_state_from_repro` a reference decode state (its KV
cache and ``pos``), so that both packages compute the same thing;
:func:`train_state_from_repro` a reference AdamW state (``{"step",
"master", "m", "v"}``).

For the shuffle, :func:`shuffle_plan_from_repro` and
:func:`wire_format_from_repro` rebuild the port's ``ShufflePlan`` and
``WireFormat`` from the reference's records (any object with their
fields), so that both sides route and encode by one record.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core.collector import CarriedTables
from repro_torch.device import resolve_device


def _split_fused(comb: CarriedTables, acc: np.ndarray):
    """(tables leaves, counts) of a fused accumulator, per the port's
    holder leaves."""
    leaves, off = [], 0
    for leaf in comb._holder_leaves:
        size = leaf.numel()
        leaves.append(acc[:, off:off + size].reshape(
            (comb.key_space,) + tuple(leaf.shape)))
        off += size
    return leaves, acc[:, -1].astype(np.int32)


def state_from_repro(comb: CarriedTables, state):
    """The port's carried state for ``comb`` from a reference state given
    as numpy arrays (``np.asarray`` of each leaf of the reference's
    state)."""
    dev = comb.device
    if comb.mode == "size":
        return torch.tensor(np.asarray(state), dtype=torch.int32,
                            device=dev)
    if isinstance(state, np.ndarray) and state.ndim == 2:  # fused
        if comb.fused_acc:
            return torch.tensor(state, dtype=torch.float32, device=dev)
        leaves, counts = _split_fused(comb, state)
    else:
        tables, counts = state
        leaves = pytree.tree_leaves(tables)
    leaves = [torch.tensor(np.asarray(x)).to(device=dev, dtype=h.dtype)
              for x, h in zip(leaves, comb._holder_leaves)]
    counts = torch.tensor(np.asarray(counts), dtype=torch.int32, device=dev)
    if comb.fused_acc:
        cols = [x.reshape(comb.key_space, -1).to(torch.float32)
                for x in leaves]
        cols.append(counts.to(torch.float32)[:, None])
        return torch.cat(cols, dim=1)
    return (pytree.tree_unflatten(leaves, comb._holder_treedef), counts)


def state_to_repro(comb: CarriedTables, state, *, fused: bool):
    """The reference's carried state (numpy) from the port's; ``fused``
    picks the reference combiner's layout (its ``_fused_acc``)."""
    if comb.mode == "size":
        return state.cpu().numpy()
    tables, counts = comb.tables_counts(state)
    leaves = [x.cpu().numpy() for x in pytree.tree_leaves(tables)]
    counts = counts.cpu().numpy().astype(np.int32)
    if fused:
        cols = [x.reshape(comb.key_space, -1).astype(np.float32)
                for x in leaves]
        return np.concatenate(cols + [counts.astype(np.float32)[:, None]],
                              axis=1)
    return pytree.tree_unflatten(leaves, comb._holder_treedef), counts


def service_state_from_repro(svc, tree) -> dict:
    """The port's checkpoint tree for the streaming service ``svc`` (staged,
    so its collector is known) from a reference service's tree
    ``{"slots": [state, ...], "meta": [batch_id, n_items]}``, given as
    numpy arrays or as tensors (``ckpt.restore`` of the reference's
    checkpoint into that structure).  Each slot crosses through
    :func:`state_from_repro`, which converts between the fused and the
    per-leaf layouts and widens int32 tables to the port's int64.  Save
    the result with ``repro_torch.checkpoint.ckpt.save`` under
    ``ckpt.service_state_dir(d)`` and ``svc.restore(d)`` resumes the
    reference service's state."""
    from repro_torch.checkpoint import ckpt

    comb = svc.collector
    leaves, _ = ckpt.flatten(tree)
    host = ckpt.unflatten(tree, [
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in leaves])
    if len(host["slots"]) != svc.n_slots:
        raise ValueError(f"the tree holds {len(host['slots'])} window "
                         f"slots, the service {svc.n_slots}")
    return {"slots": [state_from_repro(comb, s) for s in host["slots"]],
            "meta": np.asarray(host["meta"], np.int64)}


def shard_partial_from_repro(run, tree) -> dict:
    """The port's shard partial from a reference resilient run's (its
    checkpoint tree, given as numpy arrays or tensors), for ``run``, the
    prepared per-shard run (``engine.resilient_run``, or a resilient
    ``Compiled``'s ``executable.prepared(n_items)``).

    A stream or combine partial ``{"tables", "counts"}`` crosses through
    :func:`state_from_repro` (per leaf, or fused where the reference fused
    it; int32 tables widened to the port's int64).  A reduce or sort
    partial ``{"wire", "overflow", "wire_epoch"}`` is the reference's
    tree bit for bit and passes through unchanged.  Save the result with
    ``ckpt.save(ckpt.shard_partial_dir(d, s), step, tree)``; a run that
    restores it recovers the shard from it."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.collector import StreamCombiner

    leaves, _ = ckpt.flatten(tree)
    host = ckpt.unflatten(tree, [
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in leaves])
    if run.flow in ("reduce", "sort"):
        return pytree.tree_map(
            lambda a: torch.from_numpy(np.array(a)).to(
                "cpu" if a.dtype == np.uint32 else run.device), host)
    comb = StreamCombiner(run.spec, run.app.key_space, run.app.value_spec,
                          device=run.device)
    counts = host["counts"]
    state = state_from_repro(comb, counts if comb.mode == "size"
                             else (host["tables"], counts))
    tables, counts = comb.tables_counts(state)
    return {"tables": tables, "counts": counts}


def _tensor_from_numpy(x, device) -> torch.Tensor:
    """A numpy array (bfloat16 ones included, which numpy knows only by
    name) as a tensor of the same dtype on ``device``."""
    x = np.array(x)  # a writable copy: caches are updated in place
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(x).to(device)


def _depth(layers) -> int:
    return next(iter(pytree.tree_leaves(layers))).shape[0]


def _check_keys(cfg, what, got, want) -> None:
    if set(got) != set(want):
        raise ValueError(f"{cfg.name}: {what} with {sorted(want)} expected, "
                         f"got {sorted(got)}")


def _check_depth(cfg, what, got: int, want: int) -> None:
    if got != want:
        raise ValueError(f"{cfg.name}: {want} {what} expected, got {got}")


def params_from_repro(cfg, params_np, *, device=None):
    """The port's model parameters from the reference's pytree of numpy
    leaves (``jax.tree.map(np.asarray, params)``) for config ``cfg``: the
    same nested dicts and the same stacked layer leaves (``[L, ...]``; a
    hybrid's groups ``[G, k, ...]``), in the reference's dtypes (an MoE
    router stays f32 in a bf16 model), on ``device`` (``None``: the card).
    The tree's keys and depth must be those of ``cfg``'s family."""
    dev = resolve_device(device)
    out = pytree.tree_map(lambda x: _tensor_from_numpy(x, dev),
                          dict(params_np))
    family = cfg.family
    if family in ("dense", "moe", "vlm"):
        _check_keys(cfg, "a transformer's parameters", out,
                    ("embed", "layers", "ln_f", "head"))
        ffn, other = ("moe", "ffn") if cfg.num_experts else ("ffn", "moe")
        if ffn not in out["layers"] or other in out["layers"]:
            raise ValueError(f"{cfg.name}: layers with {ffn!r} expected, got "
                             f"{sorted(out['layers'])}")
        _check_depth(cfg, "layers", _depth(out["layers"]), cfg.num_layers)
    elif family == "ssm":
        _check_keys(cfg, "a Mamba2 LM's parameters", out,
                    ("embed", "layers", "ln_f", "head"))
        _check_keys(cfg, "Mamba2 layers", out["layers"], ("ln", "ssm"))
        _check_depth(cfg, "layers", _depth(out["layers"]), cfg.num_layers)
    elif family == "hybrid":
        k = cfg.hybrid_attn_every
        groups, leftover = divmod(cfg.num_layers, k)
        _check_keys(cfg, "a hybrid's parameters", out,
                    ("embed", "groups", "shared", "ln_f", "head")
                    + (("tail",) if leftover else ()))
        _check_keys(cfg, "Mamba2 layers", out["groups"], ("ln", "ssm"))
        _check_depth(cfg, "[groups, layers]",
                     tuple(out["groups"]["ln"]["scale"].shape[:2]),
                     (groups, k))
        if leftover:
            _check_depth(cfg, "tail layers", _depth(out["tail"]), leftover)
    elif family == "audio":
        _check_keys(cfg, "an encoder-decoder's parameters", out,
                    ("embed", "pos_dec", "enc_layers", "ln_enc_f",
                     "dec_layers", "ln_dec_f", "head"))
        _check_depth(cfg, "encoder layers", _depth(out["enc_layers"]),
                     cfg.enc_layers or cfg.num_layers)
        _check_depth(cfg, "decoder layers", _depth(out["dec_layers"]),
                     cfg.num_layers)
    else:
        raise ValueError(f"{cfg.name}: unknown family {family!r}")
    return out


def train_state_from_repro(cfg, opt_state_np, *, device=None):
    """The port's train state from a reference AdamW state given as numpy
    (``jax.tree.map(np.asarray, opt_state)``): ``master``, ``m`` and ``v``
    in :func:`params_from_repro`'s layout (f32), ``step`` a 0-d int32
    tensor."""
    dev = resolve_device(device)
    out = {name: params_from_repro(cfg, opt_state_np[name], device=dev)
           for name in ("master", "m", "v")}
    out["step"] = torch.tensor(int(np.asarray(opt_state_np["step"])),
                               dtype=torch.int32, device=dev)
    return out


def decode_state_from_repro(state_np, *, device=None):
    """The port's decode state from a reference one given as numpy: every
    entry (a KV ``cache`` of ``[L, B, S, Kv, D]`` leaves; an SSM family's
    ``ssm``, ``ssm_groups`` and ``ssm_tail`` states; whisper's ``cross_k``
    and ``cross_v``) as tensors of the same dtypes and nesting, and
    ``pos`` a Python int."""
    dev = resolve_device(device)
    return {name: (int(np.asarray(x)) if name == "pos" else
                   pytree.tree_map(lambda a: _tensor_from_numpy(a, dev), x))
            for name, x in state_np.items()}


def shuffle_plan_from_repro(plan):
    """The port's ``skew.ShufflePlan`` from a reference ``ShufflePlan``
    (same fields; Python ints and floats)."""
    from repro_torch.core import skew

    if plan is None:
        return None
    return skew.ShufflePlan(
        key_space=int(plan.key_space), num_shards=int(plan.num_shards),
        boundaries=tuple(int(b) for b in plan.boundaries),
        hot_keys=tuple(int(k) for k in plan.hot_keys),
        hot_ways=tuple(int(w) for w in plan.hot_ways),
        imbalance=(None if plan.imbalance is None
                   else float(plan.imbalance)),
        max_dest_frac=(None if plan.max_dest_frac is None
                       else float(plan.max_dest_frac)))


def wire_format_from_repro(fmt):
    """The port's ``wire.WireFormat`` from a reference ``WireFormat``; its
    ``epoch`` is the reference's."""
    from repro_torch.distributed import wire

    return wire.WireFormat(
        codec=str(fmt.codec), num_shards=int(fmt.num_shards),
        capacity=int(fmt.capacity), key_space=int(fmt.key_space),
        lo=tuple(int(x) for x in fmt.lo), span=int(fmt.span),
        hot_keys=tuple(int(k) for k in fmt.hot_keys),
        plan_epoch=int(fmt.plan_epoch),
        value_leaves=tuple((str(d), int(e)) for d, e in fmt.value_leaves))
