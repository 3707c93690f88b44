"""Gradient accumulation through the paper's combiner machinery.

Counterpart of ``repro/training/grad_accum.py``.  Microbatched training
*is* MapReduce: map = per-microbatch gradient computation, reduce = mean
over microbatches (a single key: the parameter tree).  The port's semantic
optimizer (``core.optimizer.derive_combiner``) derives the ``(init=zeros,
combine=add, finalize=/n)`` triple from the user-visible mean reducer,
and the combine flow folds each microbatch's gradients into the holder:

  * ``materialize`` (reduce flow): all M microbatch gradients are stacked
    ``[M, *param]`` then reduced: O(M · params) live memory.
  * ``combiner`` (combine flow): one holder, folded as each microbatch's
    gradients come: O(params) live memory.

The reference folds inside ``lax.scan`` and XLA frees what the scan no
longer needs.  Eager PyTorch holds whatever is referenced, so here each
microbatch's graph is dropped by ``torch.autograd.grad`` and its
gradients are folded (or copied into the stack) leaf by leaf, each leaf's
gradient released as soon as it is folded.  The holder adds the
microbatches in order, as the scan does.  Gradients come from
``torch.autograd.grad`` on leaves made fresh each call (detached views of
``params``): no ``.grad`` state is carried between calls.

With ``pspecs`` (the sharded train step, ZeRO-3 over the reference's
layouts, ROADMAP C.70) each rank runs the same folds on its DP slice of
the batch with whole parameters, and each microbatch's gradients are
summed over the DP ranks and cut to the rank's shard before they are
folded: the holder, or the materialized stack, is kept in the parameters'
layout, as the reference pins it there.

A single microbatch's body is ``roofline.op_trace.loop("microbatch")``: a
trace whose caller sets that trip count to M (the dry-run) counts the one
microbatch it traces M times, as the reference's HLO parser multiplies a
scan body by its trip count.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.core.combiner import ValueSpec
from repro_torch.core.optimizer import derive_combiner
from repro_torch.roofline import op_trace


def _mean_reducer(key, values, count):
    """The user-level reducer the optimizer analyzes (mean over
    microbatches)."""
    del key
    return torch.sum(values, 0) / count.to(values.dtype)


_CACHED_DERIVATION = None


def derive_grad_combiner():
    """Run the semantic optimizer on the mean reducer; cached after the
    first call."""
    global _CACHED_DERIVATION
    if _CACHED_DERIVATION is None:
        d = derive_combiner(_mean_reducer, ValueSpec((), torch.int32),
                            ValueSpec((4,), torch.float32))
        assert d.combinable and d.strategy == "monoid", d.failure
        assert d.validated, "the mean reducer's combiner was not validated"
        _CACHED_DERIVATION = d
    return _CACHED_DERIVATION


def split_microbatches(batch, num: int):
    def split(x):
        assert x.shape[0] % num == 0, (x.shape, num)
        return x.reshape((num, x.shape[0] // num) + tuple(x.shape[1:]))

    leaves, _ = flatten(batch)
    return unflatten(batch, [split(x) for x in leaves])


def _microbatch(mbs, k: int):
    leaves, _ = flatten(mbs)
    return unflatten(mbs, [x[k] for x in leaves])


def _value_and_grad(loss_fn, params, batch):
    """``((loss, aux), grads)`` with grads a list in JAX's leaf order; the
    graph is freed before this returns."""
    leaves, _ = flatten(params)
    fresh = [p.detach().requires_grad_(True) for p in leaves]
    loss, aux = loss_fn(unflatten(params, fresh), batch)
    grads = list(torch.autograd.grad(loss, fresh))
    del fresh
    aux = {k: v.detach() if isinstance(v, torch.Tensor) else v
           for k, v in aux.items()}
    return (loss.detach(), aux), grads


def _mean_aux(auxs):
    """Mean over microbatches of each aux entry (the scan stacks them)."""
    out = {}
    for k in auxs[0]:
        vals = [a[k] for a in auxs]
        if isinstance(vals[0], torch.Tensor):
            out[k] = torch.mean(torch.stack([v.to(torch.float32)
                                             for v in vals]), 0)
        else:
            out[k] = sum(vals) / len(vals)
    return out


def accumulate_gradients(loss_fn, params, batch, *, num_microbatches: int = 1,
                         mode: str = "combiner", spec=None, pspecs=None,
                         mb_pspecs=None, mesh=None, comm=None):
    """Returns ((loss, aux), grads) with grads averaged over microbatches.

    ``loss_fn(params, microbatch) -> (loss, aux)``; ``spec`` is the derived
    combiner (``derive_grad_combiner().spec`` when ``None``).

    Sharded (``pspecs``, a :class:`~repro_torch.models.common.P` tree of
    the parameters, given): ``params`` are whole on every rank of ``mesh``
    (a ``DeviceMesh``; ``None``: the one registered with
    ``distributed.act_sharding``); ``batch`` is the global batch, whole or
    as DTensors, laid out by ``mb_pspecs`` (``None``: ``batch_pspecs``), and
    each rank runs its DP slice.  The grads are DTensors in the layout of
    ``pspecs``; the loss and aux are the means over the DP ranks.
    ``comm`` (a dict) adds up the collectives' wire bytes a rank."""
    if pspecs is not None:
        return _accumulate_sharded(loss_fn, params, batch, num_microbatches,
                                   mode, spec, pspecs, mb_pspecs, mesh, comm)
    if mb_pspecs is not None:
        raise ValueError("mb_pspecs lays out the batch of a sharded "
                         "accumulation: pass the parameters' pspecs too")
    if num_microbatches == 1:
        with op_trace.loop("microbatch"):
            (loss, aux), g = _value_and_grad(loss_fn, params, batch)
        return (loss, aux), unflatten(params, g)
    if mode not in ("combiner", "materialize"):
        raise ValueError(mode)
    shapes = [tuple(p.shape) for p in flatten(params)[0]]
    (loss, aux), grads = _fold(loss_fn, params, batch, num_microbatches, mode,
                               spec, shapes)
    return (loss, aux), unflatten(params, grads)


def _fold(loss_fn, params, batch, M, mode, spec, shapes, cut=None):
    """``((loss, aux), grads)`` of M microbatches in order: ``combiner``
    folds each microbatch's f32 gradients into one holder a leaf (the
    combine flow, O(params) live memory); ``materialize`` stacks them
    ``[M, *leaf]`` and takes the mean (the reduce flow, O(M · params)).
    Each leaf's gradient is freed as soon as it is folded.  ``cut(g, i)``
    takes leaf ``i``'s gradient out of the list ``g`` and returns what is
    folded in f32 (a sharded step's shard, of shape ``shapes[i]``);
    ``None``: the gradient itself."""
    mbs = split_microbatches(batch, M)
    spec = spec if spec is not None else derive_grad_combiner().spec
    leaves, _ = flatten(params)
    losses, auxs = [], []
    if mode == "combiner":
        holder = [torch.zeros(s, dtype=torch.float32, device=p.device)
                  for s, p in zip(shapes, leaves)]
    else:
        holder = [torch.empty((M,) + s, dtype=torch.float32, device=p.device)
                  for s, p in zip(shapes, leaves)]
    for k in range(M):
        (loss, aux), g = _value_and_grad(loss_fn, params, _microbatch(mbs, k))
        n = torch.tensor(k, dtype=torch.int32)
        for i in range(len(g)):
            if cut is not None:
                x = cut(g, i)
            elif mode == "combiner":  # the f32 copy made, the leaf freed
                x = g[i].to(torch.float32)
            else:  # copy_ casts into the stack
                x = g[i]
            g[i] = None
            if mode == "combiner":
                holder[i] = spec.combine((holder[i],), spec.premap(x), n)[0]
            else:
                holder[i][k].copy_(x)
            del x
        del g
        losses.append(loss)
        auxs.append(aux)
    grads = []
    if mode == "combiner":
        count = torch.tensor(M, dtype=torch.int32)
        for i in range(len(holder)):  # each holder leaf freed once final
            grads.append(spec.finalize(0, (holder[i],), count))
            holder[i] = None
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        loss = loss / torch.tensor(float(M), dtype=torch.float32)
    else:
        for i in range(len(holder)):
            grads.append(torch.mean(holder[i], 0))
            holder[i] = None
        loss = torch.mean(torch.stack(losses))
    del holder
    return (loss, _mean_aux(auxs)), grads


def _accumulate_sharded(loss_fn, params, batch, M, mode, spec, pspecs,
                        mb_pspecs, mesh, comm):
    """:func:`accumulate_gradients` with ``pspecs``: the folds of the
    unsharded path on this rank's rows, each microbatch's gradients summed
    over the DP axes the batch is sharded over (pre-scaled by 1/D, exact
    for a power of two) and cut to the rank's shard before the fold."""
    from repro_torch.distributed import act_sharding
    from repro_torch.distributed import sharding as shd

    if mode not in ("combiner", "materialize"):
        raise ValueError(mode)
    mesh = mesh if mesh is not None else act_sharding.current_mesh()
    if mesh is None:
        raise ValueError("a sharded accumulation needs a mesh (mesh=, or "
                         "distributed.act_sharding.set_mesh)")
    if mb_pspecs is None:
        mb_pspecs = shd.batch_pspecs(batch, mesh)
    b_specs = flatten(mb_pspecs)[0]
    leaves, _ = flatten(params)
    specs = flatten(pspecs)[0]
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} pspecs for {len(leaves)} parameters")
    targets = [shd.placements(s, mesh) for s in specs]
    dp = set(shd.spec_axes(b_specs[0][0]) if len(b_specs[0]) else ())
    if any(set(shd.spec_axes(s[0] if len(s) else None)) != dp
           for s in b_specs):
        raise ValueError(f"the batch leaves are laid out over different DP "
                         f"axes: {b_specs}")
    partial = tuple(n for n in mesh.mesh_dim_names if n in dp)
    inv = 1.0 / shd._axis_sizes(mesh, partial)
    local = unflatten(batch, [shd.local_part(x, mesh, s) for x, s in
                              zip(flatten(batch)[0], b_specs)])

    def cut(g, i):  # no reference to the unscaled gradient outlives it
        x = g[i].to(torch.float32)
        g[i] = None
        if partial:
            x = x * inv
        return shd.reduce_to_shard(x, mesh, partial, targets[i], comm)

    if M == 1:  # as the unsharded path: no fold
        with op_trace.loop("microbatch"):
            (loss, aux), g = _value_and_grad(loss_fn, params, local)
            locs = [cut(g, i) for i in range(len(g))]
        del g
    else:
        shapes = [shd.local_shape(p.shape, sp, mesh)
                  for p, sp in zip(leaves, specs)]
        (loss, aux), locs = _fold(loss_fn, params, local, M, mode, spec,
                                  shapes, cut)
    if partial:  # the DP ranks' means, added in the mesh's order
        loss = shd.sum_over(loss * inv, mesh, partial)
        aux = {k: shd.sum_over(v * inv, mesh, partial)
               if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
    grads = [shd.full_of_shards(x, p, t, mesh)
             for x, p, t in zip(locs, leaves, targets)]
    return (loss, aux), unflatten(params, grads)
