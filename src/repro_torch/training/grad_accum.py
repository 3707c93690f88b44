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
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.core.combiner import ValueSpec
from repro_torch.core.optimizer import derive_combiner
from repro_torch.training.losses import SHARDING_ITEM


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
                         mb_pspecs=None):
    """Returns ((loss, aux), grads) with grads averaged over microbatches.

    ``loss_fn(params, microbatch) -> (loss, aux)``; ``spec`` is the derived
    combiner (``derive_grad_combiner().spec`` when ``None``).  ``pspecs``
    and ``mb_pspecs`` (mesh shardings) must be ``None``."""
    if pspecs is not None or mb_pspecs is not None:
        raise NotImplementedError(
            f"accumulate_gradients(pspecs=..., mb_pspecs=...) pins the "
            f"gradients' and microbatches' shardings on a mesh, which waits "
            f"for ROADMAP {SHARDING_ITEM}")
    if num_microbatches == 1:
        (loss, aux), g = _value_and_grad(loss_fn, params, batch)
        return (loss, aux), unflatten(params, g)
    if mode not in ("combiner", "materialize"):
        raise ValueError(mode)

    mbs = split_microbatches(batch, num_microbatches)
    spec = spec if spec is not None else derive_grad_combiner().spec
    leaves, _ = flatten(params)
    M = num_microbatches
    losses, auxs = [], []

    if mode == "combiner":
        # combine flow: fold each microbatch's gradients into the holder
        holder = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                  for p in leaves]
        for k in range(M):
            (loss, aux), g = _value_and_grad(loss_fn, params,
                                             _microbatch(mbs, k))
            n = torch.tensor(k, dtype=torch.int32)
            for i in range(len(g)):
                g32 = g[i].to(torch.float32)
                g[i] = None
                holder[i] = spec.combine((holder[i],), spec.premap(g32),
                                         n)[0]
                del g32
            del g
            losses.append(loss)
            auxs.append(aux)
        count = torch.tensor(M, dtype=torch.int32)
        grads = []
        for i in range(len(holder)):  # each holder leaf freed once final
            grads.append(spec.finalize(0, (holder[i],), count))
            holder[i] = None
        del holder
        loss = losses[0]
        for x in losses[1:]:
            loss = loss + x
        loss = loss / torch.tensor(float(M), dtype=torch.float32)
        return (loss, _mean_aux(auxs)), unflatten(params, grads)

    # reduce flow: stack all microbatch grads [M, *param], then reduce
    stacked = [torch.empty((M,) + tuple(p.shape), dtype=torch.float32,
                           device=p.device) for p in leaves]
    for k in range(M):
        (loss, aux), g = _value_and_grad(loss_fn, params, _microbatch(mbs, k))
        for i in range(len(g)):
            stacked[i][k].copy_(g[i])
            g[i] = None
        del g
        losses.append(loss)
        auxs.append(aux)
    grads = []
    for i in range(len(stacked)):
        grads.append(torch.mean(stacked[i], 0))
        stacked[i] = None
    del stacked
    loss = torch.mean(torch.stack(losses))
    return (loss, _mean_aux(auxs)), unflatten(params, grads)
