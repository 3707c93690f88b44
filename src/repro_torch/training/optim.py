"""AdamW with f32 master weights, global-norm clipping, a cosine schedule.

Counterpart of ``repro/training/optim.py``.  The optimizer state is the
reference's tree, ``{"step", "master", "m", "v"}``, with ``step`` a 0-d
int32 tensor and the other three the parameter tree in f32.

Two differences on purpose (ROADMAP C.54):

* :func:`adamw_update` updates one leaf at a time and writes ``m``, ``v``
  and ``master`` **in place**: the reference's functional update is one
  fused XLA program, while eager PyTorch would hold a second f32 copy of
  the whole state.  Its transient memory is about two leaves (the largest
  leaf, gemma2-27b's tied table, is 4.7 GB in f32).  The state passed in
  is therefore consumed: the returned state shares its tensors.
* The leaves are visited in JAX's flatten order (dicts by sorted key,
  ``ckpt.flatten``), not ``torch.utils._pytree``'s insertion order, so
  :func:`global_norm` adds the leaves' squares in the reference's order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn, tree):
    """``fn`` over the leaves of a nested dict/list tree, in JAX's order."""
    leaves, _ = flatten(tree)
    return unflatten(tree, [fn(x) for x in leaves])


def init_opt_state(params):
    leaves, _ = flatten(params)
    device = leaves[0].device if leaves else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of the leaves' f32 squares, added in JAX's leaf
    order."""
    leaves, _ = flatten(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, opt_state, lr_scale=1.0, *,
                 grad_norm=None):
    """Returns (new_opt_state, stats).  ``m``, ``v`` and ``master`` are
    updated in place, leaf by leaf: ``opt_state`` is consumed.
    ``grad_norm`` replaces :func:`global_norm` of ``grads`` (a sharded
    step passes the norm of the whole gradients and its ranks' shards)."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    t = step.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=t.device)
    bc1 = 1.0 - torch.pow(one * cfg.b1, t)
    bc2 = 1.0 - torch.pow(one * cfg.b2, t)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=t.device)

    flat_g, _ = flatten(grads)
    flat_m, _ = flatten(opt_state["m"])
    flat_v, _ = flatten(opt_state["v"])
    flat_p, _ = flatten(opt_state["master"])
    for g, m, v, mp in zip(flat_g, flat_m, flat_v, flat_p):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        g2 = g * (1 - cfg.b2)
        g2.mul_(g)
        del g
        v.mul_(cfg.b2).add_(g2)
        del g2
        denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
        upd = torch.div(m, bc1).div_(denom)  # mhat / (sqrt(vhat) + eps)
        del denom
        upd.add_(cfg.weight_decay * mp)
        mp.sub_(upd.mul_(lr))
        del upd

    new_state = {"step": step, "master": opt_state["master"],
                 "m": opt_state["m"], "v": opt_state["v"]}
    return new_state, {"grad_norm": gnorm, "lr": lr}


def model_params(opt_state, dtype):
    """Cast the f32 master copy to the model dtype for the forward pass:
    fresh tensors, never the master's own (a f32 model gets a copy)."""
    return tree_map(lambda p: p.to(dtype, copy=True), opt_state["master"])


def cosine_schedule(step, *, warmup: int = 100, total: int = 10000,
                    min_frac: float = 0.1):
    t = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(t / max(warmup, 1), max=1.0)
    prog = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
