"""Train-step factory: loss -> gradient accumulation -> AdamW.

Counterpart of ``repro/training/train_step.py``.  ``train_step(opt_state,
batch)`` runs eagerly on the state's device; its AdamW update writes the
state in place (``optim.adamw_update``, ROADMAP C.54), so the state passed
in is consumed and the returned one shares its tensors.

Sharded (``param_pspecs`` given; ROADMAP C.70): the
state is a tree of DTensors laid out by ``distributed.sharding``
(``distribute(state, param_shardings(state, mesh))``), ZeRO-3 over the
reference's layouts.  A step all-gathers the model-dtype parameters once,
runs the unchanged loss and backward on the rank's DP slice of the batch,
reduce-scatters each microbatch's gradients to the parameters' layout
(``grad_accum``), and AdamW updates each rank's shards in place.  The
ranks of the 'model' axis compute the same microbatch: the reference's
tensor-parallel compute is not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import flatten, unflatten
from repro_torch.models.registry import Model
from repro_torch.training import losses, optim
from repro_torch.training.grad_accum import (accumulate_gradients,
                                             derive_grad_combiner)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    adam: optim.AdamWConfig = optim.AdamWConfig()
    num_microbatches: int = 1
    accum_mode: str = "combiner"  # | "materialize"
    loss_mode: str = "chunked"  # | "materialize"
    moe_mode: str = "combiner"  # | "materialize"
    vocab_chunk: int = 8192
    warmup_steps: int = 100
    total_steps: int = 10000
    grad_compression: str = "none"  # | "int8" (DP all-reduce path)


def make_loss_fn(model: Model, tc: TrainConfig, *, logits_pspec=None):
    def loss_fn(params, batch):
        return losses.lm_loss(model, params, batch, mode=tc.loss_mode,
                              moe_mode=tc.moe_mode,
                              vocab_chunk=tc.vocab_chunk,
                              logits_pspec=logits_pspec)

    return loss_fn


def batch_to(batch, device):
    """A batch (numpy arrays or tensors) as tensors on ``device``."""
    leaves, _ = flatten(batch)
    return unflatten(batch, [
        torch.from_numpy(np.ascontiguousarray(x)).to(device)
        if isinstance(x, np.ndarray) else torch.as_tensor(x, device=device)
        for x in leaves])


def make_train_step(model: Model, tc: TrainConfig, *, param_pspecs=None,
                    batch_pspecs=None, logits_pspec=None):
    """Returns ``train_step(opt_state, batch) -> (opt_state, metrics)``.

    ``batch`` may hold numpy arrays or tensors; it is moved to the state's
    device.  With ``grad_compression="int8"`` each gradient leaf goes
    through ``compression.fake_quant_int8``, as in the reference (no error
    feedback is carried).

    With ``param_pspecs`` (the parameters' :class:`P` tree; the state's
    layout) the step is sharded (module docstring): ``opt_state`` holds
    DTensors on one mesh, ``batch`` is the global batch (whole on every
    rank, or DTensors laid out by ``batch_pspecs``, by default
    ``sharding.batch_pspecs``), and the returned state and metrics are the
    whole step's.  ``train_step.comm`` then holds the last step's wire
    bytes a rank by collective (counted, not measured)."""
    loss_fn = make_loss_fn(model, tc, logits_pspec=logits_pspec)
    grad_spec = (derive_grad_combiner().spec
                 if tc.num_microbatches > 1 else None)
    if param_pspecs is not None:
        return _sharded_step(model, tc, loss_fn, grad_spec, param_pspecs,
                             batch_pspecs)
    if batch_pspecs is not None:
        raise ValueError("batch_pspecs lays out the batch of a sharded "
                         "step: pass the parameters' param_pspecs too")

    def train_step(opt_state, batch):
        batch = batch_to(batch, opt_state["step"].device)
        params = optim.model_params(opt_state, model.cfg.dtype)
        (loss, aux), grads = accumulate_gradients(
            loss_fn, params, batch, num_microbatches=tc.num_microbatches,
            mode=tc.accum_mode, spec=grad_spec)
        del params

        if tc.grad_compression == "int8":
            from repro_torch.distributed.compression import fake_quant_int8

            grads = optim.tree_map(fake_quant_int8, grads)

        lr_scale = optim.cosine_schedule(
            opt_state["step"], warmup=tc.warmup_steps, total=tc.total_steps)
        opt_state, stats = optim.adamw_update(tc.adam, grads, opt_state,
                                              lr_scale)
        metrics = {"loss": loss, **aux, **stats}
        return opt_state, metrics

    return train_step


def init_train_state(model: Model, rng: torch.Generator):
    """Random parameters from ``rng`` (on its device) and their AdamW
    state; the model-dtype parameters are dropped once the f32 master
    copy exists."""
    params = model.init_params(rng)
    return optim.init_opt_state(params)


def abstract_train_state(model: Model):
    """The optimizer state as fake tensors, without allocation (the
    dry-run path)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return optim.init_opt_state(model.init_params(torch.Generator()))


def _sharded_step(model, tc, loss_fn, grad_spec, param_pspecs, batch_pspecs):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed import act_sharding
    from repro_torch.distributed import sharding as shd

    def train_step(opt_state, batch):
        masters = flatten(opt_state["master"])[0]
        if not masters or not all(isinstance(x, DTensor) for x in masters):
            raise TypeError("a sharded train step takes a state of DTensors "
                            "(sharding.distribute)")
        mesh = masters[0].device_mesh
        want = [shd.placements(sp, mesh) for sp in flatten(param_pspecs)[0]]
        if [tuple(x.placements) for x in masters] != want:
            raise ValueError("the state's layout is not param_pspecs'")
        comm: dict = {}
        prev = act_sharding.current_mesh()
        act_sharding.set_mesh(mesh)
        try:
            params = unflatten(opt_state["master"], [
                shd.gather_full(x, model.cfg.dtype, comm) for x in masters])
            (loss, aux), grads = accumulate_gradients(
                loss_fn, params, batch, num_microbatches=tc.num_microbatches,
                mode=tc.accum_mode, spec=grad_spec, pspecs=param_pspecs,
                mb_pspecs=batch_pspecs, mesh=mesh, comm=comm)
        finally:
            act_sharding.set_mesh(prev)
        del params
        if tc.grad_compression == "int8":
            from repro_torch.distributed.compression import fake_quant_int8

            grads = optim.tree_map(fake_quant_int8, grads)
        # the whole gradients' norm: each leaf's sum of squares over its
        # shards, the leaves added in JAX's leaf order
        gnorm = torch.sqrt(sum(shd.sum_of_squares(g)
                               for g in flatten(grads)[0]))
        step = opt_state["step"]
        step_local = step.to_local() if isinstance(step, DTensor) else step
        local = {"step": step_local,
                 **{k: optim.tree_map(lambda x: x.to_local(), opt_state[k])
                    for k in ("master", "m", "v")}}
        lr_scale = optim.cosine_schedule(
            step_local, warmup=tc.warmup_steps, total=tc.total_steps)
        local, stats = optim.adamw_update(
            tc.adam, optim.tree_map(lambda g: g.to_local(), grads), local,
            lr_scale, grad_norm=gnorm)
        new_step = local["step"]
        if isinstance(step, DTensor):
            new_step = DTensor.from_local(new_step, mesh,
                                          [Replicate()] * mesh.ndim,
                                          run_check=False)
        train_step.comm = comm
        new_state = {"step": new_step, "master": opt_state["master"],
                     "m": opt_state["m"], "v": opt_state["v"]}
        return new_state, {"loss": loss, **aux, **stats}

    train_step.comm = {}
    return train_step
