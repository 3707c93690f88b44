"""Train-step factory: loss -> gradient accumulation -> AdamW.

Counterpart of ``repro/training/train_step.py``.  ``train_step(opt_state,
batch)`` runs eagerly on the state's device; its AdamW update writes the
state in place (``optim.adamw_update``, ROADMAP C.54), so the state passed
in is consumed and the returned one shares its tensors.  The reference's
``param_pspecs`` / ``batch_pspecs`` / ``logits_pspec`` and
``abstract_train_state`` belong to the mesh and the dry-run (ROADMAP
A14b-5).
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
    feedback is carried)."""
    if param_pspecs is not None or batch_pspecs is not None:
        raise NotImplementedError(
            f"make_train_step(param_pspecs=..., batch_pspecs=...) shards the "
            f"step over a mesh, which waits for ROADMAP "
            f"{losses.SHARDING_ITEM}")
    loss_fn = make_loss_fn(model, tc, logits_pspec=logits_pspec)
    grad_spec = (derive_grad_combiner().spec
                 if tc.num_microbatches > 1 else None)

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
