"""Training launcher: a fault-tolerant loop with checkpoint/restart.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --reduced --steps 50 --device cpu --ckpt-dir /tmp/ckpt

Counterpart of ``repro/launch/train.py``, with its flags and one more:
``--device`` (default: the CUDA card, through ``device.resolve_device``;
there is no fallback to the CPU).  Weights are random, drawn from
``torch.Generator(device).manual_seed(0)``; batches are
``data.pipeline.global_batch``'s, a pure function of the step.  Restart
semantics: on a step failure the loop restores ``LATEST`` and continues
(``fault.RestartPolicy(max_restarts=3)``); a step consumes its state
(AdamW updates in place), and a restore builds a new one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, global_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import RestartPolicy
from repro_torch.models.registry import get_model
from repro_torch.training.train_step import (TrainConfig, init_train_state,
                                             make_train_step)


def make_batch_fn(cfg, dc: DataConfig):
    """``step -> batch`` (numpy) for ``cfg``'s family, bit for bit the
    reference's: token batches; for audio the step's frame embeddings
    (``default_rng(step)``, ``seq_len`` frames) with tokens and labels cut
    to ``dec_len``; for vlm the step's patch embeddings and -1 labels over
    them."""

    def fn(step: int):
        b = global_batch(dc, step)
        if cfg.family == "audio":
            rng = np.random.default_rng(step)
            frames = rng.standard_normal(
                (dc.global_batch, dc.seq_len, cfg.d_model)).astype(np.float32)
            return {"frames": frames, "tokens": b["tokens"][:, :cfg.dec_len],
                    "labels": b["labels"][:, :cfg.dec_len]}
        if cfg.family == "vlm":
            rng = np.random.default_rng(step)
            pn = cfg.num_patches
            return {
                "tokens": b["tokens"],
                "patches": rng.standard_normal(
                    (dc.global_batch, pn, cfg.d_model)).astype(np.float32),
                "labels": np.concatenate(
                    [np.full((dc.global_batch, pn), -1, np.int32),
                     b["labels"]], axis=1),
            }
        return b

    return fn


def main(argv=None) -> dict[int, float]:
    """Runs the loop; returns each step's loss (a replayed step's last)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--accum-mode", default="combiner",
                    choices=["combiner", "materialize"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    tc = TrainConfig(num_microbatches=args.microbatches,
                     accum_mode=args.accum_mode,
                     vocab_chunk=min(8192, cfg.vocab_size),
                     warmup_steps=5, total_steps=args.steps)
    step_fn = make_train_step(model, tc)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    batch_fn = make_batch_fn(cfg, dc)

    state = init_train_state(model, torch.Generator(dev).manual_seed(0))
    start = 0
    writer = None
    if args.ckpt_dir:
        writer = ckpt.AsyncCheckpointer(args.ckpt_dir)
        if args.resume and ckpt.latest_step(args.ckpt_dir) is not None:
            state, start = ckpt.restore(args.ckpt_dir, state, device=dev)
            print(f"resumed from step {start}")

    policy = RestartPolicy(max_restarts=3)
    losses: dict[int, float] = {}
    i = start
    while i < args.steps:
        try:
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_fn(i))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            losses[i] = loss
            print(f"step {i:4d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if writer and (i + 1) % args.ckpt_every == 0:
                writer.submit(i + 1, state)
            i += 1
        except Exception as e:  # restart-from-latest semantics
            if not (args.ckpt_dir and policy.on_failure()):
                raise
            print(f"step {i} failed ({e}); restarting from LATEST")
            state, i = ckpt.restore(args.ckpt_dir, state, device=dev)
    if writer:
        writer.submit(args.steps, state)
        writer.close()
    print("done")
    return losses


if __name__ == "__main__":
    main()
