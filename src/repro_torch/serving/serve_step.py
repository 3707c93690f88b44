"""Serve-step factory: batched decode with greedy or temperature sampling.

Counterpart of ``repro/serving/serve_step.py``.  Greedy decoding is an
``argmax`` and gives the reference's tokens for the same logits;
temperature sampling draws from an explicit ``torch.Generator``, so it
does not give JAX's bits.  ``generate``'s ``extra_batch`` carries the
modality stubs' inputs (internvl ``patches``, whisper ``frames``) to
prefill.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.models.registry import Model


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    temperature: float = 0.0  # 0 => greedy
    kv_dtype: str = "model"  # "model" | "int8"


def kv_dtype_of(model: Model, sc: ServeConfig):
    return torch.int8 if sc.kv_dtype == "int8" else None


def _pick(logits, sc: ServeConfig, generator):
    if sc.temperature > 0:
        probs = torch.softmax(logits / sc.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def make_decode_step(model: Model, sc: ServeConfig = ServeConfig(), *,
                     use_kernels: bool | None = None):
    """step(params, state, tokens [B], generator=None) -> (next_tokens,
    state).  ``use_kernels`` as in ``decode_step`` (``None``: on when the
    tokens lie on a CUDA device)."""

    def step(params, state, tokens, generator=None):
        logits, state = model.decode_step(params, state, tokens,
                                          use_kernels=use_kernels)
        return _pick(logits, sc, generator), state

    return step


def make_prefill(model: Model, sc: ServeConfig = ServeConfig()):
    def prefill(params, batch, state):
        logits, state = model.prefill(params, batch, state)
        return torch.argmax(logits, dim=-1).to(torch.int32), state

    return prefill


def generate(model: Model, params, prompts, *, max_new: int = 16,
             sc: ServeConfig = ServeConfig(),
             generator: torch.Generator | None = None,
             use_kernels: bool | None = None, stats: dict | None = None,
             extra_batch: dict | None = None):
    """Greedy/temperature generation: prompts [B, S] -> tokens
    [B, max_new], on the prompts' device.  ``extra_batch`` carries the
    modality stubs' inputs (internvl "patches" [B, Pn, E], which take Pn
    positions of the cache in front of the prompt; whisper "frames" [B,
    Sf, E], which take none: the cross K/V holds them, and whisper decodes
    from the prompt's first token).

    ``stats``, when given, receives ``prefill_ms`` (host clock, between two
    device synchronisations), ``decode_ms`` (host clock over the whole
    decode loop, which runs without a synchronisation and ends in one),
    ``decode_steps``, and ``decode_step_ms``, one entry per step: CUDA
    events between steps on the card, which do not stall the host, and the
    host clock on the CPU.  Without it nothing synchronises."""
    B, S = prompts.shape
    extra_len = (extra_batch["patches"].shape[1]
                 if extra_batch and "patches" in extra_batch else 0)
    dev = prompts.device
    timed = stats is not None
    events = timed and dev.type == "cuda"

    def sync():
        if events:
            torch.cuda.synchronize(dev)

    def mark():
        if events:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            return ev
        return time.perf_counter()

    def between(a, b):
        return a.elapsed_time(b) if events else (b - a) * 1e3

    with torch.inference_mode():
        state = model.init_decode_state(B, S + max_new + extra_len,
                                        kv_dtype=kv_dtype_of(model, sc),
                                        device=dev)
        pf = make_prefill(model, sc)
        step = make_decode_step(model, sc, use_kernels=use_kernels)
        if timed:
            sync()
            t0 = time.perf_counter()
        nxt, state = pf(params, {"tokens": prompts, **(extra_batch or {})},
                        state)
        if timed:
            sync()
            t1 = time.perf_counter()
            marks = [mark()]
        out = [nxt]
        for _ in range(max_new - 1):
            nxt, state = step(params, state, nxt, generator)
            out.append(nxt)
            if timed:
                marks.append(mark())
        if timed:
            sync()
            stats["prefill_ms"] = (t1 - t0) * 1e3
            stats["decode_ms"] = (time.perf_counter() - t1) * 1e3
            stats["decode_steps"] = max_new - 1
            stats["decode_step_ms"] = [between(a, b)
                                       for a, b in zip(marks, marks[1:])]
        return torch.stack(out, dim=1)
