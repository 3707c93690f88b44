"""Serving CLI: prefill + batched greedy decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --batch 4 --prompt-len 2048 --max-new 32

Counterpart of ``repro/launch/serve.py``.  Weights and prompts are random,
drawn from seeded ``torch.Generator``s on the device, and so are the stub
frontends' outputs, in the model dtype: a vlm's patch embeddings and
whisper's frame embeddings (``prompt_len + max_new`` frames, as the
reference draws them; whisper decodes from the prompt's first token).
``--device`` defaults to the card (``cuda``) and there is no fallback to
the CPU: without a card it exits with an error unless ``--device cpu`` is
given (with ``--reduced`` for a model the CPU can hold).  It reports the
prefill time, the decode time per token and the tokens per second over
the whole decode loop (one synchronisation at its end), and the median
step, after one warm-up generation.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving.serve_step import ServeConfig, generate


def main(argv=None) -> torch.Tensor:
    """Runs the CLI; returns the measured generation's ``[B, prompt_len +
    max_new]`` tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-dtype", default="model", choices=["model", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = get_model(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    prompts = torch.randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len),
        generator=torch.Generator(device=dev).manual_seed(args.seed + 1),
        device=dev, dtype=torch.int32)
    extra = None
    stub = torch.Generator(device=dev).manual_seed(args.seed + 3)
    if cfg.family == "audio":  # frontend stub: precomputed frame embeddings
        extra = {"frames": torch.randn(
            (args.batch, args.prompt_len + args.max_new, cfg.d_model),
            device=dev, generator=stub).to(cfg.dtype)}
    elif cfg.family == "vlm":  # frontend stub: precomputed patch embeddings
        extra = {"patches": torch.randn(
            (args.batch, cfg.num_patches, cfg.d_model), device=dev,
            generator=stub).to(cfg.dtype)}
    sc = ServeConfig(temperature=args.temperature, kv_dtype=args.kv_dtype)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

    generate(model, params, prompts, max_new=args.max_new, sc=sc,
             generator=gen, extra_batch=extra)  # warm-up: builds, allocator
    stats = {}
    out = generate(model, params, prompts, max_new=args.max_new, sc=sc,
                   generator=gen, stats=stats, extra_batch=extra)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    steps = stats["decode_steps"]
    per_tok = stats["decode_ms"] / steps if steps else float("nan")
    step_med = (statistics.median(stats["decode_step_ms"]) if steps
                else float("nan"))
    print(f"{cfg.name} on {where}: batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.max_new} new tokens")
    print(f"prefill {stats['prefill_ms']:.3f} ms; decode {per_tok:.3f} ms "
          f"per token over the whole decode loop "
          f"({args.batch * 1e3 / per_tok:.1f} tokens/s), median step "
          f"{step_med:.3f} ms")
    for b in range(min(args.batch, 2)):
        print(f"  seq{b}: {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
