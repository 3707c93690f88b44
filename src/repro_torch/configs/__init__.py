"""Published model configurations (as shapes, no weights) and the
dry-run's (arch × shape) cells.

Counterpart of ``repro/configs/__init__.py``.  ``get_config(name)`` returns
the exact published :class:`~repro_torch.models.common.ModelConfig` of each
of the reference's ten architectures, in its order: dense (qwen1.5-32b,
llama3-8b, qwen2.5-14b, gemma2-27b), ssm (mamba2-2.7b), audio
(whisper-medium), moe (llama4-scout-17b-a16e, qwen3-moe-30b-a3b), hybrid
(zamba2-1.2b) and vlm (internvl2-26b).  ``input_specs(cfg, shape)`` gives
stand-ins for every model input of an (arch × shape) cell as meta tensors
(the port's ``jax.ShapeDtypeStruct``: a shape and a dtype, no storage);
``state_specs`` the decode state's, built under ``FakeTensorMode``.
"""

from __future__ import annotations

import dataclasses
import importlib

import torch

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen1.5-32b": "qwen1p5_32b",
    "llama3-8b": "llama3_8b",
    "qwen2.5-14b": "qwen2p5_14b",
    "gemma2-27b": "gemma2_27b",
    "mamba2-2.7b": "mamba2_2p7b",
    "whisper-medium": "whisper_medium",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "zamba2-1.2b": "zamba2_1p2b",
    "internvl2-26b": "internvl2_26b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not an architecture of repro_torch: "
                       f"{', '.join(ARCHS)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

#: archs whose decode path is full (or global-alternating) softmax
#: attention: long_500k is skipped for these
FULL_ATTENTION_ARCHS = frozenset({
    "qwen1.5-32b", "llama3-8b", "qwen2.5-14b", "gemma2-27b",
    "whisper-medium", "llama4-scout-17b-a16e", "qwen3-moe-30b-a3b",
    "internvl2-26b",
})


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch in FULL_ATTENTION_ARCHS:
        return False, ("long_500k needs sub-quadratic attention (skip; "
                       "DESIGN.md)")
    return True, ""


def all_cells():
    """The 40 (arch × shape) cells, with skip annotations."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            ok, why = cell_supported(a, s)
            out.append((a, s, ok, why))
    return out


# ---------------------------------------------------------------------------
# input_specs: meta-tensor stand-ins per (arch × shape)
# ---------------------------------------------------------------------------


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, *, kv_dtype=None) -> dict:
    """Model inputs for the cell's step function (no state; see
    :func:`state_specs`), as meta tensors.

    train  -> {"tokens", "labels"} (+frames/patches per frontend stub)
    prefill-> {"tokens"} (+frames/patches)
    decode -> {"tokens": [B]} single step
    """
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        if cfg.family == "audio":
            return {
                "frames": _sds((B, S, cfg.d_model), bf16),
                "tokens": _sds((B, cfg.dec_len), i32),
                "labels": _sds((B, cfg.dec_len), i32),
            }
        if cfg.family == "vlm":
            Pn = cfg.num_patches
            return {
                "tokens": _sds((B, S - Pn), i32),
                "patches": _sds((B, Pn, cfg.d_model), bf16),
                "labels": _sds((B, S), i32),
            }
        return {"tokens": _sds((B, S), i32), "labels": _sds((B, S), i32)}

    if shape.kind == "prefill":
        if cfg.family == "audio":
            return {"frames": _sds((B, S, cfg.d_model), bf16),
                    "tokens": _sds((B, 1), i32)}
        if cfg.family == "vlm":
            Pn = cfg.num_patches
            return {"tokens": _sds((B, S - Pn), i32),
                    "patches": _sds((B, Pn, cfg.d_model), bf16)}
        return {"tokens": _sds((B, S), i32)}

    if shape.kind == "decode":
        return {"tokens": _sds((B,), i32)}
    raise ValueError(shape.kind)


def decode_state_kw(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """What ``init_decode_state`` takes beyond the batch and length for a
    cell's state in the reference's layout: whisper's cross K/V over
    ``seq_len`` encoder positions (the port's own state holds none until
    prefill fills them)."""
    return {"cross_len": shape.seq_len} if cfg.family == "audio" else {}


def state_specs(cfg: ModelConfig, shape: ShapeSpec, *, kv_dtype=None):
    """The decode state (KV caches / SSM states) of a serve cell, built
    under ``FakeTensorMode`` (:func:`decode_state_kw`) and returned as
    meta tensors; the position, a Python int in the port's state, stands as
    a 0-d int32 (the reference's aval)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.checkpoint.ckpt import flatten, unflatten
    from repro_torch.models.registry import get_model

    with FakeTensorMode():
        state = get_model(cfg).init_decode_state(
            shape.global_batch, shape.seq_len, kv_dtype=kv_dtype,
            device="cpu", **decode_state_kw(cfg, shape))
    leaves, _ = flatten(state)
    return unflatten(state, [
        _sds(x.shape, x.dtype) if isinstance(x, torch.Tensor)
        else _sds((), torch.int32) for x in leaves])


def default_kv_dtype(arch: str, shape_name: str):
    """int8 KV where bf16 exceeds the single-pod memory budget."""
    if arch == "qwen1.5-32b" and shape_name == "decode_32k":
        return torch.int8
    return None
