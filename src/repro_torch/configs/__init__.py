"""Published model configurations, as shapes (no weights).

Counterpart of ``repro/configs/__init__.py``.  ``get_config(name)`` returns
the exact published :class:`~repro_torch.models.common.ModelConfig` of each
of the reference's ten architectures, in its order: dense (qwen1.5-32b,
llama3-8b, qwen2.5-14b, gemma2-27b), ssm (mamba2-2.7b), audio
(whisper-medium), moe (llama4-scout-17b-a16e, qwen3-moe-30b-a3b), hybrid
(zamba2-1.2b) and vlm (internvl2-26b).  The reference's dry-run helpers
(``ShapeSpec``, ``input_specs``, ``state_specs``, built on
``jax.ShapeDtypeStruct``) wait for ROADMAP A14b-5.
"""

from __future__ import annotations

import importlib

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

#: the ROADMAP item that ports the reference's dry-run helpers
OTHER_ARCHS_ITEM = "A14b-5 (the dry-run's shapes)"

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not an architecture of repro_torch: "
                       f"{', '.join(ARCHS)} (the dry-run's shapes wait for "
                       f"ROADMAP {OTHER_ARCHS_ITEM})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG
