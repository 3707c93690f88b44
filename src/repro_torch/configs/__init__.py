"""Published model configurations, as shapes (no weights).

Counterpart of ``repro/configs/__init__.py``.  ``get_config(name)`` returns
the exact published :class:`~repro_torch.models.common.ModelConfig`.  The
transformer's three families are ported: dense (llama3-8b, qwen1.5-32b,
qwen2.5-14b, gemma2-27b), moe (qwen3-moe-30b-a3b, llama4-scout-17b-a16e)
and vlm (internvl2-26b).  The other architectures of the reference wait
for ROADMAP A14b-3 (mamba2-2.7b, zamba2-1.2b) and A14b-4 (whisper-medium),
and its dry-run helpers (``ShapeSpec``, ``input_specs``, ``state_specs``,
built on ``jax.ShapeDtypeStruct``) for A14b-5.
"""

from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen1.5-32b": "qwen1p5_32b",
    "llama3-8b": "llama3_8b",
    "qwen2.5-14b": "qwen2p5_14b",
    "gemma2-27b": "gemma2_27b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "internvl2-26b": "internvl2_26b",
}

#: the ROADMAP item that ports the other architectures
OTHER_ARCHS_ITEM = ("A14b-3 (SSM and hybrid), A14b-4 (whisper) and A14b-5 "
                    "(the dry-run's shapes)")

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"{name!r} is not ported to repro_torch; ported: "
                       f"{', '.join(ARCHS)} (the others wait for ROADMAP "
                       f"{OTHER_ARCHS_ITEM})")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG
