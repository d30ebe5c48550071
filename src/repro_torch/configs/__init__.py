"""Own copy of ``repro/configs`` for the PyTorch port (each module imports
``repro_torch.models.config``).

Assigned architecture registry: one module per architecture (``--arch``)."""
from __future__ import annotations

import importlib

ARCHS = [
    "hubert_xlarge",
    "qwen3_14b",
    "granite_3_8b",
    "qwen2_7b",
    "phi4_mini_3_8b",
    "falcon_mamba_7b",
    "llama_3_2_vision_90b",
    "grok_1_314b",
    "deepseek_moe_16b",
    "recurrentgemma_9b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCHS}


def get_config(name: str):
    mod = _ALIAS.get(name, name).replace("-", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
