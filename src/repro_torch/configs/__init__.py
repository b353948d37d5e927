"""Architecture registry: one module per assigned architecture (a copy
of ``repro.configs`` built on the port's ``ModelConfig``).

``get_config(arch_id)`` returns the full published config;
``repro_torch.configs.shapes`` defines the per-arch input-shape set.
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "olmoe-1b-7b",
    "kimi-k2-1t-a32b",
    "musicgen-medium",
    "granite-34b",
    "llama3_2-1b",
    "gemma-2b",
    "granite-20b",
    "recurrentgemma-2b",
    "phi-3-vision-4_2b",
    "xlstm-125m",
)

# CLI ids (with dots) → module names.
ALIASES = {
    "llama3.2-1b": "llama3_2-1b",
    "phi-3-vision-4.2b": "phi-3-vision-4_2b",
}


def get_config(arch_id: str):
    arch_id = ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    mod = importlib.import_module(
        f"repro_torch.configs.{arch_id.replace('-', '_').replace('.', '_')}")
    return mod.get_config()


def all_configs():
    return {a: get_config(a) for a in ARCH_IDS}
