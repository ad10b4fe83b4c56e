"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

Every assigned architecture from the public pool, plus the paper's own
GPT-Neo-1.3B-scale decoder (its largest evaluated model).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "phi3_5_moe_42b", "musicgen_medium", "hymba_1_5b", "starcoder2_3b",
    "internvl2_26b", "olmoe_1b_7b", "starcoder2_15b", "qwen3_32b",
    "qwen2_0_5b", "xlstm_350m", "eris_gptneo_1_3b",
]

_ALIASES = {
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "musicgen-medium": "musicgen_medium",
    "hymba-1.5b": "hymba_1_5b",
    "starcoder2-3b": "starcoder2_3b",
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "starcoder2-15b": "starcoder2_15b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-0.5b": "qwen2_0_5b",
    "xlstm-350m": "xlstm_350m",
    "eris-gptneo-1.3b": "eris_gptneo_1_3b",
}


def canonical(arch_id: str) -> str:
    key = arch_id.replace("_", "-").lower()
    return _ALIASES.get(key, arch_id.replace("-", "_").replace(".", "_"))


def get_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


def all_configs():
    return {a: get_config(a) for a in ARCHS}
