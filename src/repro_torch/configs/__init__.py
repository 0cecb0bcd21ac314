"""Architecture registry: one module per architecture (port of the JAX
package's ``configs/``, each file the same config).

`get_config(arch_id)` returns the full published config;
`get_reduced(arch_id)` returns the same-family CPU smoke-test variant.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import reduced

ARCH_IDS = (
    "qwen1_5_0_5b",
    "gemma3_4b",
    "internlm2_20b",
    "gemma3_27b",
    "internvl2_2b",
    "moonshot_v1_16b_a3b",
    "arctic_480b",
    "whisper_medium",
    "zamba2_2_7b",
    "mamba2_1_3b",
    "paraqaoa",  # the paper's own workload, first-class citizen
)

# dashed aliases matching the assignment table
ALIASES = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "gemma3-4b": "gemma3_4b",
    "internlm2-20b": "internlm2_20b",
    "gemma3-27b": "gemma3_27b",
    "internvl2-2b": "internvl2_2b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "arctic-480b": "arctic_480b",
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "paraqaoa": "paraqaoa",
}


def canonical(arch_id: str) -> str:
    return ALIASES.get(arch_id, arch_id)


def get_config(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    return mod.CONFIG


def get_reduced(arch_id: str):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")
    if hasattr(mod, "REDUCED"):
        return mod.REDUCED
    return reduced(mod.CONFIG)


def lm_arch_ids():
    return tuple(a for a in ARCH_IDS if a != "paraqaoa")
