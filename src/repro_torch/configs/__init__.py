"""Architecture registry of the port: ``get_config(arch_id, reduced=False)``.

The reference registers ten architectures (``ARCH_IDS``), and the port runs
all of them.  Each module is a copy of the reference's and exports
``CONFIG`` (the exact published configuration) and ``reduced()`` (a
same-family small variant for CPU tests).  An unknown id raises
``ValueError``.
"""

from __future__ import annotations

import importlib
from typing import List

ARCH_IDS: List[str] = [
    "jamba_1_5_large_398b",
    "falcon_mamba_7b",
    "nemotron_4_340b",
    "gemma3_12b",
    "chatglm3_6b",
    "qwen3_4b",
    "whisper_large_v3",
    "internvl2_26b",
    "olmoe_1b_7b",
    "qwen2_moe_a2_7b",
]

# assignment-sheet ids -> module names
ALIASES = {
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma3-12b": "gemma3_12b",
    "chatglm3-6b": "chatglm3_6b",
    "qwen3-4b": "qwen3_4b",
    "whisper-large-v3": "whisper_large_v3",
    "internvl2-26b": "internvl2_26b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
}


def get_config(arch: str, reduced: bool = False):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.CONFIG
