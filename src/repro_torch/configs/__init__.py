"""Architecture registry of the port: ``get_config(arch_id, reduced=False)``.

The reference registers ten architectures (``ARCH_IDS``); the port runs the
ones whose paths it has ported.  Each of those modules is a copy of the
reference's and exports ``CONFIG`` (the exact published configuration) and
``reduced()`` (a same-family small variant for CPU tests).  Asking for one
of the others raises ``NotImplementedError`` naming the slice that brings it.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

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

PORTED = ("qwen3_4b",)

# the slice of the port that brings each architecture not yet ported
MISSING_SLICE: Dict[str, str] = {
    "jamba_1_5_large_398b": "the Mamba and MoE slices",
    "falcon_mamba_7b": "the Mamba slice",
    "nemotron_4_340b": "the dense-configs slice (layernorm, squared-ReLU MLP)",
    "gemma3_12b": "the dense-configs slice (5:1 local:global windows)",
    "chatglm3_6b": "the dense-configs slice (partial 2d RoPE)",
    "whisper_large_v3": "the encoder-decoder slice (attend_cross)",
    "internvl2_26b": "the vision-frontend slice",
    "olmoe_1b_7b": "the MoE slice",
    "qwen2_moe_a2_7b": "the MoE slice",
}


def get_config(arch: str, reduced: bool = False):
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name in MISSING_SLICE:
        raise NotImplementedError(
            f"{arch} is not ported yet: it comes with {MISSING_SLICE[mod_name]}"
        )
    if mod_name not in PORTED:
        raise ValueError(f"unknown architecture {arch!r}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.reduced() if reduced else mod.CONFIG
