"""Architecture config registry of the PyTorch port.

Only the architectures whose serving or training path has been ported
are registered; ``get_config`` of any other name of the reference's registry
says that the architecture is not yet ported (ROADMAP.md).
Names resolve with dashes or underscores, as in the reference.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch import roadmap
from repro_torch.config import ArchConfig

# registry id -> module name
_REGISTRY: Dict[str, str] = {
    "gpt2-small": "gpt2_small",
    "mamba2-780m": "mamba2_780m",
    "opt-125m": "opt_125m",
    "gpt-neo-125m": "gpt_neo_125m",
    "llama3-8b": "llama3_8b",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "qwen1.5-32b": "qwen1p5_32b",
    "mistral-large-123b": "mistral_large_123b",
    "zamba2-1.2b": "zamba2_1p2b",
}

# the reference's other registry ids: known, not yet ported
_NOT_YET_PORTED = (
    "internvl2-76b", "kimi-k2-1t-a32b",
    "llama4-maverick-400b-a17b", "whisper-medium",
)


def _canon(name: str) -> str:
    return name.lower().replace("_", "-")


def get_config(name: str) -> ArchConfig:
    key = _canon(name)
    if key in _REGISTRY:
        mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[key]}")
        return mod.config()
    if key in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"architecture {name!r} is not yet ported to repro_torch "
            f"(ported: {sorted(_REGISTRY)}; see {roadmap.FAMILIES})")
    raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
