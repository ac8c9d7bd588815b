"""Device selection shared by the port's entry points.

Every entry point takes an explicit ``device`` and defaults to the card.
There is no fallback: asking for CUDA on a machine without a GPU raises,
and the CPU runs only when the caller names it (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the GPU by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_name(device: Optional[torch.device]) -> str:
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
