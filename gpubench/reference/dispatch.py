"""Device policy of the frozen reference: plain PyTorch on the device of
its operands; ``device=None`` is the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    return torch.device("cpu" if device is None else device)
