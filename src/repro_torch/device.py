"""Where the port's entry points run: ``device=None`` means the GPU."""
from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[torch.device | str]) -> torch.device:
    """``None`` means the GPU; without one that is an error, never a
    quiet fall-back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)
