"""Where the port runs: every entry point defaults to the card."""
from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device``, or CUDA when it is None.

    There is no CPU fallback: asking for CUDA where it is absent raises.
    The caller asks for the CPU with ``device="cpu"``.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: CUDA is not available "
                           "(pass device='cpu' to run on the CPU)")
    return device
