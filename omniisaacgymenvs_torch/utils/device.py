"""Device selection: the port's entry points run on CUDA unless the caller
asks for the CPU, and never fall back to the CPU on their own."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (default "cuda") as a torch.device; raises when CUDA is
    asked for and not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev
