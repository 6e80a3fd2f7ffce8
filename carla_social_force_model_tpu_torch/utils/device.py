"""The device the port's entry points build on.

The port is written for one NVIDIA card: every entry point that takes a
``device`` defaults to ``"cuda"``, and a caller gets the CPU only by asking
for it (``device="cpu"``, as the CPU tests do).  Without a card the default
raises; nothing falls back to the CPU.
"""
from __future__ import annotations

import torch

#: what every entry point's ``device`` argument defaults to
DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` when it
    names CUDA and this host has no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card is available: the port builds on the card by "
            "default; pass device='cpu' to run on the CPU")
    return dev
