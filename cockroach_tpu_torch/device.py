"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device an entry point runs on. ``"cuda"`` (the default of
    every entry point) requires a card: without one this raises instead of
    falling back to the CPU, which only an explicit ``device="cpu"``
    selects."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
