"""Explicit device selection: no silent fallback from the card to the CPU."""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) raises when CUDA is absent; ``"cpu"``
    is used only when asked for by name."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() is "
                "False (pass device='cpu' to run the plain versions)"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
