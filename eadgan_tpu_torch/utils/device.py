"""Device selection: the card unless the caller asks for the CPU."""

from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "platform_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none (never a quiet fall back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: pass device='cpu' to run on the CPU "
            "(EADGAN_PLATFORM=cpu for the command-line entry points)"
        )
    return torch.device("cuda")


def platform_device() -> torch.device:
    """The entry points' device: ``EADGAN_PLATFORM=cpu`` selects the CPU;
    unset, ``cuda`` or ``gpu`` selects the card (raising without one)."""
    platform = os.environ.get("EADGAN_PLATFORM", "").lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform in ("", "cuda", "gpu"):
        return resolve_device(None)
    raise ValueError(f"EADGAN_PLATFORM={platform!r}: expected cpu, cuda or gpu")
