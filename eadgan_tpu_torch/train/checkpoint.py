"""Checkpoint writing (the reference-contract model files).

PyTorch counterpart of the part of ``eadgan_tpu/train/checkpoint.py``
that the CelebA trainer's ``checkpoint_%d.tar`` needs.  Writes are
atomic: a temporary file in the same directory, fsynced, then
``os.replace`` — a crash mid-write leaves the previous file intact.
The train-state file and resume belong to a later slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn

__all__ = ["save_checkpoint", "cpu_state_dict"]


def cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every tensor detached and on the CPU,
    so the file loads on any machine."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save(obj)`` to ``path`` atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            torch.save(obj, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
