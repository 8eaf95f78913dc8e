"""Train-state container and the optimizer factory.

PyTorch counterpart of ``eadgan_tpu/train/state.py``.  The state is a
plain object holding the two models, three ``torch.optim.Adam`` over
overlapping parameter sets, the step count and a ``torch.Generator`` in
place of the JAX ``rng``.  The info optimizer runs over G *and* D with
moments of its own, as two torch optimizers over the same tensors do.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

__all__ = ["adam", "GanTrainState"]


def adam(params, lr: float, b1: float = 0.5, b2: float = 0.999) -> torch.optim.Adam:
    """``torch.optim.Adam`` with the reference betas and eps 1e-8."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)


@dataclasses.dataclass
class GanTrainState:
    """Full adversarial-pipeline state; the step functions update it in
    place."""

    g: nn.Module
    d: nn.Module
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    opt_info: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
