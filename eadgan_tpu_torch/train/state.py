"""Train-state containers and the optimizer factory.

PyTorch counterpart of ``eadgan_tpu/train/state.py``.  A state is a plain
object holding the models, ``torch.optim.Adam`` optimizers over
overlapping parameter sets, the step count and a ``torch.Generator`` in
place of the JAX ``rng``.  An info optimizer runs over two models (G and
D for CelebA, G and E for dSprites and MNIST) with moments of its own, as
two torch optimizers over the same tensors do.  The step functions update
a state in place; ``train/checkpoint.py`` saves whatever fields it holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

__all__ = ["adam", "GanTrainState", "EncoderTrainState"]


def adam(params, lr: float, b1: float = 0.5, b2: float = 0.999,
         capturable: bool = False) -> torch.optim.Adam:
    """``torch.optim.Adam`` with the reference betas and eps 1e-8.

    ``capturable`` keeps Adam's step count on the card and computes the
    bias corrections there, which CUDA-graph replay of a step needs (a
    host count would move once, at capture).  The CPU build refuses it.
    The trainers' inits pass ``capturable=True`` for every state on the
    card, per-step or chained, so both engines run the same Adam and a
    train state moves between them unchanged."""
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8, capturable=capturable)


@dataclasses.dataclass
class GanTrainState:
    """Adversarial-pipeline state.  ``e`` is the separate encoder
    (dSprites, MNIST), ``pxy`` the frozen alignment encoder (dSprites)
    and ``approx`` the frozen affine approximator (MNIST); ``opt_g`` is
    None for dSprites, whose G update lives in ``opt_info``."""

    g: nn.Module
    d: nn.Module
    opt_g: Optional[torch.optim.Optimizer]
    opt_d: torch.optim.Optimizer
    opt_info: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
    e: Optional[nn.Module] = None
    pxy: Optional[nn.Module] = None
    approx: Optional[nn.Module] = None


@dataclasses.dataclass
class EncoderTrainState:
    """Single-model pretraining state (the pxy alignment encoders, the
    affine approximator)."""

    model: nn.Module
    opt: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
