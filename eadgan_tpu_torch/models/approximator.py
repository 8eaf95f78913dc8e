"""Affine-inverse approximator MLP.

PyTorch counterpart of ``eadgan_tpu/models/approximator.py``: Linear
6 -> 256 -> 256 -> 256 -> 256 -> 7 with LeakyReLU(0.01), torch's default
init.  It maps a flattened 2x3 relative affine matrix to the seven
physical rpqmnxy parameters, the neural stand-in for an inverse that has
no closed form (``transforms/neural.py``).  ``state_dict`` keys follow
the reference layout, ``fc_block.{0,2,4,6,8}``.  Always float32.
"""

from __future__ import annotations

import torch
from torch import nn

from eadgan_tpu_torch.models.layers import TorchDense

__all__ = ["AffineApproximator"]


class AffineApproximator(nn.Module):
    def __init__(self, hidden: int = 256, out_dim: int = 7, depth: int = 4, in_dim: int = 6):
        super().__init__()
        layers = []
        for i in range(depth):
            layers += [TorchDense(in_dim if i == 0 else hidden, hidden), nn.LeakyReLU(0.01)]
        layers += [TorchDense(hidden, out_dim)]
        self.fc_block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc_block(x)
