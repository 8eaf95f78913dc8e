"""Parameter initializers: the MNIST trainer's ``weights_init_normal``.

PyTorch counterpart of ``eadgan_tpu/ops/init.py``.  Two regimes exist in
the reference:

* PyTorch's defaults (``kaiming_uniform_(a=sqrt(5))`` weights, the same
  bound for biases) everywhere but MNIST.  The port's layers are torch's
  own ``nn.Conv2d`` / ``nn.Linear`` / ``nn.ConvTranspose2d`` and take
  them at construction, so no helper is needed for them;
* ``weights_init_normal``, applied by the MNIST trainer to its three
  models: N(0, 0.02) conv weights, N(1, 0.02) BatchNorm scales and zero
  BatchNorm biases (:func:`weights_init_normal`).

Both are reproduced as distributions, not bit for bit.
"""

from __future__ import annotations

import torch
from torch import nn

from eadgan_tpu_torch.models.layers import TorchBatchNorm, TorchConv, _SpectralNorm

__all__ = ["weights_init_normal"]


@torch.no_grad()
def weights_init_normal(model: nn.Module) -> nn.Module:
    """The reference's ``weights_init_normal`` as it takes effect: every
    plain conv's weight from N(0, 0.02) (its bias keeps torch's default),
    every BatchNorm's scale from N(1, 0.02) and its bias 0, drawn from the
    global torch generator.

    Spectral-normalized convs keep torch's default init: in the reference
    the hook recomputes ``weight`` from ``weight_orig`` at the first
    forward, so the normal draw written into ``weight`` never reaches a
    forward (the JAX package's ``SNConv`` does the same).  Returns
    ``model``."""
    for m in model.modules():
        if isinstance(m, TorchConv) and not isinstance(m, _SpectralNorm):
            m.weight.normal_(0.0, 0.02)
        elif isinstance(m, TorchBatchNorm):
            m.weight.normal_(1.0, 0.02)
            m.bias.zero_()
    return model
