"""MNIST model family (32x32 grayscale, InfoGAN-style), NCHW.

PyTorch counterpart of ``eadgan_tpu/models/mnist.py``.  ``state_dict``
keys follow the reference layout: the generator's ``l1.0`` and
``conv_blocks.*``, the discriminator's ``conv_blocks.*`` and
``adv_layer.0``, the encoder's ``conv_blocks.*``, ``aux_layer.0``,
``latent_layer.0`` and ``noise_layer.0`` (spectral-norm layers carry
``weight``, ``bias`` and flax's ``u``/``sigma``).

Each model takes the reference's ``weights_init_normal`` at construction
(``ops/init.py``): the generator's conv weights and every BatchNorm scale
from N(0 or 1, 0.02); the spectral-normed convs keep torch's default, as
the reference's hook overwrites the normal draw at the first forward.

Quirks kept from the reference:

* the generator's first BatchNorm has eps 1e-5, its two inner ones eps
  0.8 (``nn.BatchNorm2d(ch, 0.8)`` sets eps positionally);
* the encoder's BatchNorms after blocks 2-4 (eps 0.8) always normalize
  with batch statistics, in eval mode too (``always_batch_stats``), as
  the JAX model calls them without ``use_running_average``;
* the discriminator returns raw logits (the LSGAN loss is an MSE).

The generator's fc output is viewed as (B, 128, 8, 8) directly, as the
JAX model reshapes it NCHW-style before its transpose: no row
permutation.  The flatten before the discriminator's and encoder's heads
is (C, H, W) here and (H, W, C) in the JAX models, so weights carried
from flax have those heads' input rows permuted
(``interop/from_jax.py``).

``dtype`` is the compute type (None: float32; ``torch.bfloat16``).  G
returns its tanh in float32 (taken on the float32 cast), D computes its
head in float32 on the cast activations (the JAX head has no compute
type and promotes), E casts to float32 before its three heads.
"""

from __future__ import annotations

import torch
from torch import nn

from eadgan_tpu_torch.models.layers import (
    SNConv,
    SNDense,
    TorchBatchNorm,
    TorchConv,
    TorchDense,
    UpsampleNearest,
)
from eadgan_tpu_torch.ops.init import weights_init_normal

__all__ = ["MnistGenerator", "MnistDiscriminator", "MnistEncoder"]

_TRUNK = (16, 32, 64, 128)


class MnistGenerator(nn.Module):
    """Linear(z || label || code -> 128 * (S/4)^2), then BN, upsample,
    conv 128, BN(0.8), LeakyReLU(0.2), upsample, conv 64, BN(0.8),
    LeakyReLU(0.2), conv to ``channels`` and a tanh.
    ``forward(noise, labels, code)`` returns (B, channels, S, S)."""

    def __init__(self, latent_dim: int = 62, n_classes: int = 10, code_dim: int = 7,
                 img_size: int = 32, channels: int = 1, dtype=None):
        super().__init__()
        self.init_size = img_size // 4
        self.l1 = nn.Sequential(
            TorchDense(latent_dim + n_classes + code_dim, 128 * self.init_size**2, dtype=dtype)
        )
        self.conv_blocks = nn.Sequential(
            TorchBatchNorm(128),
            UpsampleNearest(),
            TorchConv(128, 128, 3, 1, 1, dtype=dtype),
            TorchBatchNorm(128, eps=0.8),
            nn.LeakyReLU(0.2),
            UpsampleNearest(),
            TorchConv(128, 64, 3, 1, 1, dtype=dtype),
            TorchBatchNorm(64, eps=0.8),
            nn.LeakyReLU(0.2),
            TorchConv(64, channels, 3, 1, 1, dtype=dtype),
        )
        weights_init_normal(self)

    def forward(self, noise, labels, code):
        x = self.l1(torch.cat([noise, labels, code], dim=-1))
        x = x.view(x.shape[0], 128, self.init_size, self.init_size)
        return torch.tanh(self.conv_blocks(x).float())


def _sn_block(cin: int, cout: int, dtype, bn: bool):
    layers = [SNConv(cin, cout, 3, 2, 1, dtype=dtype), nn.LeakyReLU(0.2)]
    if bn:
        layers.append(TorchBatchNorm(cout, eps=0.8, always_batch_stats=True))
    return layers


class MnistDiscriminator(nn.Module):
    """Four SN-conv blocks 1 -> 16 -> 32 -> 64 -> 128 (k3 s2 p1,
    LeakyReLU 0.2) and an SN-Linear -> 1; returns (B, 1) float32 logits."""

    def __init__(self, img_size: int = 32, channels: int = 1, dtype=None):
        super().__init__()
        layers = []
        for cin, cout in zip((channels,) + _TRUNK[:-1], _TRUNK):
            layers += _sn_block(cin, cout, dtype, bn=False)
        self.conv_blocks = nn.Sequential(*layers)
        self.adv_layer = nn.Sequential(SNDense(128 * (img_size // 16) ** 2, 1))
        weights_init_normal(self)

    def forward(self, img):
        return self.adv_layer(self.conv_blocks(img).flatten(1).float())


class MnistEncoder(nn.Module):
    """The discriminator's SN-conv trunk with a BatchNorm(eps 0.8) after
    blocks 2-4, and three SN heads in float32: a softmax over the
    classes, the code and the noise.  Returns ``(label, code, noise)``."""

    def __init__(self, latent_dim: int = 62, n_classes: int = 10, code_dim: int = 7,
                 img_size: int = 32, channels: int = 1, dtype=None):
        super().__init__()
        layers = []
        for i, (cin, cout) in enumerate(zip((channels,) + _TRUNK[:-1], _TRUNK)):
            layers += _sn_block(cin, cout, dtype, bn=i > 0)
        self.conv_blocks = nn.Sequential(*layers)
        flat = 128 * (img_size // 16) ** 2
        self.aux_layer = nn.Sequential(SNDense(flat, n_classes), nn.Softmax(dim=-1))
        self.latent_layer = nn.Sequential(SNDense(flat, code_dim))
        self.noise_layer = nn.Sequential(SNDense(flat, latent_dim))
        weights_init_normal(self)

    def forward(self, img):
        h = self.conv_blocks(img).flatten(1).float()
        return self.aux_layer(h), self.latent_layer(h), self.noise_layer(h)
