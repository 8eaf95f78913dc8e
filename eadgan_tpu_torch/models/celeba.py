"""CelebA model family (64x64 RGB, DCGAN scale), NCHW.

PyTorch counterpart of ``eadgan_tpu/models/celeba.py``.  ``state_dict``
keys follow the reference layout: ``conv_blocks.*`` for the generator
and ``main.*`` for the discriminator (spectral-norm layers carry
``weight``, ``bias`` and flax's ``u``/``sigma``).

``dtype`` is the compute type, as the JAX models' field: ``None`` is
float32, ``torch.bfloat16`` runs every conv in bf16 (``models/layers.py``)
while parameters, BatchNorm statistics and spectral-norm state stay
float32.  Both models return float32: G casts its tanh output, D its head
output, before the splits.
"""

from __future__ import annotations

import torch
from torch import nn

from eadgan_tpu_torch.models.layers import SNConv, TorchBatchNorm, TorchConv, TorchConvTranspose

__all__ = ["CelebaGenerator", "CelebaDiscriminator"]


class CelebaGenerator(nn.Module):
    """ConvT(218 -> 1024, 4, 1, 0) -> 512 -> 256 -> 128 -> 3 with BN+ReLU
    between stages and a tanh.  Quirk kept from the reference: no BN or
    ReLU after the first ConvT.  ``forward(noise, labels, code)`` returns
    (B, channels, 64, 64)."""

    def __init__(self, latent_dim: int = 200, n_classes: int = 10, code_dim: int = 8,
                 channels: int = 3, dtype=None):
        super().__init__()
        in_dim = latent_dim + n_classes + code_dim
        layers = [TorchConvTranspose(in_dim, 1024, 4, 1, 0, dtype=dtype)]
        for cin, cout in ((1024, 512), (512, 256), (256, 128)):
            layers += [
                TorchConvTranspose(cin, cout, 4, 2, 1, dtype=dtype), TorchBatchNorm(cout), nn.ReLU()
            ]
        layers += [TorchConvTranspose(128, channels, 4, 2, 1, dtype=dtype), nn.Tanh()]
        self.conv_blocks = nn.Sequential(*layers)

    def forward(self, noise, labels, code):
        x = torch.cat([noise, labels, code], dim=-1)[:, :, None, None]
        return self.conv_blocks(x).float()


class CelebaDiscriminator(nn.Module):
    """SN-conv tower 3 -> 128 -> 256 -> 512 -> 1024 (k4 s2 p1, LeakyReLU
    0.1) and a plain Conv(1024 -> 1 + n_classes + code_dim, 4, 1, 0).
    Returns ``(cat, cont, validity)``: validity = sigmoid(out[:, 0]),
    cont = out[:, 1:code_dim+1], cat = softmax(out[:, code_dim+1:])."""

    def __init__(self, n_classes: int = 10, code_dim: int = 8, channels: int = 3, dtype=None):
        super().__init__()
        self.n_classes = n_classes
        self.code_dim = code_dim
        layers = []
        for cin, cout in ((channels, 128), (128, 256), (256, 512), (512, 1024)):
            layers += [SNConv(cin, cout, 4, 2, 1, dtype=dtype), nn.LeakyReLU(0.1)]
        layers += [TorchConv(1024, 1 + n_classes + code_dim, 4, 1, 0, dtype=dtype)]
        self.main = nn.Sequential(*layers)

    def forward(self, img):
        out = self.main(img).flatten(1).float()
        validity = torch.sigmoid(out[:, 0])
        cont = out[:, 1 : self.code_dim + 1]
        cat = torch.softmax(out[:, self.code_dim + 1 : self.code_dim + 1 + self.n_classes], dim=-1)
        return cat, cont, validity
