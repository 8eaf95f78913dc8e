"""dSprites model family (64x64, grayscale or colored), NCHW.

PyTorch counterpart of ``eadgan_tpu/models/dsprites.py``.  ``channels=3``
and the wider code dims give the colored variants.  ``state_dict`` keys
follow the reference layout: ``conv_block.*``, ``fc1``/``fc1.0``,
``fc2``/``fc2.0``, ``cat_layer.0``, ``cont_layer.0`` (spectral-norm
layers carry ``weight``, ``bias`` and flax's ``u``/``sigma``).

The flatten before each trunk's first fc is NCHW, in (C, H, W) order,
where the JAX models flatten NHWC in (H, W, C) order: weights carried
from flax have that fc's input rows permuted
(``interop/from_jax.py``).  The generator's fc output is viewed as
(B, 64, 4, 4) directly, as the JAX model reshapes it NCHW-style.

``dtype`` is the compute type of G, D and E (None: float32;
``torch.bfloat16``); the aligner is always float32.  G returns its
sigmoid cast to float32, D takes its sigmoid in float32, E casts to
float32 before its two heads, which have no compute type.
"""

from __future__ import annotations

import torch
from torch import nn

from eadgan_tpu_torch.models.layers import (
    SNConv,
    SNDense,
    TorchBatchNorm,
    TorchConv,
    TorchConvTranspose,
    TorchDense,
)

__all__ = [
    "SpritesEncoderPxy",
    "SpritesGenerator",
    "SpritesDiscriminator",
    "SpritesEncoder",
]

_TRUNK = (32, 32, 64, 64)
_FLAT = 64 * 4 * 4


def _trunk(conv, channels: int, slope: float, **kw) -> nn.Sequential:
    """Four k4 s2 p1 convs, each followed by a LeakyReLU: 64x64 -> 4x4."""
    layers = []
    for cin, cout in zip((channels,) + _TRUNK[:-1], _TRUNK):
        layers += [conv(cin, cout, 4, 2, 1, **kw), nn.LeakyReLU(slope)]
    return nn.Sequential(*layers)


class SpritesEncoderPxy(nn.Module):
    """The alignment encoder: plain conv trunk with LeakyReLU(0.1) and
    Linear(1024 -> out_dim); out_dim 3 (p, x, y) gray, 6 colored."""

    def __init__(self, out_dim: int = 3, channels: int = 1):
        super().__init__()
        self.conv_block = _trunk(TorchConv, channels, 0.1)
        self.fc1 = TorchDense(_FLAT, out_dim)

    def forward(self, img):
        return self.fc1(self.conv_block(img).flatten(1))


class SpritesGenerator(nn.Module):
    """fc(in -> 128 -> 64*4*4) + 3 x (ConvT(4, 2, 1) + BN + ReLU) +
    ConvT -> sigmoid.  Input is the label one-hot || code (no noise)."""

    def __init__(self, in_dim: int = 7, channels: int = 1, dtype=None):
        super().__init__()
        self.fc1 = nn.Sequential(TorchDense(in_dim, 128, dtype=dtype), nn.ReLU())
        self.fc2 = nn.Sequential(TorchDense(128, _FLAT, dtype=dtype), nn.ReLU())
        layers = []
        for _ in range(3):
            layers += [TorchConvTranspose(64, 64, 4, 2, 1, dtype=dtype), TorchBatchNorm(64), nn.ReLU()]
        layers += [TorchConvTranspose(64, channels, 4, 2, 1, dtype=dtype)]
        self.conv_block = nn.Sequential(*layers)

    def forward(self, z_c):
        h = self.fc2(self.fc1(z_c)).view(-1, 64, 4, 4)
        return torch.sigmoid(self.conv_block(h)).float()


class SpritesDiscriminator(nn.Module):
    """SN-conv trunk with LeakyReLU(0.2), SN fc 1024 -> 128, fc 128 -> 1;
    returns the (B, 1) sigmoid."""

    def __init__(self, channels: int = 1, dtype=None):
        super().__init__()
        self.conv_block = _trunk(SNConv, channels, 0.2, dtype=dtype)
        self.fc1 = nn.Sequential(SNDense(_FLAT, 128, dtype=dtype), nn.LeakyReLU(0.2))
        self.fc2 = TorchDense(128, 1, dtype=dtype)

    def forward(self, img):
        h = self.fc1(self.conv_block(img).flatten(1))
        return torch.sigmoid(self.fc2(h).float())


class SpritesEncoder(nn.Module):
    """SN-conv trunk + two SN fc layers, then a softmax category head and
    a continuous code head (both SN, float32).  Returns ``(cat, cont)``;
    code_dim 4 gray, 7 colored."""

    def __init__(self, n_classes: int = 3, code_dim: int = 4, channels: int = 1, dtype=None):
        super().__init__()
        self.conv_block = _trunk(SNConv, channels, 0.2, dtype=dtype)
        self.fc1 = nn.Sequential(SNDense(_FLAT, 128, dtype=dtype), nn.LeakyReLU(0.2))
        self.fc2 = nn.Sequential(SNDense(128, 128, dtype=dtype), nn.LeakyReLU(0.2))
        self.cat_layer = nn.Sequential(SNDense(128, n_classes), nn.Softmax(dim=-1))
        self.cont_layer = nn.Sequential(SNDense(128, code_dim))

    def forward(self, img):
        h = self.fc2(self.fc1(self.conv_block(img).flatten(1))).float()
        return self.cat_layer(h), self.cont_layer(h)
