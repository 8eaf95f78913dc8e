"""Model families (PyTorch counterpart of ``eadgan_tpu.models``)."""

from eadgan_tpu_torch.models.approximator import AffineApproximator
from eadgan_tpu_torch.models.celeba import CelebaDiscriminator, CelebaGenerator
from eadgan_tpu_torch.models.dsprites import (
    SpritesDiscriminator,
    SpritesEncoder,
    SpritesEncoderPxy,
    SpritesGenerator,
)
from eadgan_tpu_torch.models.layers import (
    SNConv,
    SNDense,
    TorchBatchNorm,
    TorchDense,
    no_stat_updates,
)
from eadgan_tpu_torch.models.mnist import MnistDiscriminator, MnistEncoder, MnistGenerator

__all__ = [
    "AffineApproximator",
    "CelebaGenerator",
    "CelebaDiscriminator",
    "MnistGenerator",
    "MnistDiscriminator",
    "MnistEncoder",
    "SpritesEncoderPxy",
    "SpritesGenerator",
    "SpritesDiscriminator",
    "SpritesEncoder",
    "SNConv",
    "SNDense",
    "TorchBatchNorm",
    "TorchDense",
    "no_stat_updates",
]
