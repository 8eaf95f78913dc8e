"""Model families (PyTorch counterpart of ``eadgan_tpu.models``)."""

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

__all__ = [
    "CelebaGenerator",
    "CelebaDiscriminator",
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
