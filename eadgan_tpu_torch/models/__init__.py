"""Model families (PyTorch counterpart of ``eadgan_tpu.models``)."""

from eadgan_tpu_torch.models.celeba import CelebaDiscriminator, CelebaGenerator
from eadgan_tpu_torch.models.layers import SNConv, TorchBatchNorm, no_stat_updates

__all__ = [
    "CelebaGenerator",
    "CelebaDiscriminator",
    "SNConv",
    "TorchBatchNorm",
    "no_stat_updates",
]
