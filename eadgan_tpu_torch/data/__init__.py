"""Dataset ingest (host numpy/PIL)."""

from eadgan_tpu_torch.data.celeba import load_image_folder
from eadgan_tpu_torch.data.dsprites import DspritesData, load_dsprites
from eadgan_tpu_torch.data.mnist import load_mnist

__all__ = ["load_image_folder", "load_dsprites", "DspritesData", "load_mnist"]
