"""Dataset ingest (host numpy/PIL)."""

from eadgan_tpu_torch.data.celeba import load_image_folder
from eadgan_tpu_torch.data.dsprites import DspritesData, load_dsprites

__all__ = ["load_image_folder", "load_dsprites", "DspritesData"]
