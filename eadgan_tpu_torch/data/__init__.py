"""Dataset ingest (host numpy/PIL)."""

from eadgan_tpu_torch.data.celeba import load_image_folder

__all__ = ["load_image_folder"]
