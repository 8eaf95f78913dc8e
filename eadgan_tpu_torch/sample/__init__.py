"""Artifact rendering: image grids with torchvision parity (numpy + PIL)."""

from eadgan_tpu_torch.sample.grid import make_grid, save_image

__all__ = ["make_grid", "save_image"]
