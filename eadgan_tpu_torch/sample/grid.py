"""Image-grid rendering with torchvision ``make_grid``/``save_image``
parity — the reference's primary observable artifact (SURVEY.md section
5; e.g. MNIST/EAD-GAN_rpqmnxy.py:276-330, dSprites/rp.py:293-353).

Inputs are NHWC float batches; grids get the same 2-pixel padding and
row-major layout as torchvision, and ``save_image(..., normalize=True)``
applies the same global min/max rescale before writing a PNG via PIL.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["make_grid", "save_image"]


def make_grid(imgs: np.ndarray, nrow: int = 8, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """Arrange (B, H, W, C) into a single (H', W', C) grid, torchvision
    layout: ``nrow`` images per row, ``padding`` pixels around each."""
    imgs = np.asarray(imgs)
    b, h, w, c = imgs.shape
    ncol = nrow
    nrows = (b + ncol - 1) // ncol
    grid_h = nrows * (h + padding) + padding
    grid_w = ncol * (w + padding) + padding
    grid = np.full((grid_h, grid_w, c), pad_value, imgs.dtype)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y : y + h, x : x + w] = imgs[i]
    return grid


def save_image(img: np.ndarray, path: str, nrow: int = 8, normalize: bool = True) -> None:
    """Write an image or batch to PNG.  A 4-D input is gridded first.
    ``normalize=True`` rescales by the global min/max (torchvision
    save_image parity)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 4:
        img = make_grid(img, nrow=nrow)
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
    img = np.clip(img, 0.0, 1.0)
    arr = (img * 255.0 + 0.5).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)
