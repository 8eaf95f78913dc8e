"""CelebA-style image-folder ingest (a copy of the JAX package's
``data/celeba.py``: same file order, same synthetic stand-in arrays).

Parity with the reference pipeline (celebA/EAD-GAN_celebA.py:194-206):
Resize(64) on the shorter side, CenterCrop(64), RandomHorizontalFlip,
normalize to [-1, 1].  Decoding uses PIL on the host.  The random flip
belongs to the *per-batch fetch* (the reference's torchvision transform
re-draws it on every ``__getitem__``), so the training CLI keeps the
archive unflipped here and applies a re-drawn mask per batch in
``train.engine.run_epochs``; the static ``flip`` option below survives
for one-shot consumers.  Synthesizes face-like color gradients when no
images exist.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

__all__ = ["load_image_folder"]

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def _list_images(root: str) -> List[str]:
    out = []
    for dirpath, dirs, files in os.walk(root):
        # os.walk yields subdirectories in filesystem (inode) order;
        # sort in place so the dataset ordering — and therefore the
        # seeded flip masks and max_images truncation — is reproducible
        # across hosts.
        dirs.sort()
        for f in sorted(files):
            if f.lower().endswith(_EXTS):
                out.append(os.path.join(dirpath, f))
    return out


def torchvision_resize_size(w: int, h: int, size: int) -> tuple:
    """(new_w, new_h) exactly as torchvision ``Resize(int)`` computes it
    on the PIL backend: shorter side -> ``size``, longer side ->
    ``int(size * long / short)`` (floor truncation, NOT round —
    torchvision/transforms/functional.py ``_compute_resized_output_size``)."""
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = size, int(size * long / short)
    return (new_short, new_long) if w <= h else (new_long, new_short)


def torchvision_center_crop_box(w: int, h: int, size: int) -> tuple:
    """(left, top, right, bottom) exactly as torchvision ``CenterCrop``:
    ``int(round((dim - size) / 2.0))`` — Python 3 round-half-to-even
    (banker's rounding: round(7.5) == 8 but round(6.5) == 6), the
    identical expression torchvision uses, so half-pixel margins stay
    bit-exact; do NOT "simplify" to floor+1."""
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return (left, top, left + size, top + size)


def _decode_resize_crop(path: str, size: int) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        im = im.resize(torchvision_resize_size(w, h, size), Image.BILINEAR)
        w, h = im.size
        im = im.crop(torchvision_center_crop_box(w, h, size))
        return np.asarray(im, np.uint8)


def _synthetic_faces(n=512, size=64, seed=0) -> np.ndarray:
    """Color-gradient ovals standing in for face crops."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    imgs = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        cx, cy = rng.uniform(size * 0.4, size * 0.6, 2)
        rx, ry = rng.uniform(size * 0.2, size * 0.35, 2)
        oval = np.exp(-(((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2))
        base = rng.uniform(0.2, 0.9, 3)
        grad = (ys / size)[..., None] * rng.uniform(-0.3, 0.3, 3)
        imgs[i] = np.clip(base * oval[..., None] + grad + 0.3, 0, 1)
    return (imgs * 255).astype(np.uint8)


def load_image_folder(
    root: str = "data",
    img_size: int = 64,
    max_images: Optional[int] = None,
    flip: bool = True,
    seed: int = 0,
    allow_synthetic: bool = True,
) -> np.ndarray:
    """Returns (N, 64, 64, 3) uint8.  ``flip=True`` applies one static
    flip draw per image at load time — use only for one-shot consumers;
    training passes ``flip=False`` and re-draws flips per batch via
    ``run_epochs(random_flip=True)`` like the reference transform.
    Normalization to [-1, 1] happens per batch in ``run_epochs``
    (scale=1/127.5, shift=-1)."""
    paths = _list_images(root) if os.path.isdir(root) else []
    if max_images:
        paths = paths[:max_images]
    if paths:
        imgs = np.stack([_decode_resize_crop(p, img_size) for p in paths])
    elif allow_synthetic:
        # EADGAN_SYNTH_N scales the stand-in dataset: at the default 512
        # images an epoch is only 4 batches of 128.
        imgs = _synthetic_faces(
            n=int(os.environ.get("EADGAN_SYNTH_N", "512")),
            size=img_size, seed=seed,
        )
    else:
        raise FileNotFoundError(root)
    rng = np.random.default_rng(seed)
    if flip:
        mask = rng.random(imgs.shape[0]) < 0.5
        imgs[mask] = imgs[mask, :, ::-1]
    return imgs  # uint8; normalize per batch (x / 127.5 - 1)
