"""MNIST ingest: idx archives resized to 32x32 and normalized to [-1, 1].

A copy of the JAX package's ``data/mnist.py`` (numpy only), equal to it
bit for bit: the reference's torchvision pipeline (bilinear Resize(32),
ToTensor, Normalize(0.5, 0.5)) on the standard idx files, read with or
without ``.gz``, or a synthetic stand-in of digit-like strokes when the
files are absent (``EADGAN_SYNTH_N`` images, 2,048 by default: 16
batches at 128).  The port never downloads: the archives are put in the
data directory by hand, or the stand-in is used.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

__all__ = ["load_mnist", "mnist_archive_present", "synthetic_mnist", "normalize_mnist"]

_IMAGES = "train-images-idx3-ubyte"
_LABELS = "train-labels-idx1-ubyte"


def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _have(path) -> bool:
    return os.path.exists(path) or os.path.exists(path + ".gz")


def _read_idx_images(path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx image magic {magic}")
        return np.frombuffer(f.read(n * rows * cols), np.uint8).reshape(n, rows, cols)


def _read_idx_labels(path) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx label magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int32)


def _resize_bilinear(imgs: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize, align_corners=False (PIL/torchvision's convention
    for the 28 -> 32 upsample), vectorized."""
    n, h, w = imgs.shape
    ys = (np.arange(size) + 0.5) * h / size - 0.5
    xs = (np.arange(size) + 0.5) * w / size - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int32)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int32)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[None, :, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, None, :]
    f = imgs.astype(np.float32)
    fy0, fy1 = f[:, y0], f[:, y1]
    top = fy0[:, :, x0] * (1 - wx) + fy0[:, :, x1] * wx
    bot = fy1[:, :, x0] * (1 - wx) + fy1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def synthetic_mnist(n: int = 2048, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Digit-like strokes, (n, 28, 28) uint8 and (n,) int32 labels: a blob
    and a ring placed by the class."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.zeros((n, 28, 28), np.float32)
    ys, xs = np.mgrid[0:28, 0:28].astype(np.float32)
    for i, lab in enumerate(labels):
        ang = 2 * np.pi * lab / 10
        cx, cy = 14 + 6 * np.cos(ang), 14 + 6 * np.sin(ang)
        blob = np.exp(-(((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * 9.0)))
        ring = np.exp(-((np.hypot(xs - 14, ys - 14) - (4 + lab * 0.7)) ** 2) / 4.0)
        imgs[i] = np.clip(blob + 0.7 * ring + 0.05 * rng.normal(size=(28, 28)), 0, 1) * 255
    return imgs.astype(np.uint8), labels


def normalize_mnist(raw: np.ndarray, img_size: int = 32) -> np.ndarray:
    """(N, 28, 28) uint8 -> (N, S, S, 1) float32 in [-1, 1], C-contiguous."""
    resized = _resize_bilinear(raw, img_size) / 255.0
    # C order: the bilinear gathers leave another memory order, which the
    # engine's batch gathers and the card's kernels would inherit
    imgs = np.ascontiguousarray(((resized - 0.5) / 0.5).astype(np.float32))
    return imgs.reshape(imgs.shape + (1,))


def mnist_archive_present(data_dir: str) -> bool:
    """Both training idx files (``.gz`` or not) are in ``data_dir``."""
    return _have(os.path.join(data_dir, _IMAGES)) and _have(os.path.join(data_dir, _LABELS))


def load_mnist(
    data_dir: str = "data/mnist", img_size: int = 32, allow_synthetic: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """(images (N, S, S, 1) float32 in [-1, 1], labels (N,) int32) from the
    idx archives in ``data_dir``, else from the synthetic stand-in
    (``EADGAN_SYNTH_N`` images)."""
    img_path = os.path.join(data_dir, _IMAGES)
    if mnist_archive_present(data_dir):
        raw = _read_idx_images(img_path)
        labels = _read_idx_labels(os.path.join(data_dir, _LABELS))
    elif allow_synthetic:
        raw, labels = synthetic_mnist(n=int(os.environ.get("EADGAN_SYNTH_N", "2048")))
    else:
        raise FileNotFoundError(img_path)
    return normalize_mnist(raw, img_size), labels
