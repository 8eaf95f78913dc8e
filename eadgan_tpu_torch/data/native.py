"""ctypes bindings of the host batcher, ``csrc/batcher.cpp``.

Three fused gathers from a uint8 dataset held in host memory, each a pass
over the batch's rows on ``n_threads`` threads, writing float32:

* :func:`gather_normalize`: ``src[idx] * scale + shift``;
* :func:`gather_normalize_flip`: the same, rows whose mask is set mirrored
  along the width;
* :func:`gather_colorize`: gray rows times per-image RGB gains.

The signatures and output shapes are those of the JAX package's
bindings; 2-D rows (N, H, W) gain a trailing channel axis, (B, H, W, 1).
Each takes ``out=``, a C-contiguous float32 array of the output's shape
(a pinned staging buffer, say), and writes the batch there.  The library
is built with g++ at first use (``ops/_build.py::load_host_library``); a
failed build raises.  The source must be a C-contiguous uint8 array: the
caller makes it so once, before its loop.

Beside each binding is its plain numpy version (``*_plain``), one float32
multiply then one add as numpy computes them, which the bindings equal
bit for bit; the tests and ``chip_smoke.py`` hold them against it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from eadgan_tpu_torch.ops import _build

__all__ = [
    "gather_normalize",
    "gather_normalize_flip",
    "gather_colorize",
    "gather_normalize_plain",
    "gather_normalize_flip_plain",
    "gather_colorize_plain",
    "output_shape",
]


def output_shape(src: np.ndarray, n: int) -> tuple:
    """The shape of a batch of ``n`` rows of ``src``: (n, H, W, 1) for 2-D
    (H, W) rows, which gain a channel axis, else (n,) + the row's shape."""
    row = src.shape[1:]
    return (n,) + row + ((1,) if len(row) == 2 else ())


def _checked(src: np.ndarray, idx, out: Optional[np.ndarray], shape) -> tuple:
    """(idx as int64, the output array) after checking what the C code
    cannot: the source's type and layout, the indices' range and the
    output's type, shape and layout."""
    if src.dtype != np.uint8 or not src.flags.c_contiguous:
        raise ValueError(
            f"the batcher reads C-contiguous uint8 rows, got {src.dtype} "
            f"(C-contiguous: {src.flags.c_contiguous}); np.ascontiguousarray it once"
        )
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.ndim != 1:
        raise ValueError(f"indices of shape {idx.shape}: expected one axis")
    if idx.size and (idx.min() < 0 or idx.max() >= src.shape[0]):
        raise IndexError(f"row indices outside [0, {src.shape[0]})")
    if out is None:
        out = np.empty(shape, np.float32)
    elif out.dtype != np.float32 or out.shape != tuple(shape) or not out.flags.c_contiguous:
        raise ValueError(
            f"out must be a C-contiguous float32 array of shape {tuple(shape)}, got "
            f"{out.dtype} {out.shape}"
        )
    return idx, out


def gather_normalize(src_u8: np.ndarray, idx, scale: float = 1.0, shift: float = 0.0,
                     n_threads: int = 8, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``out[r] = src[idx[r]] * scale + shift`` as float32."""
    shape = output_shape(src_u8, len(idx))
    idx, out = _checked(src_u8, idx, out, shape)
    _build.load_host_library().eadgan_gather_norm_u8(
        src_u8.ctypes.data, idx.ctypes.data, len(idx), int(np.prod(src_u8.shape[1:])),
        scale, shift, out.ctypes.data, n_threads,
    )
    return out


def gather_normalize_flip(src_u8: np.ndarray, idx, flip, scale: float = 1.0,
                          shift: float = 0.0, n_threads: int = 8,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`gather_normalize` with the rows where ``flip`` (a (B,) bool or
    uint8 mask) is set mirrored along the width axis."""
    shape = output_shape(src_u8, len(idx))
    idx, out = _checked(src_u8, idx, out, shape)
    if len(shape) != 4:
        raise ValueError(f"a flip mirrors (H, W) or (H, W, C) rows, not rows of {src_u8.shape[1:]}")
    flip = np.ascontiguousarray(flip, np.uint8)
    if flip.shape != idx.shape:
        raise ValueError(f"a flip mask of shape {flip.shape} for {len(idx)} rows")
    h, w, c = shape[1:]
    _build.load_host_library().eadgan_gather_norm_flip_u8(
        src_u8.ctypes.data, idx.ctypes.data, len(idx), h, w, c, scale, shift,
        flip.ctypes.data, out.ctypes.data, n_threads,
    )
    return out


def gather_colorize(src_u8: np.ndarray, idx, gains, scale: float = 1.0, shift: float = 0.0,
                    n_threads: int = 8, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Gray rows (N, H, W) -> (B, H, W, 3) float32, each image's
    ``x * scale + shift`` times its (3,) RGB ``gains``."""
    if src_u8.ndim != 3:
        raise ValueError(f"colorize takes gray (N, H, W) rows, got {src_u8.shape}")
    idx, out = _checked(src_u8, idx, out, (len(idx),) + src_u8.shape[1:] + (3,))
    gains = np.ascontiguousarray(gains, np.float32)
    if gains.shape != (len(idx), 3):
        raise ValueError(f"gains of shape {gains.shape} for {len(idx)} rows")
    _build.load_host_library().eadgan_gather_colorize_u8(
        src_u8.ctypes.data, idx.ctypes.data, len(idx), src_u8.shape[1] * src_u8.shape[2],
        gains.ctypes.data, scale, shift, out.ctypes.data, n_threads,
    )
    return out


def gather_normalize_plain(src: np.ndarray, idx, scale: float = 1.0, shift: float = 0.0,
                           out: Optional[np.ndarray] = None) -> np.ndarray:
    """:func:`gather_normalize` in numpy, for any source type (the per-step
    engine's gather of MNIST's float32 images)."""
    value = src[np.asarray(idx)].astype(np.float32) * scale + shift
    # a reshape, not ``value[..., None]``: numpy gives a new axis stride 0,
    # which a copy to the card keeps, and cuDNN then picks other algorithms
    value = value.reshape(output_shape(src, len(value)))
    if out is None:
        return value
    out[...] = value
    return out


def gather_normalize_flip_plain(src: np.ndarray, idx, flip, scale: float = 1.0,
                                shift: float = 0.0) -> np.ndarray:
    """:func:`gather_normalize_flip` in numpy."""
    value = src[np.asarray(idx)].astype(np.float32) * scale + shift
    mask = np.asarray(flip).astype(bool)
    value[mask] = value[mask, :, ::-1]
    return value.reshape(output_shape(src, len(value)))


def gather_colorize_plain(src: np.ndarray, idx, gains, scale: float = 1.0,
                          shift: float = 0.0) -> np.ndarray:
    """:func:`gather_colorize` in numpy."""
    base = src[np.asarray(idx)].astype(np.float32) * scale + shift
    return base[..., None] * np.asarray(gains, np.float32)[:, None, None, :]
