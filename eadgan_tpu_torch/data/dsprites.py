"""dSprites ingest: the standard npz archive, with a synthetic stand-in.

A copy of the JAX package's ``data/dsprites.py`` (numpy only): the same
archive reader and the same synthetic factor grid, equal bit for bit.
The trainers feed the raw binary ``imgs`` array, (N, 64, 64) uint8 in
{0, 1}; the engine adds the channel axis.  The stand-in rasterizes a
small grid of shape x scale x rotation x x-position x y-position
(``EADGAN_SYNTH_POS`` positions a side, 6 by default: 2,160 images) so
the trainers run without the archive; it does not replace it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

__all__ = ["DspritesData", "load_dsprites", "synthetic_dsprites", "DSPRITES_FILENAME"]

DSPRITES_FILENAME = "dsprites_ndarray_co1sh3sc6or40x32y32_64x64.npz"


@dataclasses.dataclass
class DspritesData:
    imgs: np.ndarray  # (N, 64, 64) uint8 in {0, 1}
    latents_values: Optional[np.ndarray] = None  # (N, 6)
    latents_sizes: Optional[np.ndarray] = None  # (6,)
    synthetic: bool = False


def _render_sprite(shape_id, scale, angle, px, py, size=64):
    """Rasterize a square, ellipse or wedge with dSprites' factor
    semantics."""
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32)
    cx, cy = px * (size - 1), py * (size - 1)
    r = 4.0 + scale * 8.0
    dx, dy = xs - cx, ys - cy
    c, s = np.cos(angle), np.sin(angle)
    u = c * dx + s * dy
    v = -s * dx + c * dy
    if shape_id == 0:  # square
        mask = (np.abs(u) < r) & (np.abs(v) < r)
    elif shape_id == 1:  # ellipse
        mask = (u / r) ** 2 + (v / (0.6 * r)) ** 2 < 1.0
    else:  # triangle-ish wedge
        mask = (v > -r) & (np.abs(u) < (r - v) * 0.6)
    return mask.astype(np.uint8)


def synthetic_dsprites(n_shapes=3, n_scales=4, n_angles=5, n_pos=6) -> DspritesData:
    """The factor-grid stand-in (colour factor a singleton, as in the real
    archive)."""
    sizes = np.array([1, n_shapes, n_scales, n_angles, n_pos, n_pos])
    total = int(np.prod(sizes))
    imgs = np.zeros((total, 64, 64), np.uint8)
    values = np.zeros((total, 6), np.float32)
    i = 0
    for sh in range(n_shapes):
        for sc in range(n_scales):
            for an in range(n_angles):
                for x in range(n_pos):
                    for y in range(n_pos):
                        scale = sc / max(n_scales - 1, 1)
                        angle = 2 * np.pi * an / n_angles
                        px = 0.25 + 0.5 * x / max(n_pos - 1, 1)
                        py = 0.25 + 0.5 * y / max(n_pos - 1, 1)
                        imgs[i] = _render_sprite(sh, scale, angle, px, py)
                        values[i] = (1.0, sh, scale, angle, px, py)
                        i += 1
    return DspritesData(imgs=imgs, latents_values=values, latents_sizes=sizes, synthetic=True)


def load_dsprites(data_dir: str = ".", allow_synthetic: bool = True) -> DspritesData:
    """The archive ``data_dir/dsprites_ndarray_...npz`` if present, else
    the synthetic stand-in with ``EADGAN_SYNTH_POS`` positions a side."""
    path = os.path.join(data_dir, DSPRITES_FILENAME)
    if os.path.exists(path):
        z = np.load(path, encoding="latin1", allow_pickle=True)
        metadata = z["metadata"][()] if "metadata" in z else {}
        return DspritesData(
            imgs=z["imgs"],
            latents_values=z.get("latents_values"),
            latents_sizes=np.asarray(metadata.get("latents_sizes")) if metadata else None,
        )
    if not allow_synthetic:
        raise FileNotFoundError(path)
    return synthetic_dsprites(n_pos=int(os.environ.get("EADGAN_SYNTH_POS", "6")))
