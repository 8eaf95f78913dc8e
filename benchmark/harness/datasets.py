"""Stand-in datasets at the published row counts and the configuration's
own image size (``model.img_size``), made by whole-batch tensor
operations from the run's seed (on the card in a run), then handed to
the program as the numpy array its engine takes.

- ``faces``: CelebA's stand-in, (rows, size, size, 3) uint8: a colour
  oval on a vertical gradient per row, each row's centre, radii, colour
  and gradient drawn from the seed (the content of the port's own
  synthetic faces, drawn for all rows at once).  The draws are per row
  and in units of ``size``, drawn ``_CHUNK`` rows a call whatever the
  size, so one seed gives the same faces at every size;
- ``sprites``: the dSprites archive's factor grid, (3 shapes x 6 scales x
  40 orientations x 32 x 32 positions, 64, 64) uint8 in {0, 1}: squares,
  ellipses and wedges rasterised at every combination, in the archive's
  row order (shape slowest, y position fastest).  The grid is fixed, as
  the archive is, at the archive's 64x64; the seed orders the epochs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_CHUNK = 16384


def faces(rows: int, seed: int, device, size: int = 64) -> np.ndarray:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = np.empty((rows, size, size, 3), np.uint8)
    ys = torch.arange(size, dtype=torch.float32, device=device)
    yy, xx = ys[:, None], ys[None, :]
    for lo in range(0, rows, _CHUNK):
        n = min(_CHUNK, rows - lo)
        p = torch.rand(n, 10, generator=gen, device=device)
        cx, cy = (0.4 + 0.2 * p[:, 0:2]).mul(size).unbind(1)
        rx, ry = (0.2 + 0.15 * p[:, 2:4]).mul(size).unbind(1)
        base = 0.2 + 0.7 * p[:, 4:7]
        grad = 0.6 * p[:, 7:10] - 0.3
        oval = torch.exp(-(((xx[None] - cx[:, None, None]) / rx[:, None, None]) ** 2
                           + ((yy[None] - cy[:, None, None]) / ry[:, None, None]) ** 2))
        img = (base[:, None, None, :] * oval[..., None]
               + (yy / size)[None, :, :, None] * grad[:, None, None, :] + 0.3)
        out[lo:lo + n] = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    return out


SPRITE_GRID = (3, 6, 40, 32, 32)


SPRITE_SIZE = 64  # the archive's images


def sprites(rows: int, seed: int, device, size: int = SPRITE_SIZE) -> np.ndarray:
    """The factor grid's first ``rows`` rows (all of it at 737,280)."""
    del seed  # the archive is one fixed grid
    if size != SPRITE_SIZE:
        raise ValueError(f"the dSprites archive is {SPRITE_SIZE}x{SPRITE_SIZE}, {size} asked")
    total = math.prod(SPRITE_GRID)
    if rows > total:
        raise ValueError(f"the grid has {total} rows, {rows} asked")
    out = np.empty((rows, size, size), np.uint8)
    ys = torch.arange(size, dtype=torch.float32, device=device)
    yy, xx = ys[:, None][None], ys[None, :][None]
    for lo in range(0, rows, _CHUNK):
        i = torch.arange(lo, min(lo + _CHUNK, rows), device=device)
        py = i % 32
        px = (i // 32) % 32
        angle = (i // 1024) % 40
        scale = (i // 40960) % 6
        shape = i // 245760
        cx = (0.15 + 0.7 * px / 31.0) * (size - 1)
        cy = (0.15 + 0.7 * py / 31.0) * (size - 1)
        r = (4.0 + 8.0 * scale / 5.0)[:, None, None]
        a = (2 * math.pi * angle / 40.0)[:, None, None]
        dx, dy = xx - cx[:, None, None], yy - cy[:, None, None]
        u = torch.cos(a) * dx + torch.sin(a) * dy
        v = -torch.sin(a) * dx + torch.cos(a) * dy
        sq = (u.abs() < r) & (v.abs() < r)
        el = (u / r) ** 2 + (v / (0.6 * r)) ** 2 < 1.0
        wedge = (v > -r) & (u.abs() < (r - v) * 0.6)
        sh = shape[:, None, None]
        mask = torch.where(sh == 0, sq, torch.where(sh == 1, el, wedge))
        out[lo:lo + len(i)] = mask.to(torch.uint8).cpu().numpy()
    return out


MAKERS = {"faces": faces, "sprites": sprites}


def make(data_cfg: dict, seed: int, device, size: int) -> np.ndarray:
    """A configuration's stand-in dataset: its ``data``'s maker and rows,
    at ``size``, the configuration's ``model.img_size``."""
    return MAKERS[data_cfg["maker"]](data_cfg["rows"], seed, device, size)
