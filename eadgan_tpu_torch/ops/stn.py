"""Spatial transformer: affine grid + bilinear sampling over NHWC batches.

PyTorch counterpart of ``eadgan_tpu/ops/stn.py``.  Semantics are torch's
``F.affine_grid`` + ``F.grid_sample`` with ``align_corners=False``:
sampling at pixel centres, ``'border'`` padding clamps the coordinates,
``'zeros'`` padding drops out-of-range taps.  Layout is NHWC, the JAX
package's layout, so the warp reads the channels of a pixel together.

:func:`warp_affine` is the one entry point.  A CUDA tensor goes to the
hand-written kernel (``ops/stn_cuda.py``, which launches it or raises);
a CPU tensor goes to the plain version below, :func:`warp_affine_plain`,
which is also what the kernel is held against.
"""

from __future__ import annotations

import torch

__all__ = ["affine_grid", "grid_sample", "warp_affine", "warp_affine_plain"]

PADDING_MODES = ("border", "zeros")


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Source sampling coordinates for a batch of 2x3 affine maps.

    ``theta``: (N, 2, 3).  Returns (N, H*W, 2) normalized (x, y) source
    coordinates.  The product with the base grid is written out
    elementwise: exact float32 on every device.
    """
    dev = theta.device
    theta = theta.to(torch.float32)
    xs = (2.0 * torch.arange(width, dtype=torch.float32, device=dev) + 1.0) / width - 1.0
    ys = (2.0 * torch.arange(height, dtype=torch.float32, device=dev) + 1.0) / height - 1.0
    gx = xs[None, :].expand(height, width).reshape(1, -1)
    gy = ys[:, None].expand(height, width).reshape(1, -1)
    t = theta[:, :, :, None]  # (N, 2, 3, 1)
    x = t[:, 0, 0] * gx + t[:, 0, 1] * gy + t[:, 0, 2]
    y = t[:, 1, 0] * gx + t[:, 1, 1] * gy + t[:, 1, 2]
    return torch.stack([x, y], dim=-1)


def grid_sample(img: torch.Tensor, coords: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Bilinear sampling of an NHWC batch at normalized coordinates.

    ``img``: (N, H, W, C); ``coords``: (N, P, 2) normalized (x, y),
    unnormalized as ``ix = ((x + 1) * W - 1) / 2``.  Returns (N, P, C) in
    float32.
    """
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    n, h, w, c = img.shape
    img = img.to(torch.float32)
    x = (coords[..., 0] + 1.0) * (w * 0.5) - 0.5
    y = (coords[..., 1] + 1.0) * (h * 0.5) - 0.5
    if padding_mode == "border":
        x = x.clamp(0.0, w - 1.0)
        y = y.clamp(0.0, h - 1.0)

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = x0i + 1
    y1i = y0i + 1
    img_flat = img.reshape(n, h * w, c)

    def tap(yi, xi, weight):
        if padding_mode == "zeros":
            valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            weight = weight * valid.to(weight.dtype)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)  # (N, P)
        vals = torch.gather(img_flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * weight[..., None]

    return (
        tap(y0i, x0i, (1.0 - wy) * (1.0 - wx))
        + tap(y0i, x1i, (1.0 - wy) * wx)
        + tap(y1i, x0i, wy * (1.0 - wx))
        + tap(y1i, x1i, wy * wx)
    )


def _theta(matrix: torch.Tensor) -> torch.Tensor:
    """Top two rows of (N, 3, 3) matrices; (N, 2, 3) passes through."""
    return matrix[:, :2, :] if matrix.shape[-2] == 3 else matrix


def warp_affine_plain(
    img: torch.Tensor, matrix: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """The plain PyTorch warp of an NHWC batch by (N, 3, 3) or (N, 2, 3)
    affine matrices.  The math runs in float32; the output keeps the
    input's dtype."""
    n, h, w, c = img.shape
    coords = affine_grid(_theta(matrix), h, w)
    out = grid_sample(img, coords, padding_mode=padding_mode)
    return out.reshape(n, h, w, c).to(img.dtype)


def warp_affine(
    img: torch.Tensor, matrix: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Warp an NHWC batch by 3x3 (or 2x3) affine matrices.

    A CUDA ``img`` runs the CUDA kernel (which raises on what it does not
    take, and never falls back); a CPU ``img`` runs the plain version.
    """
    if img.is_cuda:
        from eadgan_tpu_torch.ops.stn_cuda import warp_affine_cuda

        return warp_affine_cuda(img, matrix, padding_mode)
    return warp_affine_plain(img, matrix, padding_mode)
