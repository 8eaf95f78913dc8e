"""Representation extraction shared by every metric, on the card.

PyTorch counterpart of ``eadgan_tpu/eval/representation.py``.  Each
batch is aligned with the frozen pxy encoder (translation-only inverse
warp, ``padding_mode='zeros'`` as in every score script,
dSprites/score/BetVAE.py:182), encoded by the category/continuous
encoder, and returned as the 5-dim representation ``[argmax cat,
cont_0, cont_1, align_code_1, align_code_2]``.  Both models run in eval
mode under ``no_grad``: BatchNorm and the spectral-norm ``u`` stay as
they are.  On the card the warp is the hand-written kernel
(``ops/stn_cuda.py``); on the CPU its plain version.

The colored variant colorizes the raw grayscale images on the host with
uniform(0.5, 1) channel gains drawn from ``np.random.default_rng(seed)``,
draw for draw as the JAX package does (colored_dSprites/score/BetVAE.py:
207-224), and divides the aligned image by the predicted color before
encoding (:262-270).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.transforms import (
    color_code_to_gain,
    inverse_affine,
    pxy_align_matrix,
    remove_color,
)
from eadgan_tpu_torch.utils.device import resolve_device

__all__ = ["Representer"]


class Representer:
    """``(B, 64, 64)`` images in, ``(B, 5)`` float32 numpy
    representations out, ``batch_size`` images a device call.

    ``seconds`` accumulates host-clock time: ``prepare`` (the host-side
    cast and colorization) and ``device`` (copy to the device, the
    models and the warp, and the copy back); ``images`` counts the
    images represented."""

    def __init__(
        self,
        pxy_encoder: torch.nn.Module,
        cat_encoder: torch.nn.Module,
        colored: bool = False,
        align_rgb_factor: float = 0.1,
        batch_size: int = 500,
        seed: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.pxy = pxy_encoder.to(self.device).eval()
        self.cat = cat_encoder.to(self.device).eval()
        self.colored = colored
        self.align_rgb_factor = align_rgb_factor
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)
        self.seconds = {"prepare": 0.0, "device": 0.0}
        self.images = 0

    @torch.no_grad()
    def represent(self, img: torch.Tensor) -> torch.Tensor:
        """One batch: a contiguous NHWC float32 tensor on the device in,
        the (B, 5) representation on the device out."""
        align_code = self.pxy(img.permute(0, 3, 1, 2))
        matrix = pxy_align_matrix(align_code[:, :3])
        align_img = warp_affine(img, inverse_affine(matrix), padding_mode="zeros")
        if self.colored:
            gain = color_code_to_gain(align_code[:, 3:], self.align_rgb_factor)
            align_img = remove_color(align_img, gain)
        cat, cont = self.cat(align_img.permute(0, 3, 1, 2))
        cat_id = torch.argmax(cat, dim=-1).to(torch.float32)[:, None]
        return torch.cat([cat_id, cont[:, 0:2], align_code[:, 1:3]], dim=-1)

    def _prepare(self, imgs: np.ndarray) -> np.ndarray:
        """uint8 (B, 64, 64) -> float32 NHWC, colorized if colored.
        Already-3-channel input passes through unchanged (pre-colorized
        by a caller replicating the reference's exact color draws)."""
        if imgs.ndim == 4 and imgs.shape[-1] == 3:
            return np.ascontiguousarray(imgs, np.float32)
        x = imgs.astype(np.float32)[..., None]
        if self.colored:
            color = self._rng.uniform(0.5, 1.0, (x.shape[0], 1, 1, 3)).astype(np.float32)
            x = np.tile(x, (1, 1, 1, 3)) * color
        return x

    def __call__(self, imgs: np.ndarray) -> np.ndarray:
        """(B, 64, 64) uint8/float -> (B, 5) float32 representation."""
        out = []
        for start in range(0, imgs.shape[0], self.batch_size):
            t0 = time.perf_counter()
            x = self._prepare(imgs[start : start + self.batch_size])
            t1 = time.perf_counter()
            rep = self.represent(torch.from_numpy(x).to(self.device))
            out.append(rep.cpu().numpy())
            self.seconds["prepare"] += t1 - t0
            self.seconds["device"] += time.perf_counter() - t1
            self.images += x.shape[0]
        return np.concatenate(out, axis=0)
