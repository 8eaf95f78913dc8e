"""Per-channel multiplicative RGB colour transform algebra.

PyTorch counterpart of ``eadgan_tpu/transforms/color.py``.  The colored
dSprites pipelines add an RGB gain on top of the affine warp: a latent
colour code maps to per-channel gains ``gain = code * rgb_factor + 1``
and the consistency regularizer recovers the relative code from the
element-wise gain ratio.  The factor is 0.1 at the pxy-pretrain stage and
0.5 at the GAN stage (``train/config.py``).
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.transforms.affine import _safe_div

__all__ = [
    "color_code_to_gain",
    "gain_to_color_code",
    "regularize_color",
    "apply_color",
    "remove_color",
]


def color_code_to_gain(code: torch.Tensor, rgb_factor: float) -> torch.Tensor:
    """Latent colour code -> per-channel gain."""
    return code * rgb_factor + 1.0


def gain_to_color_code(gain: torch.Tensor, rgb_factor: float) -> torch.Tensor:
    """Per-channel gain -> latent colour code."""
    return (gain - 1.0) / rgb_factor


def regularize_color(
    real_code: torch.Tensor, trans_code: torch.Tensor, rgb_factor: float
) -> torch.Tensor:
    """Relative colour code from the element-wise gain ratio
    ``trans_gain / real_gain``; the ratio's denominator comes from
    predicted codes and is guarded like the affine recoveries'."""
    real_gain = color_code_to_gain(real_code, rgb_factor)
    trans_gain = color_code_to_gain(trans_code, rgb_factor)
    return gain_to_color_code(_safe_div(trans_gain, real_gain), rgb_factor)


def apply_color(img: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Multiply an NHWC batch by per-channel gains (B, C)."""
    return img * gain[:, None, None, :]


_GAIN_FLOOR = 1e-2


def remove_color(img: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Divide an NHWC batch by per-channel gains (B, C), the alignment
    step.  Gains come from predicted codes and can cross zero, which
    would feed exploding or NaN images to the models, so |gain| is
    floored at 1e-2 (sign kept, +1e-2 at 0): inactive in the normal gain
    range (~[0.4, 1.6]), it bounds the aligned image at 100x otherwise."""
    g = gain[:, None, None, :]
    floor = torch.full_like(g, _GAIN_FLOOR)
    g = torch.where(g.abs() < _GAIN_FLOOR, torch.where(g < 0, -floor, floor), g)
    return img / g
