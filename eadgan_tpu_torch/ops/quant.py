"""CelebA generator inference with BatchNorm folded into the convolutions.

PyTorch counterpart of the unquantized half of ``eadgan_tpu/ops/quant.py``
(``fold_celeba_generator_bn`` and ``make_celeba_infer(quant="none")``).
Eval-mode BatchNorm folds into the ConvTranspose before it exactly:
``g * (conv(x) + b - mu) / sqrt(var + eps) + beta`` is a conv with weight
``w * s`` and bias ``(b - mu) * s + beta``, ``s = g / sqrt(var + eps)``
taken per output channel.  The folded forward runs five transposed
convolutions (torch's own, cuDNN on the card) in ``compute_dtype`` with
float32 biases, a ReLU after layers 1-3, and a float32 tanh, as the JAX
function does; it matches ``CelebaGenerator`` in eval mode.

The int8 path (``quantize_kernel_per_channel``, ``quant="int8"``) is not
ported here.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

__all__ = ["fold_celeba_generator_bn", "make_celeba_infer"]

# (stride, padding) of each ConvTranspose of CelebaGenerator (4x4 kernels)
_LAYER_GEOM = ((1, 0), (2, 1), (2, 1), (2, 1), (2, 1))
_BN_LAYERS = (1, 2, 3)  # the ConvTransposes followed by BatchNorm and ReLU
# their keys in CelebaGenerator's state_dict: conv_blocks.{conv}, BN at .{conv + 1}
_CONV_KEYS = (0, 1, 4, 7, 10)


def fold_celeba_generator_bn(state_dict: Dict[str, torch.Tensor], eps: float = 1e-5
                             ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Fold eval-mode BatchNorm into the ConvTranspose weights of a
    ``CelebaGenerator`` state_dict.  Returns five float32 ``(weight,
    bias)`` pairs, weights in ConvTranspose2d layout (in, out, kh, kw),
    with BatchNorms 0-2 folded into layers 1-3.  ``eps`` is the
    BatchNorm's (1e-5 for CelebA)."""
    layers = []
    for i, seq in enumerate(_CONV_KEYS):
        weight = state_dict[f"conv_blocks.{seq}.weight"].detach().float()
        bias = state_dict[f"conv_blocks.{seq}.bias"].detach().float()
        if i in _BN_LAYERS:
            bn = f"conv_blocks.{seq + 1}"
            scale = state_dict[f"{bn}.weight"].float() / torch.sqrt(
                state_dict[f"{bn}.running_var"].float() + eps
            )
            weight = weight * scale[None, :, None, None]  # over the out-channel dim
            bias = (bias - state_dict[f"{bn}.running_mean"].float()) * scale + state_dict[
                f"{bn}.bias"
            ].float()
        layers.append((weight.detach(), bias.detach()))
    return layers


def make_celeba_infer(state_dict: Dict[str, torch.Tensor], quant: str = "none",
                      compute_dtype=torch.bfloat16, eps: float = 1e-5,
                      device=None) -> Callable:
    """``fwd(z, labels, code) -> (B, 3, 64, 64)`` float32 images: the
    BN-folded eval-mode CelebA generator.  Each layer convolves its input
    and weight cast to ``compute_dtype``, adds the float32 bias to the
    float32 result, and (layers 1-3) takes a ReLU; the last output goes
    through a float32 tanh.  The weights live on ``device`` (the state's
    device when None).  Only ``quant="none"`` is ported."""
    if quant != "none":
        raise ValueError(f"quant={quant!r} is not ported: only 'none' (the folded forward)")
    folded = fold_celeba_generator_bn(state_dict, eps=eps)
    if device is not None:
        folded = [(w.to(device), b.to(device)) for w, b in folded]
    prepared = [(w.to(compute_dtype), b) for w, b in folded]

    @torch.no_grad()
    def fwd(z, labels, code):
        x = torch.cat([z, labels, code], dim=-1).float()[:, :, None, None]
        for i, (weight, bias) in enumerate(prepared):
            stride, pad = _LAYER_GEOM[i]
            y = F.conv_transpose2d(x.to(compute_dtype), weight, None, stride, pad)
            x = y.float() + bias[None, :, None, None]
            if i in _BN_LAYERS:
                x = torch.relu(x)
        return torch.tanh(x)

    return fwd
