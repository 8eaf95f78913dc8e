"""CelebA generator inference with BatchNorm folded into the convolutions,
in bf16 or with int8 mid layers.

PyTorch counterpart of ``eadgan_tpu/ops/quant.py``.  Eval-mode
BatchNorm folds into the ConvTranspose before it exactly:
``g * (conv(x) + b - mu) / sqrt(var + eps) + beta`` is a conv with weight
``w * s`` and bias ``(b - mu) * s + beta``, ``s = g / sqrt(var + eps)``
taken per output channel.

``make_celeba_infer(quant="none")`` runs the five folded transposed
convolutions (torch's own, cuDNN on the card) in ``compute_dtype`` with
float32 biases, a ReLU after layers 1-3, and a float32 tanh, as the JAX
function does; it matches ``CelebaGenerator`` in eval mode.

``quant="int8"`` (the default, as in the JAX package) quantizes the three
k4 s2 p1 mid layers, which carry ~99% of the forward's multiply-adds:

- weights: symmetric per output channel, ``scale = max(amax, 1e-12) /
  127`` over (in, kh, kw), ``q = clamp(round(w / scale), -127, 127)``
  (:func:`quantize_kernel_per_channel`);
- activations: symmetric per tensor, from the tensor's own abs-max, in
  the same form (:func:`quantize_activation`; on the card the
  ``quantize_int8`` kernel, which also writes the int8 tensor NHWC);
- the transposed conv accumulates int8 products in int32, then
  ``acc * (a_scale * w_scale) + bias`` and ReLU in float32
  (:func:`int8_convt_relu`; on the card the ``int8_convt`` kernel, which
  writes NHWC float32, or bf16 rounded from it).

Layers 0 and 4 stay in ``compute_dtype``; the output is a float32 tanh.
The forward chains the int8 layers: layers 1 and 2 hand the abs-max of
their float32 outputs to the next quantization (on the card the
``int8_convt`` epilogue computes it, so the quantization reads its input
once; on the CPU it is ``x.abs().amax()``, as the quantization would take
it), and layer 3 writes ``compute_dtype`` directly, which layer 4 reads
without a cast.  The result is the unchained composition's, bit for bit.
Each op dispatches on its input's device: a CUDA tensor goes to the
kernel (``ops/quant_cuda.py``, which launches it or raises), a CPU
tensor to the plain version here, which is also what the kernel is held
against.  Nothing on the int8 path waits for the card: the activation
scale stays on the device, where the convolution's epilogue reads it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "fold_celeba_generator_bn",
    "quantize_kernel_per_channel",
    "repack_convt_weight",
    "quantize_activation",
    "quantize_activation_plain",
    "output_amax_plain",
    "convt_int8_plain",
    "int8_convt_relu",
    "int8_convt_relu_plain",
    "Int8ConvT",
    "make_celeba_infer",
    "QUANT_MODES",
]

QUANT_MODES = ("int8", "none")
# (stride, padding) of each ConvTranspose of CelebaGenerator (4x4 kernels)
_LAYER_GEOM = ((1, 0), (2, 1), (2, 1), (2, 1), (2, 1))
_BN_LAYERS = (1, 2, 3)  # the ConvTransposes followed by BatchNorm and ReLU; int8 under quant="int8"
# their keys in CelebaGenerator's state_dict: conv_blocks.{conv}, BN at .{conv + 1}
_CONV_KEYS = (0, 1, 4, 7, 10)
# k4 s2 p1 transposed conv by output parity: output row 2m + p takes kernel
# rows KY[p][t] from input rows m + DY[p][t] (t = 0, 1); columns alike
KY = ((1, 3), (0, 2))
DY = ((0, -1), (1, 0))


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


def quantize_kernel_per_channel(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of a ConvTranspose2d weight (in,
    out, kh, kw): ``(q, scale)`` with ``weight ~= q * scale`` and scale
    shaped (out,), float32."""
    amax = weight.abs().amax(dim=(0, 2, 3))
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(weight / scale[None, :, None, None]), -127, 127)
    return q.to(torch.int8), scale


def repack_convt_weight(q: torch.Tensor) -> torch.Tensor:
    """The ``int8_convt`` kernel's weight layout: (in, out, 4, 4) ->
    (phase, out, tap, in), contiguous, with phase = 2 * py + px the
    output's parity and tap = 2 * ty + tx, holding kernel entry
    ``(KY[py][ty], KY[px][tx])``: for each phase a (Cout, 4 * Cin) matrix
    whose reduction axis is contiguous."""
    if q.dim() != 4 or q.shape[2:] != (4, 4):
        raise ValueError(f"want a (in, out, 4, 4) weight, got {tuple(q.shape)}")
    phases = []
    for py in range(2):
        for px in range(2):
            taps = [q[:, :, KY[py][ty], KY[px][tx]] for ty in range(2) for tx in range(2)]
            phases.append(torch.stack(taps, dim=1).permute(2, 1, 0))  # (out, tap, in)
    return torch.stack(phases).contiguous()


def quantize_activation_plain(x: torch.Tensor, nhwc: bool, amax: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-tensor int8 of a float32 activation, NCHW
    (``nhwc=False``) or NHWC: ``(q, scale)`` with ``q`` int8 NHWC,
    contiguous, and ``scale = max(max |x|, 1e-12) / 127`` a 0-d float32
    tensor; ``q = clamp(round(x / scale), -127, 127)``, rounding half to
    even, as ``eadgan_tpu/ops/quant.py::_quantize_activation``.  ``amax``,
    a 0-d float32 tensor equal to ``max |x|`` (:func:`output_amax_plain`),
    is taken in place of computing it."""
    if not nhwc:
        x = x.permute(0, 2, 3, 1)
    if amax is None:
        amax = x.abs().amax()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.contiguous(), scale


def output_amax_plain(out: torch.Tensor) -> torch.Tensor:
    """``max |out|`` as a 0-d float32 tensor: the abs-max that the
    quantization of ``out`` takes (what the ``int8_convt`` kernel's
    epilogue computes on the card)."""
    return out.abs().amax().float()


def quantize_activation(x: torch.Tensor, nhwc: bool, amax: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize_activation_plain` on a CPU tensor; the
    ``quantize_int8`` kernel on a CUDA one, where ``amax`` is the 0-d
    view that :func:`int8_convt_relu` returns."""
    if x.is_cuda:
        from eadgan_tpu_torch.ops import quant_cuda

        bits = None if amax is None else amax.view(torch.int32)
        return quant_cuda.quantize_int8_cuda(x, nhwc, bits)
    return quantize_activation_plain(x, nhwc, amax)


def convt_int8_plain(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int) -> torch.Tensor:
    """The int8 transposed conv with int32 sums: ``xq`` int8 NHWC, ``wq``
    int8 (in, out, kh, kw); returns int32 NHWC.  Computed in float64,
    which holds every sum exactly (at most 127^2 * 4 * Cin < 2^53)."""
    y = F.conv_transpose2d(xq.permute(0, 3, 1, 2).double(), wq.double(), None, stride, pad)
    return y.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def int8_convt_relu_plain(xq: torch.Tensor, a_scale: torch.Tensor, wq: torch.Tensor,
                          w_scale: torch.Tensor, bias: torch.Tensor,
                          out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The ``int8_convt`` kernel's function: the k4 s2 p1 int8 transposed
    conv of NHWC ``xq``, then ``acc * (a_scale * w_scale) + bias`` and
    ReLU in float32; NHWC out, float32 rounded to ``out_dtype``."""
    acc = convt_int8_plain(xq, wq, 2, 1)
    return torch.relu(acc.float() * (a_scale * w_scale) + bias).to(out_dtype)


@dataclasses.dataclass
class Int8ConvT:
    """One quantized k4 s2 p1 layer: int8 weight (in, out, 4, 4), its
    kernel repack (:func:`repack_convt_weight`), per-channel scales and
    the folded float32 bias."""

    wq: torch.Tensor
    wp: torch.Tensor
    w_scale: torch.Tensor
    bias: torch.Tensor

    @classmethod
    def from_folded(cls, weight: torch.Tensor, bias: torch.Tensor) -> "Int8ConvT":
        wq, w_scale = quantize_kernel_per_channel(weight)
        return cls(wq, repack_convt_weight(wq), w_scale, bias)


def int8_convt_relu(xq: torch.Tensor, a_scale: torch.Tensor, layer: Int8ConvT,
                    out_dtype: torch.dtype = torch.float32, with_amax: bool = False):
    """:func:`int8_convt_relu_plain` on CPU tensors; the ``int8_convt``
    kernel on CUDA ones.  With ``with_amax``, returns ``(out, amax)``,
    ``amax`` the 0-d float32 ``max |out|`` (on the card a view of the word
    the kernel's epilogue wrote) for :func:`quantize_activation`."""
    if xq.is_cuda:
        from eadgan_tpu_torch.ops import quant_cuda

        bits = torch.empty((), dtype=torch.int32, device=xq.device) if with_amax else None
        out = quant_cuda.int8_convt_cuda(xq, layer.wp, a_scale, layer.w_scale, layer.bias,
                                         out_dtype, bits)
        return (out, bits.view(torch.float32)) if with_amax else out
    out = int8_convt_relu_plain(xq, a_scale, layer.wq, layer.w_scale, layer.bias, out_dtype)
    return (out, output_amax_plain(out)) if with_amax else out


def make_celeba_infer(state_dict: Dict[str, torch.Tensor], quant: str = "int8",
                      compute_dtype=torch.bfloat16, eps: float = 1e-5,
                      device=None) -> Callable:
    """``fwd(z, labels, code) -> (B, 3, 64, 64)`` float32 images: the
    BN-folded eval-mode CelebA generator.  Each float layer convolves its
    input and weight cast to ``compute_dtype``, adds the float32 bias to
    the float32 result, and (layers 1-3) takes a ReLU; under
    ``quant="int8"`` layers 1-3 are the int8 ones (module docstring).
    The last output goes through a float32 tanh.  The weights live on
    ``device`` (the state's device when None)."""
    if quant not in QUANT_MODES:
        raise ValueError(f"unknown quant mode {quant!r}: one of {QUANT_MODES}")
    folded = fold_celeba_generator_bn(state_dict, eps=eps)
    if device is not None:
        folded = [(w.to(device), b.to(device)) for w, b in folded]
    prepared = [
        Int8ConvT.from_folded(w, b) if quant == "int8" and i in _BN_LAYERS else (w.to(compute_dtype), b)
        for i, (w, b) in enumerate(folded)
    ]

    @torch.no_grad()
    def fwd(z, labels, code):
        x = torch.cat([z, labels, code], dim=-1).float()[:, :, None, None]
        nhwc = False  # x's layout: the int8 layers take and give NHWC
        amax = None  # max |x|, where the int8 layer that wrote x gave it
        for i, layer in enumerate(prepared):
            if isinstance(layer, Int8ConvT):
                xq, a_scale = quantize_activation(x, nhwc, amax)
                if i == _BN_LAYERS[-1]:  # the last int8 layer writes what layer 4 reads
                    x, amax = int8_convt_relu(xq, a_scale, layer, out_dtype=compute_dtype), None
                else:
                    x, amax = int8_convt_relu(xq, a_scale, layer, with_amax=True)
                nhwc = True  # ReLU fused
                continue
            weight, bias = layer
            stride, pad = _LAYER_GEOM[i]
            if nhwc:
                x, nhwc = x.permute(0, 3, 1, 2), False  # a channels-last view
            y = F.conv_transpose2d(x.to(compute_dtype), weight, None, stride, pad)
            x = y.float() + bias[None, :, None, None]
            if i in _BN_LAYERS:
                x = torch.relu(x)
        return torch.tanh(x)

    return fwd
