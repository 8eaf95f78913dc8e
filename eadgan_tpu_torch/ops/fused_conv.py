"""Fused k4 s2 p1 convolution + bias + LeakyReLU over NHWC batches.

PyTorch counterpart of ``tools/fused_conv_probe.py::fused_conv_lrelu_pallas``
(and of its XLA yardstick ``xla_conv_lrelu``): the CelebA
discriminator's layer shape, torch ``Conv2d(k=4, s=2, p=1)`` + bias +
LeakyReLU(``slope``).  Interface as the JAX function's: ``x`` (B, H, H,
Cin) NHWC, ``w`` (4, 4, Cin, Cout) HWIO, ``b`` (Cout,); the result is
(B, H/2, H/2, Cout) NHWC in ``x``'s dtype.

:func:`fused_conv_lrelu` is the one entry point.  A CUDA ``x`` goes to
the hand-written kernel (``ops/fused_conv_cuda.py``, which launches it or
raises); a CPU ``x`` goes to the plain version below,
:func:`fused_conv_lrelu_plain`, which is also what the kernel is held
against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fused_conv_lrelu", "fused_conv_lrelu_plain", "mismatch"]


def fused_conv_lrelu_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, slope: float = 0.1
) -> torch.Tensor:
    """The plain PyTorch version.  Computes in float32, as both JAX
    versions do (``preferred_element_type=f32``): the convolution of the
    upcast tensors, the bias and the LeakyReLU in float32, then one
    rounding to ``x``'s dtype.  Returns a contiguous NHWC tensor."""
    x32 = x.float().permute(0, 3, 1, 2)  # NCHW view of the NHWC batch
    w32 = w.float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    out = F.conv2d(x32, w32, stride=2, padding=1).permute(0, 2, 3, 1)
    out = out + b.float()
    out = torch.where(out >= 0, out, out * slope)
    return out.to(x.dtype).contiguous()


def fused_conv_lrelu(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, slope: float = 0.1
) -> torch.Tensor:
    """Conv k4 s2 p1 + bias + LeakyReLU of an NHWC batch.

    A CUDA ``x`` runs the CUDA kernel (bf16 only; it raises on what it
    does not take, and never falls back); a CPU ``x`` runs the plain
    version.
    """
    if x.is_cuda:
        from eadgan_tpu_torch.ops.fused_conv_cuda import fused_conv_lrelu_cuda

        return fused_conv_lrelu_cuda(x, w, b, slope)
    return fused_conv_lrelu_plain(x, w, b, slope)


def mismatch(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """How far a bf16 result ``got`` lies from the plain version's ``ref``.

    ``rel`` is the largest difference over max(1, max |ref|), the JAX
    tool's measure (its bar: 2e-2).  ``elem`` is the largest ratio of an
    element's difference to 2^-6 |ref| + 1e-3 max(1, max |ref|): two bf16
    steps of that element, plus a floor where ref is near zero.  Both
    sides accumulate in float32 and round once, so a right result is at
    most one step off and ``elem`` stays below 1, while a bias left out or
    taken from the wrong channel puts it far above 1 even where the bias
    is too small to move ``rel``."""
    got, ref = got.float(), ref.float()
    diff = (got - ref).abs()
    scale = max(1.0, ref.abs().max().item())
    return {
        "max_abs_err": diff.max().item(),
        "rel": diff.max().item() / scale,
        "elem": (diff / (2.0**-6 * ref.abs() + 1e-3 * scale)).max().item(),
    }
