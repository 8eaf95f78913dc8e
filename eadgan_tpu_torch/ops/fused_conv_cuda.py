"""CUDA wrapper of the fused k4 s2 p1 conv + bias + LeakyReLU
(``csrc/fused_conv_lrelu.cu``).

Replaces ``tools/fused_conv_probe.py::fused_conv_lrelu_pallas``.  The
wrapper checks what the kernel takes (contiguous bf16 CUDA tensors on one
card: ``x`` (B, H, H, Cin) with H even, ``w`` (4, 4, Cin, Cout), ``b``
(Cout,), Cin and Cout multiples of 8, 16-byte aligned) and raises on
anything else; it never falls back to the plain version.  It allocates
the output, launches on PyTorch's current stream and raises if the
launch was refused.

The JAX kernel has no VJP, so this op is forward-only: an input that
requires grad raises rather than being silently detached.

``launch_count`` counts kernel launches, so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.ops import _build

__all__ = ["fused_conv_lrelu_cuda", "launch_count", "reset_launch_count"]

launch_count = 0


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("x", x), ("w", w), ("b", b)):
        if not t.is_cuda:
            raise ValueError(f"fused_conv_lrelu_cuda needs CUDA tensors, {name} is on {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"fused_conv_lrelu_cuda takes bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_conv_lrelu_cuda needs a contiguous {name}")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_conv_lrelu_cuda needs {name} aligned to 16 bytes")
        if t.requires_grad:
            raise RuntimeError(
                f"fused_conv_lrelu_cuda is forward-only (no backward kernel), but {name} "
                "requires grad"
            )
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, H, Cin), got shape {tuple(x.shape)}")
    bsz, h, wd, cin = x.shape
    if h != wd or h % 2:
        raise ValueError(f"x must be square with an even side, got {h}x{wd}")
    if w.dim() != 4 or tuple(w.shape[:3]) != (4, 4, cin):
        raise ValueError(f"w must be (4, 4, {cin}, Cout), got shape {tuple(w.shape)}")
    cout = w.shape[3]
    if tuple(b.shape) != (cout,):
        raise ValueError(f"b must be ({cout},), got shape {tuple(b.shape)}")
    if cin % 8 or cout % 8:
        raise ValueError(f"Cin ({cin}) and Cout ({cout}) must be multiples of 8")
    if bsz * (h // 2) ** 2 >= 2**31:
        raise ValueError(f"x of shape {tuple(x.shape)} exceeds the kernel's pixel index range")


def fused_conv_lrelu_cuda(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, slope: float = 0.1
) -> torch.Tensor:
    """Conv k4 s2 p1 + bias + LeakyReLU(``slope``) of a contiguous NHWC
    bf16 CUDA batch with the CUDA kernel; returns (B, H/2, H/2, Cout)
    NHWC bf16."""
    global launch_count
    _check(x, w, b)
    bsz, h, _, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((bsz, h // 2, h // 2, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    fn = _build.load_library().eadgan_fused_conv_lrelu_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
            bsz, h, cin, cout, float(slope), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_conv_lrelu kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out
