"""CUDA wrapper of the bilinear affine warp (``csrc/warp_affine.cu``).

Replaces ``eadgan_tpu/ops/stn_pallas.py::warp_affine_pallas``.  The
wrapper checks what the kernel takes (a contiguous NHWC float32 or bf16
CUDA tensor, (N, 3, 3) or (N, 2, 3) matrices on the same card) and raises
on anything else; it never falls back to the plain version.  It
allocates the output, launches on PyTorch's current stream and raises if
the launch was refused.

Gradients: no training path differentiates through the warp, but a
correct one is given all the same, as autograd through the plain version
(``ops/stn.py``), mirroring the JAX kernel's ``_bwd``.

``launch_count`` counts kernel launches, so a run can show that its main
path went through the kernel.  A call made while the stream is being
captured into a CUDA graph records the kernel and launches nothing: it
adds to ``captured_count`` instead, and whoever replays the graph counts
the launches of each replay with :func:`count_replayed`.  A process
started with ``EADGAN_LAUNCH_REPORT=<dir>`` writes its count at exit to
``<dir>/warp_launches.<pid>.json`` (with its rank, ``EADGAN_MP_PROCESS_ID``),
so a script can count the launches of the ranks of a gang it started.
"""

from __future__ import annotations

import atexit
import json
import os

import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.ops.stn import PADDING_MODES, warp_affine_plain

__all__ = ["warp_affine_cuda", "launch_count", "captured_count", "reset_launch_count",
           "count_replayed"]

launch_count = 0
captured_count = 0

_ENTRY = {torch.float32: "eadgan_warp_affine_f32", torch.bfloat16: "eadgan_warp_affine_bf16"}


def _report_launches(directory: str) -> None:
    with open(os.path.join(directory, f"warp_launches.{os.getpid()}.json"), "w") as f:
        json.dump({"rank": os.environ.get("EADGAN_MP_PROCESS_ID", ""), "launches": launch_count}, f)


if os.environ.get("EADGAN_LAUNCH_REPORT"):
    atexit.register(_report_launches, os.environ["EADGAN_LAUNCH_REPORT"])


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def count_replayed(launches: int) -> None:
    """Count ``launches`` kernel launches made by replaying CUDA graphs."""
    global launch_count
    launch_count += launches


def _check(img: torch.Tensor, matrix: torch.Tensor, padding_mode: str) -> None:
    if padding_mode not in PADDING_MODES:
        raise ValueError(f"unsupported padding_mode: {padding_mode!r}")
    if not img.is_cuda:
        raise ValueError(f"warp_affine_cuda needs a CUDA tensor, got one on {img.device}")
    if img.dtype not in _ENTRY:
        raise TypeError(f"warp_affine_cuda takes float32 or bfloat16 images, got {img.dtype}")
    if img.dim() != 4:
        raise ValueError(f"warp_affine_cuda takes (N, H, W, C) images, got shape {tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("warp_affine_cuda needs a contiguous NHWC image tensor")
    n = img.shape[0]
    if matrix.dim() != 3 or matrix.shape[0] != n or tuple(matrix.shape[1:]) not in ((3, 3), (2, 3)):
        raise ValueError(
            f"matrix must be ({n}, 3, 3) or ({n}, 2, 3), got {tuple(matrix.shape)}"
        )
    if matrix.device != img.device:
        raise ValueError(f"matrix is on {matrix.device}, image on {img.device}")
    if not matrix.is_floating_point():
        raise TypeError(f"matrix must be floating point, got {matrix.dtype}")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid limit of 65535")


def _launch(img: torch.Tensor, matrix: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """One kernel launch; ``matrix`` is a contiguous (N, 3, 3) or (N, 2, 3)
    float32 tensor, whose top two rows the kernel reads in place."""
    global launch_count, captured_count
    out = torch.empty_like(img)
    n, h, w, c = img.shape
    if out.numel() == 0:
        return out
    fn = getattr(_build.load_library(), _ENTRY[img.dtype])
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            img.data_ptr(), matrix.data_ptr(), out.data_ptr(), n, h, w, c,
            matrix.shape[1] * 3, int(padding_mode == "zeros"), stream,
        )
    if err != 0:
        raise RuntimeError(f"warp_affine kernel launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        captured_count += 1
    else:
        launch_count += 1
    return out


class _WarpAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img, matrix, padding_mode):
        ctx.save_for_backward(img, matrix)
        ctx.padding_mode = padding_mode
        return _launch(img, matrix, padding_mode)

    @staticmethod
    def backward(ctx, grad_out):
        img, matrix = ctx.saved_tensors
        needs = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            img_ = img.detach().requires_grad_(needs[0])
            matrix_ = matrix.detach().requires_grad_(needs[1])
            out = warp_affine_plain(img_, matrix_, ctx.padding_mode)
            wrt = [t for t, need in zip((img_, matrix_), needs) if need]
            grads = iter(torch.autograd.grad(out, wrt, grad_out))
        return (
            next(grads) if needs[0] else None,
            next(grads) if needs[1] else None,
            None,
        )


def warp_affine_cuda(
    img: torch.Tensor, matrix: torch.Tensor, padding_mode: str = "border"
) -> torch.Tensor:
    """Warp a contiguous NHWC CUDA batch by (N, 3, 3) or (N, 2, 3) affine
    matrices with the CUDA kernel; the output keeps ``img``'s dtype."""
    _check(img, matrix, padding_mode)
    # no copy for the contiguous float32 matrices code_to_matrix builds
    matrix = matrix.to(torch.float32).contiguous()
    return _WarpAffine.apply(img, matrix, padding_mode)
