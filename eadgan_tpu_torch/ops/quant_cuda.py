"""CUDA wrappers of the int8 generator's two kernels.

* ``quantize_int8`` (``csrc/quantize_int8.cu``) replaces XLA's lowering
  of ``eadgan_tpu/ops/quant.py::_quantize_activation``: the abs-max of a
  float32 activation, its scale, and the int8 tensor, written NHWC from
  an NCHW or NHWC input.  Given the abs-max (``amax_bits``, written by
  the ``int8_convt`` launch that produced the activation) it is one
  launch that reads the activation once; without, an abs-max launch
  comes first.  Each launch is counted.
* ``int8_convt`` (``csrc/int8_convt.cu``) replaces XLA's int8 lowering of
  ``eadgan_tpu/ops/quant.py::_convt`` at the generator's three quantized
  layers: the k4 s2 p1 transposed conv of an int8 NHWC tensor on the
  tensor cores, with the dequantization, bias and ReLU fused, float32 or
  bf16 NHWC out, and on request the abs-max of that output for the next
  quantization.  One launch a call.

Each wrapper checks what its kernel takes (device, dtype, shape,
contiguity, alignment) and raises on anything else; it never falls back
to the plain version (``ops/quant.py``).  It allocates its outputs and
scratch with ``torch.empty``, launches on PyTorch's current stream and
raises if a launch was refused.  ``launch_count`` counts the launches of
each kernel by name, so a run can show that its path went through them
(the memset that zeroes an abs-max word is not a kernel and is not
counted).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from eadgan_tpu_torch.ops import _build

__all__ = ["quantize_int8_cuda", "int8_convt_cuda", "launch_count", "reset_launch_count"]

launch_count = {"int8_convt": 0, "quantize_int8": 0}


def reset_launch_count() -> None:
    for name in launch_count:
        launch_count[name] = 0


def _check_tensor(fn: str, name: str, t: torch.Tensor, dtype: torch.dtype, device) -> None:
    if not t.is_cuda:
        raise ValueError(f"{fn} needs CUDA tensors, {name} is on {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, the input on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn} takes {dtype} {name}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn} needs a contiguous {name}")
    if t.data_ptr() % 16:
        raise ValueError(f"{fn} needs {name} aligned to 16 bytes")


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def _check_amax_bits(fn: str, name: str, bits: torch.Tensor, device) -> None:
    _check_tensor(fn, name, bits, torch.int32, device)
    if bits.numel() != 1:
        raise ValueError(f"{fn}: {name} must hold one int32 word, got shape {tuple(bits.shape)}")


def quantize_int8_cuda(x: torch.Tensor, nhwc: bool, amax_bits: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor int8 of a contiguous float32 CUDA activation, (B, C, H,
    W) (``nhwc=False``) or (B, H, W, C): returns the int8 (B, H, W, C)
    tensor and the 0-d float32 scale, both on the card.  ``amax_bits``,
    one int32 word on the card holding the bits of ``max |x|`` (as
    :func:`int8_convt_cuda` writes it), replaces the kernel's own
    abs-max pass."""
    fn_name = "quantize_int8_cuda"
    _check_tensor(fn_name, "x", x, torch.float32, None)
    if amax_bits is not None:
        _check_amax_bits(fn_name, "amax_bits", amax_bits, x.device)
    if x.dim() != 4:
        raise ValueError(f"{fn_name} takes a 4-D activation, got shape {tuple(x.shape)}")
    b, c, h, w = x.shape if not nhwc else (x.shape[0], x.shape[3], x.shape[1], x.shape[2])
    if c % 4:
        raise ValueError(f"{fn_name} needs a channel count that is a multiple of 4, got {c}")
    if x.numel() == 0 or x.numel() >= 2**31 or (not nhwc and b >= 2**16):
        raise ValueError(f"{fn_name}: shape {tuple(x.shape)} is outside the kernel's range")
    q = torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)
    scale = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if amax_bits is None:
            amax_bits = torch.empty((1,), dtype=torch.int32, device=x.device)
            _raise_on(lib.eadgan_int8_amax(x.data_ptr(), amax_bits.data_ptr(), x.numel(), stream),
                      "quantize_int8 (abs-max)")
            launch_count["quantize_int8"] += 1
        _raise_on(lib.eadgan_int8_quantize(x.data_ptr(), amax_bits.data_ptr(), q.data_ptr(),
                                           scale.data_ptr(), b, c, h * w, int(not nhwc), stream),
                  "quantize_int8 (quantize)")
        launch_count["quantize_int8"] += 1
    return q, scale


OUT_DTYPES = (torch.float32, torch.bfloat16)


def int8_convt_cuda(xq: torch.Tensor, wp: torch.Tensor, a_scale: torch.Tensor,
                    w_scale: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype = torch.float32,
                    amax_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``relu(convt(xq, w) * (a_scale * w_scale) + bias)`` of a k4 s2 p1
    transposed conv: ``xq`` int8 (B, H, W, Cin), ``wp`` the int8 repack
    (4, Cout, 4, Cin) (``ops/quant.py::repack_convt_weight``),
    ``a_scale`` a 0-d float32 tensor and ``w_scale``, ``bias`` (Cout,)
    float32, all contiguous on one card; returns (B, 2H, 2W, Cout) in
    ``out_dtype`` (float32, or bfloat16 rounded to nearest even from the
    float32 value).  ``amax_out``, one int32 word on the card, receives
    the bits of the output's ``max |out|``.  Cin must be a multiple of 64
    and Cout of 8; W must divide 128, and the 128 / W input rows of a tile
    must divide H or be a multiple of it."""
    fn_name = "int8_convt_cuda"
    _check_tensor(fn_name, "xq", xq, torch.int8, None)
    for name, t, dtype in (("wp", wp, torch.int8), ("a_scale", a_scale, torch.float32),
                           ("w_scale", w_scale, torch.float32), ("bias", bias, torch.float32)):
        _check_tensor(fn_name, name, t, dtype, xq.device)
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"{fn_name} writes float32 or bfloat16, not {out_dtype}")
    if amax_out is not None:
        _check_amax_bits(fn_name, "amax_out", amax_out, xq.device)
    if xq.dim() != 4:
        raise ValueError(f"xq must be (B, H, W, Cin), got shape {tuple(xq.shape)}")
    b, h, w, cin = xq.shape
    if wp.dim() != 4 or wp.shape[0] != 4 or wp.shape[2] != 4 or wp.shape[3] != cin:
        raise ValueError(f"wp must be (4, Cout, 4, {cin}), got shape {tuple(wp.shape)}")
    cout = wp.shape[1]
    if a_scale.dim() != 0:
        raise ValueError(f"a_scale must be 0-d, got shape {tuple(a_scale.shape)}")
    for name, t in (("w_scale", w_scale), ("bias", bias)):
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{name} must be ({cout},), got shape {tuple(t.shape)}")
    if cin % 64 or cout % 8:
        raise ValueError(f"Cin ({cin}) must be a multiple of 64 and Cout ({cout}) of 8")
    rows = 128 // w if w and 128 % w == 0 else 0
    if not rows or (h % rows if rows <= h else rows % h):
        raise ValueError(f"{fn_name} tiles 128 pixels as whole rows of the input: W ({w}) must "
                         f"divide 128 and its 128 / W rows divide H ({h}) or be a multiple of it")
    if xq.numel() == 0 or b * h * w * 4 * cout >= 2**31 or 16 * cin * cout >= 2**31:
        raise ValueError(f"shapes {tuple(xq.shape)} x {tuple(wp.shape)} outside the kernel's range")
    out = torch.empty((b, 2 * h, 2 * w, cout), dtype=out_dtype, device=xq.device)
    fn = _build.load_library().eadgan_int8_convt_s2
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xq.data_ptr(), wp.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                 bias.data_ptr(), out.data_ptr(), None if amax_out is None else amax_out.data_ptr(),
                 b, h, w, cin, cout, int(out_dtype == torch.bfloat16), stream)
    _raise_on(err, "int8_convt")
    launch_count["int8_convt"] += 1
    return out
