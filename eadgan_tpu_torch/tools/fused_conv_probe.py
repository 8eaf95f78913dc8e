"""Probe of the fused conv + bias + LeakyReLU kernel against the library
convolution, at the CelebA discriminator's layer-2 shape.

``python -m eadgan_tpu_torch.tools.fused_conv_probe [--batch 128 --hw 32
--cin 128 --cout 256 --steps 300] [--out FILE]`` is the counterpart of
``tools/fused_conv_probe.py``.  From ``np.random.default_rng(0)`` it makes
bf16 ``x`` (B, H, H, Cin), ``w`` 0.05 * N(0, 1) (4, 4, Cin, Cout) and
``b`` 0.01 * N(0, 1) (Cout,), as the JAX tool does, then:

1. correctness first: the kernel (``ops.fused_conv_lrelu``) against the
   library convolution plus its epilogue, failing unless the largest
   difference is below 2e-2 of max(1, max |ref|), the JAX tool's bar;
   then against the plain version (``ops.fused_conv_lrelu_plain``), per
   element (``ops.fused_conv.mismatch``), failing on a ratio above 1,
   which a wrong bias or a misplaced tile cannot pass;
2. times: ``library_conv_only`` (cuDNN's bf16 ``F.conv2d`` on
   channels_last tensors, in place of ``xla_conv_only``),
   ``library_conv_bias_lrelu`` (the same conv with its bias, then
   ``F.leaky_relu``, in place of ``xla_conv_bias_lrelu``) and
   ``cuda_fused`` (the kernel, in place of ``pallas_fused``), in ms, and
   ``elementwise_fusion_delta_ms``, the epilogue's cost in the library;
3. bytes and GFLOP counted from the shapes (each input read once, the
   output written once; 2 * M * N * K), in place of XLA's
   ``cost_analysis``.

It prints one JSON line per timing and the whole record last, and writes
the record to ``--out`` when given.  On the card the times are device
times from CUDA events (``utils/timing.py``).  Under
``EADGAN_PLATFORM=cpu`` the fused call runs the plain version and the
times come from the host clock; the record then says ``"timing":
"host_clock"`` and names the fused entry ``plain_fused``.  The library
calls are yardsticks timed beside the kernel; nothing else in the port
calls them for this function.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from eadgan_tpu_torch.ops import fused_conv_lrelu, fused_conv_lrelu_plain
from eadgan_tpu_torch.ops.fused_conv import mismatch
from eadgan_tpu_torch.utils import platform_device
from eadgan_tpu_torch.utils.timing import device_ms, host_ms_per_call, sleep_cycles_per_ms

__all__ = ["main", "counts", "library_conv", "library_conv_bias_lrelu"]

SLOPE = 0.1


def library_conv(x_nchw: torch.Tensor, w_oihw: torch.Tensor) -> torch.Tensor:
    """The library's k4 s2 p1 convolution in the inputs' type."""
    return F.conv2d(x_nchw, w_oihw, stride=2, padding=1)


def library_conv_bias_lrelu(
    x_nchw: torch.Tensor, w_oihw: torch.Tensor, b: torch.Tensor, slope: float = SLOPE
) -> torch.Tensor:
    """The library's convolution with its bias, then its LeakyReLU."""
    return F.leaky_relu(F.conv2d(x_nchw, w_oihw, b, stride=2, padding=1), slope)


def counts(batch: int, hw: int, cin: int, cout: int, itemsize: int = 2):
    """(bytes, flops) the function needs: every input read once and the
    output written once; a multiply-add per (pixel, channel, tap)."""
    ho = hw // 2
    elems = batch * hw * hw * cin + 16 * cin * cout + cout + batch * ho * ho * cout
    return elems * itemsize, 2 * batch * ho * ho * cout * 16 * cin


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=32, help="input spatial size")
    ap.add_argument("--cin", type=int, default=128)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--out", type=str, default="", help="also write the JSON record here")
    opt = ap.parse_args(argv)

    device = platform_device()
    rng = np.random.default_rng(0)

    def bf16(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(torch.bfloat16).to(device)

    x = bf16(rng.standard_normal((opt.batch, opt.hw, opt.hw, opt.cin)))
    w = bf16(0.05 * rng.standard_normal((4, 4, opt.cin, opt.cout)))
    b = bf16(0.01 * rng.standard_normal((opt.cout,)))
    # the library's layouts of the same data: a channels_last view of x,
    # and w once as OIHW channels_last
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    on_card = x.is_cuda
    results = {
        "shape": [opt.batch, opt.hw, opt.hw, opt.cin, opt.cout],
        "device": torch.cuda.get_device_name(x.device) if on_card else "cpu",
        "timing": "cuda_events" if on_card else "host_clock",
    }

    # correctness first: bf16 taps and float32 accumulation in both; the
    # library rounds its conv output to bf16 before the epilogue
    got = fused_conv_lrelu(x, w, b, SLOPE)
    ref = library_conv_bias_lrelu(x_nchw, w_oihw, b).permute(0, 2, 3, 1)
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / max(1.0, ref.float().abs().max().item())
    results["max_abs_err"] = err
    results["rel"] = rel
    print(json.dumps({"max_abs_err": err, "rel": rel}), flush=True)
    if got.dtype != torch.bfloat16 or tuple(got.shape) != tuple(ref.shape) or not rel < 2e-2:
        raise RuntimeError(f"fused conv does not match the library conv: rel {rel}")
    # the library rounds before its epilogue; the plain version rounds once,
    # as the kernel does, so it holds the kernel per element
    diff = mismatch(got, fused_conv_lrelu_plain(x, w, b, SLOPE))
    results["plain_max_abs_err"] = diff["max_abs_err"]
    results["plain_elem"] = diff["elem"]
    print(json.dumps({"plain_max_abs_err": diff["max_abs_err"], "plain_elem": diff["elem"]}),
          flush=True)
    if not diff["elem"] <= 1.0:
        raise RuntimeError(f"fused conv does not match its plain version per element: {diff}")

    if on_card:
        cycles = sleep_cycles_per_ms()

        def timed(fn):
            return device_ms(fn, opt.steps, cycles)
    else:

        def timed(fn):
            return host_ms_per_call(fn, opt.steps, cuda=False)

    fused_name = "cuda_fused" if on_card else "plain_fused"
    for name, fn in (
        ("library_conv_only", lambda: library_conv(x_nchw, w_oihw)),
        ("library_conv_bias_lrelu", lambda: library_conv_bias_lrelu(x_nchw, w_oihw, b)),
        (fused_name, lambda: fused_conv_lrelu(x, w, b, SLOPE)),
    ):
        results[name] = timed(fn)
        print(json.dumps({"name": name, "ms": results[name]}), flush=True)
    results["elementwise_fusion_delta_ms"] = (
        results["library_conv_bias_lrelu"] - results["library_conv_only"]
    )
    nbytes, flops = counts(opt.batch, opt.hw, opt.cin, opt.cout)
    results["bytes_gb"] = nbytes / 1e9
    results["gflop"] = flops / 1e9

    print(json.dumps(results), flush=True)
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
