"""CelebA generator inference on the card: the float32 eval-mode forward,
the BatchNorm-folded bf16 forward and the int8 forward
(``ops/quant.py``), at the bench batch.

``python -m eadgan_tpu_torch.tools.quant_bench [--batch 128] [--out
f.json]`` — counterpart of ``tools/quant_bench.py``.  The generator is
torch's default init from seed 0 with its BatchNorm running statistics
drawn away from 0 and 1, as a trained model's are
(:func:`generator_inputs`); each forward is timed by CUDA events
(``utils/timing.py::device_ms``) and reported as ms a batch and img/s
beside its bound (the larger of its operations at the card's peak for
their type and its weights and output at its memory rate).  The int8
and bf16 forwards' PSNR and largest difference against the float32 eval
forward on the same latents travel with their speed, and so do the
weight bytes of the three int8 layers against float32.  Beside the int8
forward, its unchained composition (:func:`unchained_int8_forward`: each
quantization with its own abs-max pass, the int8 layers in float32, layer
4's input cast) is timed too, and both are traced with ``torch.profiler``
(:func:`profile_forward`): device time a forward by kernel, and by part
(the two int8 kernels, cuDNN's convolutions, PyTorch's elementwise and
copy kernels).

Prints one JSON line (and writes it to ``--out``); needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.models import CelebaGenerator
from eadgan_tpu_torch.ops.quant import (Int8ConvT, fold_celeba_generator_bn, int8_convt_relu,
                                        make_celeba_infer, quantize_activation)

__all__ = ["generator_inputs", "int8_layer_inputs", "psnr_db", "unchained_int8_forward",
           "profile_forward", "measure", "main", "LAYERS"]

# published peaks of one H100 SXM (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12
INT8_TENSOR_OPS_PER_S = 1979e12
# the generator's ConvTransposes: (cin, cout, taps an output pixel, output side)
LAYERS = [(218, 1024, 1, 4), (1024, 512, 4, 8), (512, 256, 4, 16), (256, 128, 4, 32),
          (128, 3, 4, 64)]
_INT8 = (1, 2, 3)


def generator_inputs(batch: int = 128, device="cuda", seed: int = 0):
    """A CelebA generator state_dict (torch's default init from ``seed``,
    BatchNorm running statistics drawn away from 0 and 1) on the CPU, and
    (z, one-hot labels, code) inputs on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        sd = CelebaGenerator().state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(0.1 * torch.randn(v.shape, generator=gen))
        elif k.endswith("running_var"):
            v.copy_(0.5 + torch.rand(v.shape, generator=gen))
    z = torch.randn(batch, 200, generator=gen)
    label = torch.nn.functional.one_hot(torch.randint(0, 10, (batch,), generator=gen), 10).float()
    code = torch.rand(batch, 8, generator=gen) * 2 - 1
    return sd, [t.to(device) for t in (z, label, code)]


def int8_layer_inputs(batch: int, h: int, cin: int, cout: int, seed: int = 0):
    """One int8 layer's inputs on the CPU: int8 NHWC activations over the
    whole range, a quantized layer (``ops/quant.py::Int8ConvT``) from
    N(0, 0.02) weights with per-channel magnitudes spread over 8x and
    N(0, 0.1) biases, and an activation scale; and the float32 NCHW
    (layer 1) or NHWC activation that the quantization kernel takes
    there, N(0, 3) within +-15.8 (after a ReLU but for layer 1's), with a
    third of its values put on exact .5 ties of a 2^-3 scale."""
    gen = torch.Generator().manual_seed(seed)
    xq = torch.randint(-127, 128, (batch, h, h, cin), generator=gen, dtype=torch.int8)
    weight = 0.02 * torch.randn(cin, cout, 4, 4, generator=gen)
    weight *= torch.exp2(3 * torch.rand(cout, generator=gen))[None, :, None, None]
    layer = Int8ConvT.from_folded(weight, 0.1 * torch.randn(cout, generator=gen))
    shape = (batch, cin, h, h) if h == 4 else (batch, h, h, cin)
    act = (torch.randn(shape, generator=gen) * 3).clamp(-15.8, 15.8)
    if h != 4:
        act = torch.relu(act)
    ties = torch.rand(shape, generator=gen) < 1 / 3
    act = torch.where(ties, (torch.round(act * 8 - 0.5).clamp(-126, 126) + 0.5) / 8, act)
    act.view(-1)[0] = 127 / 8  # the scale is 2^-3: every tie is exact
    return xq, torch.tensor(0.0173), layer, act


def unchained_int8_forward(state_dict, compute_dtype=torch.bfloat16, device=None) -> Callable:
    """The int8 forward of ``make_celeba_infer(quant="int8")`` as separate
    steps, without its chaining: each quantization computes its own
    abs-max, each int8 layer writes float32, and layer 4 casts its input
    to ``compute_dtype``.  The chained forward equals it bit for bit."""
    folded = fold_celeba_generator_bn(state_dict)
    if device is not None:
        folded = [(w.to(device), b.to(device)) for w, b in folded]
    (w0, b0), (w4, b4) = folded[0], folded[4]
    w0, w4 = w0.to(compute_dtype), w4.to(compute_dtype)
    int8_layers = [Int8ConvT.from_folded(w, b) for w, b in folded[1:4]]

    @torch.no_grad()
    def fwd(z, labels, code):
        x = torch.cat([z, labels, code], dim=-1).float()[:, :, None, None]
        x = F.conv_transpose2d(x.to(compute_dtype), w0, None, 1, 0).float() + b0[None, :, None, None]
        nhwc = False
        for layer in int8_layers:
            xq, a_scale = quantize_activation(x, nhwc)
            x, nhwc = int8_convt_relu(xq, a_scale, layer), True
        x = x.permute(0, 3, 1, 2).to(compute_dtype)
        return torch.tanh(F.conv_transpose2d(x, w4, None, 2, 1).float() + b4[None, :, None, None])

    return fwd


# a kernel's part of the int8 forward, by the first pattern its name holds
_PARTS = (("int8_convt", ("int8_convt_kernel",)),
          ("quantize_int8", ("quantize_nchw_kernel", "quantize_nhwc_kernel", "amax_kernel")),
          ("cudnn_convt", ("conv", "xmma", "cutlass", "gemm", "sm90", "dgrad", "cudnn")),
          ("elementwise", ("elementwise", "reduce", "cat", "copy", "fill")))


def _part(name: str) -> str:
    low = name.lower()
    for part, patterns in _PARTS:
        if any(p in low for p in patterns):
            return part
    return "other"


def profile_forward(fn: Callable, inputs, forwards: int = 20) -> dict:
    """Device time a forward by kernel name and by part (``_PARTS``), from
    a ``torch.profiler`` trace of ``forwards`` back-to-back calls of
    ``fn(*inputs)`` after a warm-up.  A trace that shows no kernel says so
    (``kernels_in_trace`` false, times None)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(forwards):
            fn(*inputs)
        torch.cuda.synchronize()
    per_kernel = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, us]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            per_kernel[e.name][0] += 1
            per_kernel[e.name][1] += e.time_range.elapsed_us()
    seen = bool(per_kernel)
    parts = collections.defaultdict(float)
    for name, (_, us) in per_kernel.items():
        parts[_part(name)] += us / 1e3 / forwards
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1], reverse=True)
    return {
        "kernels_in_trace": seen,
        "device_kernel_ms_per_forward": sum(parts.values()) if seen else None,
        "kernel_launches_per_forward": sum(c for c, _ in per_kernel.values()) / forwards if seen else None,
        "ms_per_forward_by_part": dict(parts) if seen else None,
        "kernels": [{"name": name[:120], "part": _part(name), "calls_per_forward": calls / forwards,
                     "device_ms_per_forward": us / 1e3 / forwards} for name, (calls, us) in top],
    }


def psnr_db(out: torch.Tensor, ref: torch.Tensor) -> float:
    """PSNR of tanh outputs (peak to peak 2)."""
    return 10 * math.log10(4.0 / ((out - ref) ** 2).mean().item())


def measure(batch: int = 128, cycles: Optional[float] = None) -> dict:
    """The three forwards' records (see the module docstring)."""
    from eadgan_tpu_torch.utils.timing import device_ms, sleep_cycles_per_ms

    cycles = cycles or sleep_cycles_per_ms()
    sd, x = generator_inputs(batch)
    model = CelebaGenerator()
    model.load_state_dict(sd)
    model = model.cuda().eval()
    forwards = {
        "bf16_folded": make_celeba_infer(sd, quant="none", compute_dtype=torch.bfloat16, device="cuda"),
        "int8": make_celeba_infer(sd, quant="int8", compute_dtype=torch.bfloat16, device="cuda"),
        "int8_unchained": unchained_int8_forward(sd, torch.bfloat16, device="cuda"),
    }

    def f32(*inputs):
        with torch.no_grad():
            return model(*inputs)

    macs = [cin * cout * taps * side * side * batch for cin, cout, taps, side in LAYERS]
    weights = [sd[f"conv_blocks.{k}.weight"].numel() for k in (0, 1, 4, 7, 10)]
    params = sum(v.numel() for k, v in sd.items() if k.endswith((".weight", ".bias")))
    int8_weights = sum(weights[i] for i in _INT8)
    out_bytes = batch * 3 * 64 * 64 * 4
    flops = 2 * sum(macs)
    int8_ops_s = 2 * sum(macs[i] for i in _INT8) / INT8_TENSOR_OPS_PER_S
    seconds = {  # (operations at peak, bytes at the memory rate)
        "f32_eval": (flops / F32_FLOPS_PER_S, (4 * params + out_bytes) / HBM_BYTES_PER_S),
        "bf16_folded": (flops / BF16_TENSOR_FLOPS_PER_S, (2 * params + out_bytes) / HBM_BYTES_PER_S),
        "int8": ((flops - 2 * sum(macs[i] for i in _INT8)) / BF16_TENSOR_FLOPS_PER_S + int8_ops_s,
                 (2 * (params - int8_weights) + int8_weights + out_bytes) / HBM_BYTES_PER_S),
    }
    seconds["int8_unchained"] = seconds["int8"]
    ref = f32(*x)
    record = {"inference": "celeba_generator", "batch_size": batch, "timing": "cuda_events",
              "device": torch.cuda.get_device_name(0), "gflop_per_batch": flops / 1e9,
              "int8_layer_weight_mb": int8_weights / 1e6,
              "int8_layer_weight_mb_f32": 4 * int8_weights / 1e6}
    for name, fn in (("f32_eval", f32), *forwards.items()):
        ms = device_ms(lambda fn=fn: fn(*x), 20, cycles)
        ops_s, bytes_s = seconds[name]
        record[name] = {"ms": ms, "img_per_s": batch / ms * 1e3, "bound_ms": max(ops_s, bytes_s) * 1e3,
                        "bound_by": "operations" if ops_s >= bytes_s else "bytes",
                        "tflop_per_s": flops / ms / 1e9}
        if name != "f32_eval":
            out = fn(*x)
            record[name].update(psnr_db_vs_f32_eval=psnr_db(out, ref),
                                max_abs_err_vs_f32_eval=(out - ref).abs().max().item())
    record["int8"]["equals_unchained"] = torch.equal(forwards["int8"](*x),
                                                     forwards["int8_unchained"](*x))
    record["profile"] = {name: profile_forward(forwards[name], x)
                         for name in ("int8", "int8_unchained")}
    return record


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--out", type=str, default="")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the inference timings need the card")
    disable_tf32()
    record = measure(opt.batch)
    line = json.dumps(record)
    print(line, flush=True)
    if opt.out:
        with open(opt.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
