"""Where a kernel's time goes: the kernel timed whole and with one part
stubbed out, on the card.

``python -m eadgan_tpu_torch.tools.conv_ablation [--batch 128 --hw 32
--cin 128 --cout 256 --iters 300] [--out FILE]`` writes variants of
``csrc/fused_conv_lrelu.cu`` into ``_build/ablation/``, each with one part
made unreachable behind a run-time condition that never holds (so the
compiler keeps the rest as it is), builds them all at once with nvcc, and
times each at the same shape with CUDA events (``utils/timing.py``):

- ``full``: the kernel as it is;
- ``no_epilogue``: no bias, LeakyReLU, rounding or store;
- ``no_bias``: no bias loads (the bias reads as zero);
- ``no_store``: the epilogue without its TMA stores of the output;
- ``no_mma``: no ``wgmma`` (the ring still fills and drains);
- ``no_a_loads`` / ``no_b_loads`` / ``no_loads``: the TMA loads of A, of
  B or of both left out (the ring's barriers complete on the bytes that
  remain; the products run on whatever the ring holds).

``--kernel int8_convt --layer 1|2|3 [--batch 128]`` does the same for
``csrc/int8_convt.cu`` at the CelebA generator's int8 layer (as the int8
forward runs it: float32 out with the abs-max at layers 1 and 2, bf16
at layer 3), with the same variants but ``no_bias`` (its epilogue loads
scales and biases together).  ``--kernel quantize_int8 --layer 1|2|3``
times ``csrc/quantize_int8.cu``'s quantization of that layer's input
(NCHW at layer 1, NHWC after), the abs-max given: ``full``,
``no_divide`` (a multiply where the IEEE division was) and
``no_quantize`` (the input's low bytes stored: what reading and writing
cost alone).

Only ``full`` computes the function; the others time what is left.  It
prints one JSON line per variant and the record last, and writes the
record to ``--out`` when given.  It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.utils.timing import device_ms, sleep_cycles_per_ms

__all__ = ["main", "VARIANTS", "INT8_VARIANTS", "QUANT_VARIANTS", "KERNELS", "variant_source"]

SOURCE = _build.CSRC / "fused_conv_lrelu.cu"
NEVER = "p.cout < 0"  # a run-time condition that never holds

_EXPECT = "          mbar_expect_tx(&full[stage], kABytes + kBBytes);"
_LOAD_A = "          tma_load_4d(smem_a + stage * kABytes"
_LOAD_B = "          for (int i = 0; i < BN / 64; ++i)\n            tma_load_3d("
_MMA = "          wgmma_tile<BN>(acc, a_desc("
_EPILOGUE = "      // epilogue, 64 channels at a time"
_BIAS = "        bias2[j] = n < p.cout ?"
_STORE = "          tma_store_4d(&map_out, buf,"
_TILE_END = "      }\n    }\n    if (tid == 0) bulk_wait_all();"

# each variant: (old, new) replacements of the kernel's source
VARIANTS = {
    "full": [],
    "no_epilogue": [
        (_EPILOGUE, f"      if ({NEVER}) {{\n{_EPILOGUE}"),
        (_TILE_END, "      }\n" + _TILE_END),
    ],
    "no_bias": [(_BIAS, f"        bias2[j] = {NEVER} ?")],
    "no_store": [(_STORE, f"          if ({NEVER}) tma_store_4d(&map_out, buf,")],
    "no_mma": [(_MMA, f"          if ({NEVER}) wgmma_tile<BN>(acc, a_desc(")],
    "no_a_loads": [
        (_EXPECT, "          mbar_expect_tx(&full[stage], kBBytes);"),
        (_LOAD_A, f"          if ({NEVER}) tma_load_4d(smem_a + stage * kABytes"),
    ],
    "no_b_loads": [
        (_EXPECT, "          mbar_expect_tx(&full[stage], kABytes);"),
        (_LOAD_B, "          for (int i = 0; i < 0; ++i)\n            tma_load_3d("),
    ],
    "no_loads": [
        (_EXPECT, "          mbar_expect_tx(&full[stage], 0);"),
        (_LOAD_A, f"          if ({NEVER}) tma_load_4d(smem_a + stage * kABytes"),
        (_LOAD_B, "          for (int i = 0; i < 0; ++i)\n            tma_load_3d("),
    ],
}


INT8_SOURCE = _build.CSRC / "int8_convt.cu"
_I_EXPECT = "          mbar_expect_tx(&full[stage], kABytes + kBBytes);"
_I_LOAD_A = "          tma_load_4d(smem_a + stage * kABytes, &map_x,"
_I_LOAD_B = "          tma_load_4d(smem_b + stage * kBBytes, &map_w,"
_I_MMA = "          wgmma_tile<BN>(acc, kmajor_desc("
_I_EPILOGUE = "      // epilogue, 128 bytes of columns at a time"
_I_STORE = "          tma_store_5d(&map_out, buf,"

INT8_VARIANTS = {
    "full": [],
    "no_epilogue": [
        (_I_EPILOGUE, f"      if ({NEVER}) {{\n{_I_EPILOGUE}"),
        (_TILE_END, "      }\n" + _TILE_END),
    ],
    "no_store": [(_I_STORE, f"          if ({NEVER}) tma_store_5d(&map_out, buf,")],
    "no_mma": [(_I_MMA, f"          if ({NEVER}) wgmma_tile<BN>(acc, kmajor_desc(")],
    "no_a_loads": [
        (_I_EXPECT, "          mbar_expect_tx(&full[stage], kBBytes);"),
        (_I_LOAD_A, f"          if ({NEVER}) tma_load_4d(smem_a + stage * kABytes, &map_x,"),
    ],
    "no_b_loads": [
        (_I_EXPECT, "          mbar_expect_tx(&full[stage], kABytes);"),
        (_I_LOAD_B, f"          if ({NEVER}) tma_load_4d(smem_b + stage * kBBytes, &map_w,"),
    ],
    "no_loads": [
        (_I_EXPECT, "          mbar_expect_tx(&full[stage], 0);"),
        (_I_LOAD_A, f"          if ({NEVER}) tma_load_4d(smem_a + stage * kABytes, &map_x,"),
        (_I_LOAD_B, f"          if ({NEVER}) tma_load_4d(smem_b + stage * kBBytes, &map_w,"),
    ],
}

QUANT_SOURCE = _build.CSRC / "quantize_int8.cu"
_Q_ROUND = "  const float r = rintf(__fdiv_rn(v, scale));"
_Q_RETURN = ("  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f)))"
             " & 0xFFu;")

QUANT_VARIANTS = {
    "full": [],
    "no_divide": [(_Q_ROUND, "  const float r = rintf(__fmul_rn(v, scale));")],
    "no_quantize": [(_Q_ROUND + "\n" + _Q_RETURN, "  return __float_as_uint(v) & 0xFFu;")],
}

# kernel: (source, variants, C entry point)
KERNELS = {
    "fused_conv": (SOURCE, VARIANTS, "eadgan_fused_conv_lrelu_bf16"),
    "int8_convt": (INT8_SOURCE, INT8_VARIANTS, "eadgan_int8_convt_s2"),
    "quantize_int8": (QUANT_SOURCE, QUANT_VARIANTS, "eadgan_int8_quantize"),
}


def variant_source(name: str, source: str, variants=VARIANTS) -> str:
    """The kernel's ``source`` with variant ``name``'s parts stubbed out
    (``variants``: ``VARIANTS`` or ``INT8_VARIANTS``); raises if an
    anchor is no longer in the source exactly once."""
    for old, new in variants[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: anchor {old!r} is not in the kernel once")
        source = source.replace(old, new)
    return source


def _build_variant(kernel: str, name: str):
    source, variants, entry = KERNELS[kernel]
    directory = _build.BUILD_DIR / "ablation"
    directory.mkdir(parents=True, exist_ok=True)
    headers = sorted(_build.CSRC.glob("*.cuh"))
    for header in headers:  # the variant includes them from its own directory
        shutil.copyfile(header, directory / header.name)
    src = directory / f"{kernel}_{name}.cu"
    src.write_text(variant_source(name, source.read_text(), variants))
    path, _, _ = _build.build([src], f"libeadgan_ablation_{kernel}_{name}", hashed=headers)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, entry)
    fn.argtypes = _build._SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return fn


def _fused_conv_call(opt):
    """(call(fn) -> CUDA error, shape) of the fused conv at the options' shape."""
    gen = torch.Generator().manual_seed(0)
    shape = (opt.batch, opt.hw, opt.hw, opt.cin)
    x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    w = (0.05 * torch.randn(4, 4, opt.cin, opt.cout, generator=gen)).to("cuda", torch.bfloat16)
    b = (0.01 * torch.randn(opt.cout, generator=gen)).to("cuda", torch.bfloat16)
    out = torch.empty(opt.batch, opt.hw // 2, opt.hw // 2, opt.cout, dtype=torch.bfloat16,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        return fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), opt.batch, opt.hw,
                  opt.cin, opt.cout, 0.1, stream)

    return call, [*shape, opt.cout]


def _int8_layer(layer: int):
    """(H, Cin, Cout) of the CelebA generator's int8 layer 1, 2 or 3."""
    from eadgan_tpu_torch.tools.quant_bench import LAYERS

    cin, cout, _, side = LAYERS[layer]
    return side // 2, cin, cout


def _int8_convt_call(opt):
    """(call(fn) -> CUDA error, shape) of int8_convt at the options' layer,
    with the output type and abs-max of the int8 forward there."""
    from eadgan_tpu_torch.tools.quant_bench import int8_layer_inputs

    h, cin, cout = _int8_layer(opt.layer)
    xq, a_scale, layer, _ = int8_layer_inputs(opt.batch, h, cin, cout)
    xq, a_scale, wp, w_scale, bias = (t.cuda() for t in (xq, a_scale, layer.wp, layer.w_scale,
                                                          layer.bias))
    last = opt.layer == 3
    out = torch.empty(opt.batch, 2 * h, 2 * h, cout, device="cuda",
                      dtype=torch.bfloat16 if last else torch.float32)
    bits = torch.empty((), dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        return fn(xq.data_ptr(), wp.data_ptr(), a_scale.data_ptr(), w_scale.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), None if last else bits.data_ptr(), opt.batch,
                  h, h, cin, cout, int(last), stream)

    return call, [opt.batch, h, h, cin, cout]


def _quantize_int8_call(opt):
    """(call(fn) -> CUDA error, shape) of the quantization of the options'
    layer's input, the abs-max given, as the int8 forward runs it there."""
    from eadgan_tpu_torch.tools.quant_bench import int8_layer_inputs

    h, cin, cout = _int8_layer(opt.layer)
    act = int8_layer_inputs(opt.batch, h, cin, cout)[3].cuda()
    bits = act.abs().amax().view(torch.int32).clone()
    q = torch.empty(opt.batch, h, h, cin, dtype=torch.int8, device="cuda")
    scale = torch.empty((), device="cuda")
    nchw = opt.layer == 1
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        return fn(act.data_ptr(), bits.data_ptr(), q.data_ptr(), scale.data_ptr(), opt.batch, cin,
                  h * h, int(nchw), stream)

    return call, list(act.shape)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=32, help="input spatial size")
    ap.add_argument("--cin", type=int, default=128)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="fused_conv")
    ap.add_argument("--layer", type=int, choices=(1, 2, 3), default=1,
                    help="int8_convt, quantize_int8: the generator's int8 layer")
    ap.add_argument("--out", type=str, default="", help="also write the JSON record here")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv_ablation needs a CUDA card")

    variants = KERNELS[opt.kernel][1]
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc each, all at once
        fns = dict(zip(variants, pool.map(lambda name: _build_variant(opt.kernel, name),
                                          variants)))
    launch, shape = {"fused_conv": _fused_conv_call, "int8_convt": _int8_convt_call,
                     "quantize_int8": _quantize_int8_call}[opt.kernel](opt)
    cycles = sleep_cycles_per_ms()
    record = {"kernel": opt.kernel, "shape": shape, "device": torch.cuda.get_device_name(0),
              "timing": "cuda_events", "ms": {}}
    for name, fn in fns.items():
        def call(fn=fn, name=name):
            err = launch(fn)
            if err != 0:
                raise RuntimeError(f"variant {name}: CUDA error {err}")

        record["ms"][name] = device_ms(call, opt.iters, cycles)
        print(json.dumps({"variant": name, "ms": record["ms"][name]}), flush=True)
    print(json.dumps(record), flush=True)
    if opt.out:
        with open(opt.out, "w") as f:
            json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
