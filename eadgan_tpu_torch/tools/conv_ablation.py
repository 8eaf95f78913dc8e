"""Where the fused conv kernel's time goes: the kernel timed whole and
with one part stubbed out, on the card.

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

Only ``full`` computes the function; the others time what is left.  It
prints one JSON line per variant and the record last, and writes the
record to ``--out`` when given.  It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from concurrent.futures import ThreadPoolExecutor

import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.utils.timing import device_ms, sleep_cycles_per_ms

__all__ = ["main", "VARIANTS", "variant_source"]

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


def variant_source(name: str, source: str) -> str:
    """The kernel's ``source`` with variant ``name``'s parts stubbed out;
    raises if an anchor is no longer in the source exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: anchor {old!r} is not in the kernel once")
        source = source.replace(old, new)
    return source


def _build_variant(name: str):
    directory = _build.BUILD_DIR / "ablation"
    directory.mkdir(parents=True, exist_ok=True)
    src = directory / f"fused_conv_{name}.cu"
    src.write_text(variant_source(name, SOURCE.read_text()))
    path, _, _ = _build.build([src], f"libeadgan_ablation_{name}")
    lib = ctypes.CDLL(str(path))
    fn = lib.eadgan_fused_conv_lrelu_bf16
    fn.argtypes = _build._SIGNATURES["eadgan_fused_conv_lrelu_bf16"]
    fn.restype = ctypes.c_int
    return fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=32, help="input spatial size")
    ap.add_argument("--cin", type=int, default=128)
    ap.add_argument("--cout", type=int, default=256)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--out", type=str, default="", help="also write the JSON record here")
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv_ablation needs a CUDA card")

    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc each, all at once
        fns = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    gen = torch.Generator().manual_seed(0)
    shape = (opt.batch, opt.hw, opt.hw, opt.cin)
    x = torch.randn(shape, generator=gen).to("cuda", torch.bfloat16)
    w = (0.05 * torch.randn(4, 4, opt.cin, opt.cout, generator=gen)).to("cuda", torch.bfloat16)
    b = (0.01 * torch.randn(opt.cout, generator=gen)).to("cuda", torch.bfloat16)
    out = torch.empty(opt.batch, opt.hw // 2, opt.hw // 2, opt.cout, dtype=torch.bfloat16,
                      device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    cycles = sleep_cycles_per_ms()
    record = {"shape": [*shape, opt.cout], "device": torch.cuda.get_device_name(0),
              "timing": "cuda_events", "ms": {}}
    for name, fn in fns.items():
        def call(fn=fn, name=name):
            err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), opt.batch,
                     opt.hw, opt.cin, opt.cout, 0.1, stream)
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
