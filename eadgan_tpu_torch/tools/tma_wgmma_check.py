"""Step-by-step bring-up checks of the fused conv kernel's TMA and wgmma
building blocks, on the card.

``python -m eadgan_tpu_torch.tools.tma_wgmma_check`` builds
``csrc/bringup/tma_wgmma_check.cu`` (which includes the kernel's source,
so it checks the kernel's own helpers) with nvcc into ``_build/``, then
runs three steps, each held against PyTorch, and stops at the first that
fails:

1. ``gemm``: a plain (M, K) x (K, N) bf16 product through the kernel's
   descriptors, its wgmma instruction and its accumulator fragment
   layout, against the float32 product (TF32 off), for each N tile the
   kernel has (64, 128, 256).  B's descriptor offsets are also tried
   swapped, so a wrong pair names the right one.
2. ``box``: one A box of the conv's own x tensor map (64 channels x every
   other column and row, negative and past-the-edge starts, a Cin that is
   no multiple of 64), read back as TMA wrote it and unswizzled, against
   the same gather in PyTorch, bit for bit.
3. ``conv``: the persistent warp-specialised kernel against its plain
   version (``ops.fused_conv.mismatch``) at a small and the full-width
   shape.

A wrong descriptor gives plausible numbers, not a crash; these steps
find it before a long run does.  It prints one JSON line per case and
exits non-zero when a step fails.  It needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from eadgan_tpu_torch.ops import _build

__all__ = ["main", "swizzle_128b_chunk", "unswizzle_128b", "expected_box"]

SOURCE = _build.CSRC / "bringup" / "tma_wgmma_check.cu"
KERNEL_SOURCES = [_build.CSRC / "fused_conv_lrelu.cu", _build.CSRC / "hopper.cuh"]
B_OFFSETS = (8192, 1024)  # the kernel's B descriptor: leading, stride byte offsets


def swizzle_128b_chunk(row: int, chunk: int) -> int:
    """Where TMA's 128-byte swizzle puts 16-byte ``chunk`` of ``row``."""
    return chunk ^ (row % 8)


def unswizzle_128b(raw: torch.Tensor) -> torch.Tensor:
    """(rows * 128,) uint8 as TMA wrote it -> (rows, 64) bf16 in logical order."""
    rows = raw.numel() // 128
    chunks = raw.reshape(rows, 8, 16)
    r = torch.arange(rows, device=raw.device).unsqueeze(1)
    q = torch.arange(8, device=raw.device).unsqueeze(0)
    logical = chunks[r, q ^ (r % 8)]
    return logical.reshape(rows, 128).view(torch.bfloat16)


def expected_box(x: torch.Tensor, c0: int, c1: int, c2: int, c3: int) -> torch.Tensor:
    """The A box the conv's x map gives at (channel c0, column c1, row c2,
    image c3): (8 rows x 16 columns, 64 channels), every other column and
    row, zero outside x."""
    _, h, w, cin = x.shape
    out = torch.zeros(8, 16, 64, dtype=x.dtype, device=x.device)
    for i in range(8):
        for j in range(16):
            ih, iw = c2 + 2 * i, c1 + 2 * j
            if 0 <= ih < h and 0 <= iw < w:
                n = max(0, min(64, cin - c0))
                out[i, j, :n] = x[c3, ih, iw, c0:c0 + n]
    return out.reshape(128, 64)


def _library() -> ctypes.CDLL:
    path, log, _ = _build.build([SOURCE], "libeadgan_check", hashed=KERNEL_SOURCES)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "warning" in line.lower():
            print(f"ptxas: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.eadgan_check_gemm.argtypes = (p, p, p, i, i, i, i, i, i, p)
    lib.eadgan_check_box.argtypes = (p, p, i, i, i, i, i, i, i, p)
    return lib


def _call(fn, *args) -> None:
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    torch.cuda.synchronize()


def check_gemm(lib, gen) -> bool:
    ok = True
    m, k = 256, 256
    for bn in (64, 128, 256):
        n = 2 * bn
        a = torch.randn(m, k, generator=gen).to("cuda", torch.bfloat16)
        b = torch.randn(k, n, generator=gen).to("cuda", torch.bfloat16)
        ref = a.float() @ b.float()
        errs = {}
        for lbo, sbo in (B_OFFSETS, B_OFFSETS[::-1]):
            c = torch.full((m, n), float("nan"), device="cuda")
            _call(lib.eadgan_check_gemm, a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, bn,
                  lbo, sbo)
            errs[f"lbo{lbo}_sbo{sbo}"] = ((c - ref).abs().max() / ref.abs().max()).item()
        good = errs[f"lbo{B_OFFSETS[0]}_sbo{B_OFFSETS[1]}"] <= 1e-5
        ok &= good
        print(json.dumps({"step": "gemm", "bn": bn, "rel_err": errs, "ok": good}), flush=True)
    return ok


def check_box(lib, gen) -> bool:
    ok = True
    batch, h, cin = 2, 10, 72
    x = torch.randn(batch, h, h, cin, generator=gen).to("cuda", torch.bfloat16)
    for coords in ((0, -1, -1, 0), (64, 1, 2, 1), (0, 7, 5, 1), (64, -1, 3, 0)):
        raw = torch.zeros(16384, dtype=torch.uint8, device="cuda")
        _call(lib.eadgan_check_box, x.data_ptr(), raw.data_ptr(), batch, h, cin, *coords)
        got = unswizzle_128b(raw)
        want = expected_box(x, *coords)
        good = torch.equal(got, want)
        ok &= good
        print(json.dumps({"step": "box", "coords": coords, "mismatched": int((got != want).sum()),
                          "ok": good}), flush=True)
    return ok


def check_conv(gen) -> bool:
    from eadgan_tpu_torch.ops.fused_conv import fused_conv_lrelu_plain, mismatch
    from eadgan_tpu_torch.ops.fused_conv_cuda import fused_conv_lrelu_cuda

    ok = True
    for batch, hw, cin, cout in ((2, 8, 16, 32), (2, 32, 128, 256)):
        x = torch.randn(batch, hw, hw, cin, generator=gen).to("cuda", torch.bfloat16)
        w = (0.05 * torch.randn(4, 4, cin, cout, generator=gen)).to("cuda", torch.bfloat16)
        b = torch.randn(cout, generator=gen).to("cuda", torch.bfloat16)
        diff = mismatch(fused_conv_lrelu_cuda(x, w, b), fused_conv_lrelu_plain(x, w, b))
        good = diff["elem"] <= 1.0
        ok &= good
        print(json.dumps({"step": "conv", "shape": [batch, hw, cin, cout], **diff, "ok": good}),
              flush=True)
    return ok


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tma_wgmma_check needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = _library()
    gen = torch.Generator().manual_seed(0)
    for name, step in (("gemm", lambda: check_gemm(lib, gen)), ("box", lambda: check_box(lib, gen)),
                       ("conv", lambda: check_conv(gen))):
        if not step():
            print(f"tma_wgmma_check: step {name} failed", file=sys.stderr, flush=True)
            return 1
    print("tma_wgmma_check: all steps passed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
