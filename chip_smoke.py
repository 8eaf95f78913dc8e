#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``eadgan_tpu_torch``) on one
NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (nvcc) and runs five phases, failing with
a non-zero exit on the first that fails:

1. environment: card name and power limit, torch/CUDA versions, TF32
   switched off, and the build of every kernel from ``csrc/``;
2. each kernel against its plain PyTorch version on the card, over the
   cases of ``tests/test_stn_pallas.py`` and the CelebA shape, f32 and
   bf16 (one JSON line per case);
3. the CelebA train step on the CPU and on the card from the same
   weights and draws, three steps at the low-lr config;
4. the trainer, ``python -m eadgan_tpu_torch.cli.celeba --batch_size 128
   --max_steps 20``, on synthetic data, with the kernels' launch counts
   read around it;
5. timing with CUDA events: the B=128 step, and each kernel beside its
   bound, its plain version and the library call that computes the same
   function.

Its last lines are the ``{"kernels": [...]}`` record, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM (NVIDIA data sheet), used for bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# --- timing helpers ---------------------------------------------------------


def sleep_cycles_per_ms(torch) -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond."""
    cycles = 20_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(torch, fn, iters: int, cycles_per_ms: float, repeats: int = 5) -> float:
    """Median device time of one ``fn()`` call.  Each sample first parks
    the stream behind a spin kernel long enough for the host to enqueue
    all ``iters`` calls, so the events bracket back-to-back device work
    only, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms + 5.0)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def host_ms_per_call(torch, fn, iters: int) -> float:
    """Host clock per call of back-to-back ``fn()``, ending in a
    synchronize: what a caller pays, launch overhead included."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


# --- phases -----------------------------------------------------------------


def phase_environment(torch):
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
        flush=True,
    )
    print(
        "tf32: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}",
        flush=True,
    )
    from eadgan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    load_s = time.perf_counter() - t0
    print(f"kernel library {_build.LIBRARY.path.name}: built in {_build.LIBRARY.build_seconds} s "
          f"(load {load_s:.2f} s)", flush=True)
    for line in _build.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


def phase_kernel_vs_plain(torch):
    """Returns the kernel's max abs error at the main path's shape (f32)."""
    from eadgan_tpu_torch.ops.stn import warp_affine_plain
    from eadgan_tpu_torch.ops.stn_cuda import warp_affine_cuda
    from eadgan_tpu_torch.transforms import RP, RPQMNXY, RPQXY, code_to_matrix

    cases = [
        # name, shape, family, code scale, padding, dtype
        ("c1", (4, 64, 64, 1), RP, 1.0, "border", torch.float32),
        ("c1", (4, 64, 64, 1), RP, 1.0, "zeros", torch.float32),
        ("c3", (4, 64, 64, 3), RP, 1.0, "border", torch.float32),
        ("c3", (4, 64, 64, 3), RP, 1.0, "zeros", torch.float32),
        ("non_square", (2, 32, 64, 3), RP, 1.0, "border", torch.float32),
        ("non_square", (2, 32, 64, 3), RP, 1.0, "zeros", torch.float32),
        ("odd_height", (2, 17, 16, 1), RP, 1.0, "border", torch.float32),
        ("extreme_x3", (2, 16, 16, 1), RPQMNXY, 3.0, "border", torch.float32),
        ("extreme_x3", (2, 16, 16, 1), RPQMNXY, 3.0, "zeros", torch.float32),
        ("even_n", (6, 64, 64, 1), RP, 1.0, "border", torch.float32),
        ("celeba_main", (128, 64, 64, 3), RPQXY, 1.0, "border", torch.float32),
        ("celeba_main", (128, 64, 64, 3), RPQXY, 1.0, "zeros", torch.float32),
        ("c1", (4, 64, 64, 1), RP, 1.0, "zeros", torch.bfloat16),
        ("extreme_x3", (2, 16, 16, 1), RPQMNXY, 3.0, "border", torch.bfloat16),
        ("celeba_main", (128, 64, 64, 3), RPQXY, 1.0, "border", torch.bfloat16),
    ]
    gen = torch.Generator().manual_seed(0)
    for name, shape, family, scale, pad, dtype in cases:
        img = torch.rand(shape, generator=gen).to("cuda", dtype)
        code = (torch.rand(shape[0], family.n_affine, generator=gen) * 2 - 1) * scale
        matrix = code_to_matrix(family, code.cuda())
        got = warp_affine_cuda(img, matrix, pad)
        ref = warp_affine_plain(img, matrix, pad)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == img.shape, f"{name}: dtype/shape")
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        emit({"case": name, "shape": list(shape), "padding": pad,
              "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err, "tol": tol})
        check(math.isfinite(err) and err <= tol, f"kernel vs plain {name} {pad} {dtype}: {err}")
        if name == "celeba_main" and pad == "border" and dtype == torch.float32:
            main_err = err

    # gradients through the kernel's autograd wrapper equal the plain ones
    img = torch.rand((2, 16, 16, 3), generator=gen).cuda()
    code = (torch.rand(2, 5, generator=gen) * 2 - 1).cuda()
    grads = []
    for fn in (warp_affine_cuda, warp_affine_plain):
        i = img.clone().requires_grad_(True)
        c = code.clone().requires_grad_(True)
        (fn(i, code_to_matrix(RPQXY, c), "border") ** 2).sum().backward()
        grads.append((i.grad, c.grad))
    for a, b in zip(*grads):
        err = (a - b).abs().max().item()
        check(err <= 1e-4, f"warp gradient through the kernel wrapper: {err}")
    return main_err


def phase_step_parity(torch):
    import numpy as np

    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

    batch = 4
    config = CelebaConfig(batch_size=batch, g_lr=1e-4, d_lr=2e-5, info_lr=2e-5)
    step = make_celeba_gan_step(config)
    states = {dev: init_celeba_gan_state(config, device=dev, seed=0) for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    imgs = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(np.float32)
    losses = {"cpu": [], "cuda": []}
    for s in range(3):
        fixed = {
            "z": rng.standard_normal((batch, 200)).astype(np.float32),
            "sampled_labels": rng.integers(0, 10, batch),
            "code": rng.uniform(-1, 1, (batch, 8)).astype(np.float32),
        }
        for dev, state in states.items():
            _, m = step(state, torch.from_numpy(imgs).to(dev), fixed)
            losses[dev].append({k: float(v) for k, v in m.items()})
        rtol = 1e-3 if s == 0 else 3e-2
        for k, ref in losses["cpu"][s].items():
            got = losses["cuda"][s][k]
            rel = abs(got - ref) / max(abs(ref), 1e-12)
            emit({"step_parity": s, "loss": k, "cpu": ref, "cuda": got, "rel": rel, "rtol": rtol})
            check(math.isfinite(got) and rel <= rtol, f"step {s} {k}: cpu {ref} cuda {got}")


def phase_trainer(torch):
    from eadgan_tpu_torch.ops import stn_cuda

    max_steps = 20
    with tempfile.TemporaryDirectory(prefix="eadgan_smoke_") as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        argv = [
            "eadgan_tpu_torch.cli.celeba", "--batch_size", "128", "--max_steps", str(max_steps),
            "--data_dir", tmp, "--out_dir", os.path.join(tmp, "images"), "--ckpt_dir", tmp,
            "--jsonl", jsonl,
        ]
        saved_argv = sys.argv
        os.environ["EADGAN_PLATFORM"] = "cuda"
        sys.argv = argv
        stn_cuda.reset_launch_count()  # counts from here read the main path only
        t0 = time.perf_counter()
        try:
            runpy.run_module("eadgan_tpu_torch.cli.celeba", run_name="__main__", alter_sys=True)
        finally:
            sys.argv = saved_argv
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = stn_cuda.launch_count

        records = [json.loads(line) for line in open(jsonl)]
        check(len(records) == max_steps, f"trainer logged {len(records)} steps")
        for r in records:
            check(math.isfinite(r["d_loss"]) and math.isfinite(r["g_loss"]), f"loss {r}")
        ckpt = torch.load(os.path.join(tmp, "checkpoint_0.tar"), weights_only=True)
        check(
            set(ckpt) == {"discriminator_state_dict", "generator_state_dict", "epoch", "batches_done"},
            f"checkpoint keys {sorted(ckpt)}",
        )
        for name in ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 9)]:
            check(os.path.isfile(os.path.join(tmp, "images", name, "0.png")), f"grid {name}")
        # the host clock between consecutive log records is one loop step
        ts = [r["t"] for r in records]
        loop_ms = statistics.median(b - a for a, b in zip(ts[2:], ts[3:])) * 1e3
    check(launches >= max_steps, f"warp kernel launched {launches} times in {max_steps} steps")
    emit({"trainer": "eadgan_tpu_torch.cli.celeba", "batch_size": 128, "steps": max_steps,
          "wall_s": wall, "loop_step_ms_host_clock": loop_ms, "warp_launches": launches,
          "last": records[-1]})
    return {"warp_affine": launches}


def phase_timing(torch, warp_max_abs_err):
    import torch.nn.functional as F

    from eadgan_tpu_torch.ops.stn import warp_affine_plain
    from eadgan_tpu_torch.ops.stn_cuda import warp_affine_cuda
    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
    from eadgan_tpu_torch.transforms import RPQXY, code_to_matrix

    # the f32 train step at B=128
    batch = 128
    config = CelebaConfig(batch_size=batch)
    state = init_celeba_gan_state(config, device="cuda", seed=0)
    step = make_celeba_gan_step(config)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.rand((batch, 64, 64, 3), generator=gen, device="cuda") * 2 - 1
    for _ in range(5):
        step(state, imgs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    t0 = time.perf_counter()
    for _ in range(30):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, metrics = step(state, imgs)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 30
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    check(all(math.isfinite(float(v)) for v in metrics.values()), f"step metrics {metrics}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    emit({"step": "celeba_f32", "batch_size": batch, "median_ms_cuda_events": step_ms,
          "mean_ms_host_clock": host_ms, "img_per_s": batch / step_ms * 1e3,
          "peak_mem_gib": peak_gib, "samples": 30})

    # the warp at the main path's shape
    n, h, w, c = 128, 64, 64, 3
    img = torch.rand((n, h, w, c), generator=gen, device="cuda") * 2 - 1
    code = torch.rand((n, 8), generator=gen, device="cuda") * 2 - 1
    matrix = code_to_matrix(RPQXY, code[:, :5])
    theta = matrix[:, :2].contiguous()
    img_nchw = img.permute(0, 3, 1, 2)  # channels_last view, no copy

    def library():
        grid = F.affine_grid(theta, (n, c, h, w), align_corners=False)
        return F.grid_sample(img_nchw, grid, padding_mode="border", align_corners=False)

    # the yardstick computes the same function; its own grid arithmetic
    # rounds differently (measured 1.6e-5 on an H100), hence 1e-4
    lib_err = (library().permute(0, 2, 3, 1) - warp_affine_cuda(img, matrix)).abs().max().item()
    check(lib_err <= 1e-4, f"library call disagrees with the kernel: {lib_err}")
    cpm = sleep_cycles_per_ms(torch)
    kernel_ms = device_ms(torch, lambda: warp_affine_cuda(img, matrix), 200, cpm)
    plain_ms = device_ms(torch, lambda: warp_affine_plain(img, matrix), 20, cpm)
    library_ms = device_ms(torch, library, 100, cpm)
    wrapper_ms = host_ms_per_call(torch, lambda: warp_affine_cuda(img, matrix), 200)
    elem = n * h * w * c
    bytes_moved = 2 * elem * 4 + n * 6 * 4  # image read once, output written once, theta
    flops = elem * 7 + n * h * w * 25  # 4-tap weighted sum per element, coordinates per pixel
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    kernel = {
        "name": "warp_affine",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/warp_affine.cu",
        "replaces": "eadgan_tpu/ops/stn_pallas.py:50",
        "also_replaces": "eadgan_tpu/ops/stn_pallas.py:116",
        "shape": [n, h, w, c],
        "launches": None,
        "max_abs_err": warp_max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": library_ms,
        "wrapper_call_ms_host_clock": wrapper_ms,
    }
    emit({"warp_timing": kernel, "library_vs_kernel_max_abs_err": lib_err})
    return [kernel]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    print("== phase 1: environment and kernel build", flush=True)
    phase_environment(torch)
    print("== phase 2: kernels vs plain versions on the card", flush=True)
    warp_err = phase_kernel_vs_plain(torch)
    print("== phase 3: CelebA step, CPU vs CUDA", flush=True)
    phase_step_parity(torch)
    print("== phase 4: trainer (main path)", flush=True)
    launches = phase_trainer(torch)
    print("== phase 5: timing", flush=True)
    kernels = phase_timing(torch, warp_err)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
