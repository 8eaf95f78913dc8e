"""Device-time breakdown of the CelebA train step on the card.

``python -m eadgan_tpu_torch.utils.profiler [--compute bf16] [--tf32]
[--out FILE]`` runs the step at batch 128 (random weights from seed 0,
random images; f32 unless ``--compute bf16``) under ``torch.profiler``
for 5 steps after a warm-up, and reports the step time by CUDA events,
the device's busy share of the profiled window (summed kernel time over
wall time) and the kernels that take the most device time.  ``--tf32``
allows TF32 in convolutions and matrix products (off by default, as in
``chip_smoke.py``).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import time

import torch

from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

__all__ = ["profile_celeba_step"]


def profile_celeba_step(batch_size: int = 128, steps: int = 5, warmup: int = 5, dtype=None):
    """Returns (summary dict, profiler table text); ``dtype`` is the
    models' compute type (None: float32)."""
    from torch.profiler import ProfilerActivity, profile

    config = CelebaConfig(batch_size=batch_size)
    state = init_celeba_gan_state(config, device="cuda", seed=0, dtype=dtype)
    step = make_celeba_gan_step(config)
    gen = torch.Generator(device="cuda").manual_seed(1)
    imgs = torch.rand((batch_size, 64, 64, 3), generator=gen, device="cuda") * 2 - 1
    for _ in range(warmup):
        step(state, imgs)
    torch.cuda.synchronize()

    events = []
    for _ in range(20):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        step(state, imgs)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a CPU op's device time repeats its kernels', and a
    # user annotation (Optimizer.step) spans kernels already counted
    per_kernel = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, us]
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            e, "is_user_annotation", False
        ):
            per_kernel[e.name][0] += 1
            per_kernel[e.name][1] += e.time_range.elapsed_us()
    device_ms = sum(us for _, us in per_kernel.values()) / 1e3
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1], reverse=True)[:15]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "batch_size": batch_size,
        "compute": "bf16" if dtype == torch.bfloat16 else "f32",
        "tf32": torch.backends.cudnn.allow_tf32,
        "step_ms_cuda_events": step_ms,
        "profiled_steps": steps,
        "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "kernel_launches_per_step": sum(calls for calls, _ in per_kernel.values()) / steps,
        "top_kernels": [
            {"name": name[:120], "calls_per_step": calls / steps,
             "device_ms_per_step": us / 1e3 / steps}
            for name, (calls, us) in top
        ],
    }
    return summary, prof.key_averages().table(row_limit=40)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--compute", choices=["bf16", "f32"], default="f32", help="model compute type")
    parser.add_argument("--tf32", action="store_true", help="allow TF32 in convs and matmuls")
    parser.add_argument("--out", type=str, default="", help="also write the profiler table here")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the step profile needs the card")
    torch.backends.cudnn.allow_tf32 = opt.tf32
    torch.backends.cuda.matmul.allow_tf32 = opt.tf32
    summary, table = profile_celeba_step(dtype=torch.bfloat16 if opt.compute == "bf16" else None)
    if opt.out:
        os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(json.dumps(summary, indent=1) + "\n" + table)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
