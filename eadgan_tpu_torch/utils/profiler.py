"""Device-time breakdown of a train step on the card.

``python -m eadgan_tpu_torch.utils.profiler [--pipeline celeba|rp]
[--compute bf16] [--tf32] [--out FILE]`` runs one pipeline's step at
batch 128 (random weights from seed 0; CelebA on random images, rp, the
gray dSprites GAN step with a fresh frozen aligner, on synthetic sprites;
f32 unless ``--compute bf16``) under ``torch.profiler`` for 5 steps after
a warm-up, and reports the step time by CUDA events, the device's busy
share of the profiled window (summed kernel time over wall time), the
kernel launches per step, the warp kernel's launches and share of the
kernel time, and the kernels that take the most device time.  ``--tf32``
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

import numpy as np
import torch

from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.train.config import CelebaConfig, SpritesGanConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
from eadgan_tpu_torch.train.pretrain import pxy_encoder

__all__ = ["build_step", "profile_step", "sprite_warp_inputs"]

_WARP_KERNEL = "warp_affine_kernel"


def build_step(pipeline: str, batch_size: int = 128, dtype=None):
    """(state, step, images) of one pipeline at ``batch_size`` on the
    card, weights from seed 0."""
    device = "cuda"
    if pipeline == "celeba":
        config = CelebaConfig(batch_size=batch_size)
        state = init_celeba_gan_state(config, device=device, seed=0, dtype=dtype)
        gen = torch.Generator(device=device).manual_seed(1)
        imgs = torch.rand((batch_size, 64, 64, 3), generator=gen, device=device) * 2 - 1
        return state, make_celeba_gan_step(config), imgs
    if pipeline in ("rp", "rp_color"):
        colored = pipeline == "rp_color"
        config = SpritesGanConfig.for_dataset(colored, batch_size=batch_size)
        state = init_sprites_gan_state(
            config, pxy_encoder(colored, seed=1), device=device, seed=0, dtype=dtype
        )
        sprites = synthetic_dsprites(n_pos=3).imgs
        idx = np.random.default_rng(0).choice(len(sprites), batch_size, replace=len(sprites) < batch_size)
        imgs = torch.from_numpy(sprites[idx][..., None].astype(np.float32)).to(device)
        return state, make_sprites_gan_step(config), imgs
    raise ValueError(f"unknown pipeline {pipeline!r}: expected celeba, rp or rp_color")


def sprite_warp_inputs(channels: int, matrices: str, device, seed: int = 0):
    """The dSprites trainers' warp inputs: (128, 64, 64, C) synthetic
    sprites in {0, 1} (C = 3: colorized by uniform [0.5, 1) colours) and
    (128, 3, 3) matrices, the aligner's inverse translation on pxy codes
    in [-3, 3], which moves some rows wholly outside the image
    (``"align"``), or rp codes in [-1, 1] (``"rp"``)."""
    from eadgan_tpu_torch.transforms import RP, code_to_matrix, inverse_affine, pxy_align_matrix

    gen = torch.Generator().manual_seed(seed)
    sprites = torch.from_numpy(synthetic_dsprites(n_pos=3).imgs)
    img = sprites[torch.randperm(len(sprites), generator=gen)[:128], :, :, None].float()
    if channels == 3:
        img = img.repeat(1, 1, 1, 3) * (torch.rand(128, 1, 1, 3, generator=gen) * 0.5 + 0.5)
    if matrices == "align":
        matrix = inverse_affine(pxy_align_matrix(torch.rand(128, 3, generator=gen) * 6 - 3))
    else:
        matrix = code_to_matrix(RP, torch.rand(128, 4, generator=gen) * 2 - 1)
    return img.contiguous().to(device), matrix.to(device)


def profile_step(pipeline: str = "celeba", batch_size: int = 128, steps: int = 5, warmup: int = 5,
                 dtype=None):
    """Returns (summary dict, profiler table text); ``dtype`` is the
    models' compute type (None: float32)."""
    from torch.profiler import ProfilerActivity, profile

    state, step, imgs = build_step(pipeline, batch_size, dtype)
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

    warp_before = stn_cuda.launch_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, imgs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    warp_launches = stn_cuda.launch_count - warp_before
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
    warp_us = sum(us for name, (_, us) in per_kernel.items() if _WARP_KERNEL in name)
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1], reverse=True)[:15]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "pipeline": pipeline,
        "batch_size": batch_size,
        "compute": "bf16" if dtype == torch.bfloat16 else "f32",
        "tf32": torch.backends.cudnn.allow_tf32,
        "step_ms_cuda_events": step_ms,
        "profiled_steps": steps,
        "profiled_wall_ms": wall_ms,
        "device_kernel_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if wall_ms else None,
        "kernel_launches_per_step": sum(calls for calls, _ in per_kernel.values()) / steps,
        "warp_launches_per_step": warp_launches / steps,
        "warp_device_ms_per_step": warp_us / 1e3 / steps,
        "warp_share_of_kernel_time": warp_us / 1e3 / device_ms if device_ms else None,
        "top_kernels": [
            {"name": name[:120], "calls_per_step": calls / steps,
             "device_ms_per_step": us / 1e3 / steps}
            for name, (calls, us) in top
        ],
    }
    return summary, prof.key_averages().table(row_limit=40)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=["celeba", "rp", "rp_color"], default="celeba",
                        help="the train step to profile")
    parser.add_argument("--compute", choices=["bf16", "f32"], default="f32", help="model compute type")
    parser.add_argument("--tf32", action="store_true", help="allow TF32 in convs and matmuls")
    parser.add_argument("--out", type=str, default="", help="also write the profiler table here")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the step profile needs the card")
    torch.backends.cudnn.allow_tf32 = opt.tf32
    torch.backends.cuda.matmul.allow_tf32 = opt.tf32
    summary, table = profile_step(
        opt.pipeline, dtype=torch.bfloat16 if opt.compute == "bf16" else None
    )
    if opt.out:
        os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(json.dumps(summary, indent=1) + "\n" + table)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
