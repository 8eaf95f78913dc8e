"""Device-time breakdown of a train step on the card.

``python -m eadgan_tpu_torch.utils.profiler [--pipeline celeba|pxy|
pxy_color|rp|rp_color|mnist|approximator] [--compute bf16] [--tf32]
[--chain K] [--out FILE]`` runs one pipeline's step at batch 128 (random
weights from seed 0; CelebA on synthetic faces, rp, the dSprites GAN
step with a fresh frozen aligner, on synthetic sprites, MNIST with a
fresh frozen approximator on synthetic digits, the approximator on its
own draws; f32 unless ``--compute bf16``) under
``torch.profiler`` for 5 steps after a warm-up, and reports the step
time by CUDA events, the device's busy share of the profiled window
(the union of the device operations' intervals on every stream over
wall time, :func:`busy_union_us`), the kernel launches per step, the
warp kernel's launches (by its wrapper's count and by the trace) and
share of the kernel time, and the kernels that take the most device
time.  ``--chain K`` does the same for the chained engine's step: one
eager step, the capture, then windows of K replays of the CUDA graph
(``train/chain.py``), each gathering its batch on the card from the
resident dataset as the CLIs' graph does, timed a window at a time
and profiled over one window.  ``--tf32``
allows TF32 in convolutions and matrix products (off by default, as in
``chip_smoke.py``).  Needs a CUDA card.

:func:`chrome_trace` is the trainers' ``--profile_dir``: a ``torch.profiler``
trace of a whole run, exported as a Chrome trace.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import statistics
import time

import numpy as np
import torch

from eadgan_tpu_torch.data.celeba import _synthetic_faces
from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
from eadgan_tpu_torch.data.mnist import normalize_mnist, synthetic_mnist
from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.train.chain import make_chained_step, normalize_prepare
from eadgan_tpu_torch.train.config import (
    ApproximatorConfig,
    CelebaConfig,
    MnistConfig,
    PxyConfig,
    SpritesGanConfig,
)
from eadgan_tpu_torch.train.engine import epoch_batches
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
from eadgan_tpu_torch.train.gan_mnist import init_mnist_gan_state, make_mnist_gan_step
from eadgan_tpu_torch.train.pretrain import (
    approximator_model,
    init_approximator_state,
    init_pxy_state,
    make_approximator_step,
    make_pxy_step,
    pxy_encoder,
)

__all__ = ["chrome_trace", "PIPELINES", "STEPS", "build_step", "first_batch", "step_args", "chained_replays",
           "profile_step", "busy_union_us", "sprite_warp_inputs", "mnist_warp_inputs"]

# the pipelines whose step trains on a dataset (run_epochs drives them)
PIPELINES = ("celeba", "pxy", "pxy_color", "rp", "rp_color", "mnist")
# every step: those and the approximator's, which draws its own inputs
STEPS = PIPELINES + ("approximator",)

_WARP_KERNEL = "warp_affine_kernel"


@contextlib.contextmanager
def chrome_trace(log_dir):
    """``torch.profiler`` trace of the code inside, exported as a Chrome
    trace (``trace_<pid>.json``, open it in Perfetto or chrome://tracing)
    into ``log_dir``; a no-op when ``log_dir`` is None or empty.  It
    records CPU activity, and CUDA activity when a card is present.
    CUPTI records a CUDA graph's replay as one graph launch: in a
    chained run's trace each replayed step is one ``cudaGraphLaunch`` on
    the host, with no per-kernel launch call or operator beneath it,
    while the graph's kernels still appear on the device's timeline
    (``profile_step`` counts them).  The profiler keeps every event of
    the run in memory until the export: trace a short run."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def build_step(pipeline: str, batch_size: int = 128, dtype=None, device="cuda"):
    """(state, step, data, prep) of one step of ``STEPS`` on ``device``,
    weights and draws from seed 0: ``data`` is a synthetic dataset (uint8:
    1,024 faces at batch 128, 8 batches; 1,500 sprites; float32 in
    [-1, 1]: 8 batches of MNIST digits) and ``prep`` the keyword
    arguments of ``train/engine.py::run_epochs`` that make the step's
    batches from its rows, as the pipeline's CLI passes them; both are
    None for the approximator, whose step takes no batch.  ``dtype`` is
    the models' compute type (None: float32; the pxy aligner and the
    approximator are float32 only); rp's aligner and MNIST's
    approximator are fresh ones."""
    if pipeline == "approximator":
        config = ApproximatorConfig(batch_size=batch_size)
        state = init_approximator_state(config, device=device, seed=0)
        return state, make_approximator_step(config), None, None
    if pipeline == "mnist":
        config = MnistConfig(batch_size=batch_size)
        state = init_mnist_gan_state(config, approximator_model(seed=1), device=device, seed=0,
                                     dtype=dtype)
        data = normalize_mnist(synthetic_mnist(n=8 * batch_size, seed=0)[0], config.img_size)
        prep = {"scale": 1.0, "shift": 0.0, "random_flip": False}
        return state, make_mnist_gan_step(config), data, prep
    if pipeline == "celeba":
        config = CelebaConfig(batch_size=batch_size)
        state = init_celeba_gan_state(config, device=device, seed=0, dtype=dtype)
        data = _synthetic_faces(n=8 * batch_size, size=64, seed=0)
        prep = {"scale": 1.0 / 127.5, "shift": -1.0, "random_flip": True}
        return state, make_celeba_gan_step(config), data, prep
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}: expected one of {STEPS}")
    colored = pipeline.endswith("_color")
    data = synthetic_dsprites(n_pos=5).imgs
    prep = {"scale": 1.0, "shift": 0.0, "random_flip": False}
    if pipeline.startswith("pxy"):
        config = PxyConfig.for_dataset(colored, batch_size=batch_size)
        return init_pxy_state(config, device=device, seed=0), make_pxy_step(config), data, prep
    config = SpritesGanConfig.for_dataset(colored, batch_size=batch_size)
    state = init_sprites_gan_state(
        config, pxy_encoder(colored, seed=1), device=device, seed=0, dtype=dtype
    )
    return state, make_sprites_gan_step(config), data, prep


def first_batch(data, prep: dict, batch_size: int, device="cuda") -> torch.Tensor:
    """The per-step engine's first batch of ``data`` (seed 0) on ``device``."""
    _, host = next(epoch_batches(data, batch_size, 1, **prep))
    return torch.from_numpy(host).to(device)


def step_args(data, prep, batch_size: int, device="cuda") -> tuple:
    """The step's arguments after the state: ``(first_batch,)``, or ``()``
    for a step without a dataset (the approximator's)."""
    return () if data is None else (first_batch(data, prep, batch_size, device),)


def sprite_warp_inputs(channels: int, matrices: str, device, seed: int = 0, batch: int = 128):
    """The dSprites trainers' warp inputs: (batch, 64, 64, C) synthetic
    sprites in {0, 1} (C = 3: colorized by uniform [0.5, 1) colours) and
    (batch, 3, 3) matrices, the aligner's inverse translation on pxy codes
    in [-3, 3], which moves some rows wholly outside the image
    (``"align"``, also the scorer's), or rp codes in [-1, 1] (``"rp"``).
    ``batch`` is at most 540, the 3-a-side stand-in's size."""
    from eadgan_tpu_torch.transforms import RP, code_to_matrix, inverse_affine, pxy_align_matrix

    gen = torch.Generator().manual_seed(seed)
    sprites = torch.from_numpy(synthetic_dsprites(n_pos=3).imgs)
    img = sprites[torch.randperm(len(sprites), generator=gen)[:batch], :, :, None].float()
    if channels == 3:
        img = img.repeat(1, 1, 1, 3) * (torch.rand(batch, 1, 1, 3, generator=gen) * 0.5 + 0.5)
    if matrices == "align":
        matrix = inverse_affine(pxy_align_matrix(torch.rand(batch, 3, generator=gen) * 6 - 3))
    else:
        matrix = code_to_matrix(RP, torch.rand(batch, 4, generator=gen) * 2 - 1)
    return img.contiguous().to(device), matrix.to(device)


def mnist_warp_inputs(device, seed: int = 0):
    """The MNIST step's warp inputs: (128, 32, 32, 1) synthetic digits in
    [-1, 1] and (128, 3, 3) rpqmnxy matrices on codes uniform in [-1, 1],
    as the step draws them."""
    from eadgan_tpu_torch.transforms import RPQMNXY, code_to_matrix

    gen = torch.Generator().manual_seed(seed)
    img = torch.from_numpy(normalize_mnist(synthetic_mnist(n=128, seed=seed)[0]))
    matrix = code_to_matrix(RPQMNXY, torch.rand(128, 7, generator=gen) * 2 - 1)
    return img.to(device), matrix.to(device)


def chained_replays(state, step, data, prep: dict, batch_size: int, chain: int):
    """``run()``: one window of ``chain`` steps of the chained engine's
    step, each gathering its batch on the card from ``data`` resident
    there (random rows and flips from seed 0, the same every window), as
    the CLIs' graph does (``data`` None: a step without a batch, whose
    window carries nothing but its length); the chained step's eager
    first step, its capture and the rest of that first window run here,
    so every step of ``run()`` is a replay."""
    if data is None:
        window, consts = [torch.zeros((chain, 1), dtype=torch.int32, device="cuda")], ()

        def prepare(consts, _row):
            return ()
    else:
        rng = np.random.default_rng(0)
        rows = np.stack([rng.choice(len(data), batch_size, replace=False) for _ in range(chain)])
        window = [torch.from_numpy(rows.astype(np.int32)).cuda()]
        if prep["random_flip"]:
            window.append(torch.from_numpy(rng.random((chain, batch_size)) < 0.5).cuda())
        consts = (torch.from_numpy(data).cuda(),)
        prepare = normalize_prepare(prep["scale"], prep["shift"], flip=prep["random_flip"],
                                    add_channel=data.ndim == 3)
    chained = make_chained_step(step, prepare, generators=(state.rng,))
    chained(state, consts, *window)

    def run():
        return chained(state, consts, *window)

    return run


def busy_union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals: the device's
    busy time, where two streams' overlapping operations count once."""
    total = 0.0
    start = end = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if end is not None:
        total += end - start
    return total


def profile_step(pipeline: str = "celeba", batch_size: int = 128, steps: int = 5, warmup: int = 5,
                 dtype=None, chain: int = 0):
    """Returns (summary dict, profiler table text); ``dtype`` is the
    models' compute type (None: float32); ``chain`` > 0 profiles the
    replays of the chained step, ``chain`` a window."""
    from torch.profiler import ProfilerActivity, profile

    state, step, data, prep = build_step(pipeline, batch_size, dtype)
    args = step_args(data, prep, batch_size)
    for _ in range(warmup):
        step(state, *args)
    torch.cuda.synchronize()

    if chain:
        run, per_run, runs = chained_replays(state, step, data, prep, batch_size, chain), chain, 3
        steps = chain
    else:
        run, per_run, runs = (lambda: step(state, *args)), 1, 20
    events = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        run()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events) / per_run

    warp_before = stn_cuda.launch_count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps // per_run):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    warp_launches = stn_cuda.launch_count - warp_before
    # kernels only: a CPU op's device time repeats its kernels', and a
    # user annotation (Optimizer.step) spans kernels already counted
    per_kernel = collections.defaultdict(lambda: [0, 0.0])  # name -> [calls, us]
    intervals = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            e, "is_user_annotation", False
        ):
            per_kernel[e.name][0] += 1
            per_kernel[e.name][1] += e.time_range.elapsed_us()
            intervals.append((e.time_range.start, e.time_range.end))
    # a trace that shows no kernel (CUPTI missing graph replays) says so
    # with None, never with a zero
    seen = bool(per_kernel) or None
    device_ms = seen and sum(us for _, us in per_kernel.values()) / 1e3
    warp_us = seen and sum(us for name, (_, us) in per_kernel.items() if _WARP_KERNEL in name)
    warp_calls = seen and sum(calls for name, (calls, _) in per_kernel.items() if _WARP_KERNEL in name)
    top = sorted(per_kernel.items(), key=lambda kv: kv[1][1], reverse=True)[:15]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "pipeline": pipeline,
        "batch_size": batch_size,
        "compute": "bf16" if dtype == torch.bfloat16 else "f32",
        "tf32": torch.backends.cudnn.allow_tf32,
        "chain": chain or 1,
        "step_ms_cuda_events": step_ms,
        "profiled_steps": steps,
        "profiled_wall_ms": wall_ms,
        "kernels_in_trace": bool(seen),
        "device_kernel_ms": device_ms,
        "device_busy_share": seen and busy_union_us(intervals) / 1e3 / wall_ms,
        "kernel_launches_per_step": seen and sum(calls for calls, _ in per_kernel.values()) / steps,
        "warp_launches_per_step": warp_launches / steps,
        "warp_kernels_in_trace_per_step": seen and warp_calls / steps,
        "warp_device_ms_per_step": seen and warp_us / 1e3 / steps,
        "warp_share_of_kernel_time": seen and warp_us / 1e3 / device_ms,
        "top_kernels": [
            {"name": name[:120], "calls_per_step": calls / steps,
             "device_ms_per_step": us / 1e3 / steps}
            for name, (calls, us) in top
        ],
    }
    return summary, prof.key_averages().table(row_limit=40)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=STEPS, default="celeba",
                        help="the train step to profile")
    parser.add_argument("--compute", choices=["bf16", "f32"], default="f32", help="model compute type")
    parser.add_argument("--tf32", action="store_true", help="allow TF32 in convs and matmuls")
    parser.add_argument("--chain", type=int, default=0,
                        help="profile a window of this many replays of the captured step")
    parser.add_argument("--out", type=str, default="", help="also write the profiler table here")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the step profile needs the card")
    torch.backends.cudnn.allow_tf32 = opt.tf32
    torch.backends.cuda.matmul.allow_tf32 = opt.tf32
    summary, table = profile_step(
        opt.pipeline, dtype=torch.bfloat16 if opt.compute == "bf16" else None, chain=opt.chain
    )
    if opt.out:
        os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(json.dumps(summary, indent=1) + "\n" + table)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
