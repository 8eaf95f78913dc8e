"""Shared CLI plumbing: flag definitions, the compute type, the float32
matmul mode, resume, the SIGTERM guard and the rank environment.

PyTorch counterpart of ``eadgan_tpu/cli/common.py``.  The device is
chosen by ``utils.device.platform_device`` (``EADGAN_PLATFORM=cpu`` for
the CPU, the CUDA card otherwise).  Every trainer CLI first calls
:func:`disable_tf32`, so its float32 convs and matrix products run in
full float32, the mode the CPU-vs-card gates check (torch's default lets
cuDNN convolve in TF32), then takes its device from
:func:`init_multiprocess`, which joins a multi-process gang when the
rank environment names one (``--data_parallel``, ``parallel/``) and
refuses the configurations the JAX CLIs refuse.  It arms the SIGTERM
guard (:func:`setup_preemption`, ``--preempt_save on`` by default),
passes ``--watchdog``, ``--profile_dir``, ``--data_parallel`` and
``--zero_opt`` to ``run_epochs``, saves its final state collectively
(``checkpoint.save_train_state_sync``) and ends with
:func:`exit_if_preempted`.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable

import torch

from eadgan_tpu_torch.parallel import multihost
from eadgan_tpu_torch.train.checkpoint import restore_latest, restore_train_state

__all__ = [
    "add_adam_args",
    "add_run_args",
    "disable_tf32",
    "exit_if_preempted",
    "init_multiprocess",
    "maybe_resume",
    "resolve_compute_dtype",
    "setup_preemption",
]


def _gang_request() -> str:
    """The variable that names a multi-process run (``WORLD_SIZE`` > 1,
    ``EADGAN_MP_NUM_PROCESSES`` > 1, or a coordinator address without
    a world size of 1), as ``NAME=value``; empty when there is none."""
    if not multihost.wants_gang():
        return ""
    for name in ("EADGAN_MP_NUM_PROCESSES", "WORLD_SIZE", *multihost._CLUSTER_ENV_VARS,
                 "MASTER_ADDR"):
        if os.environ.get(name):
            return f"{name}={os.environ[name]}"
    return "a rank environment"


def init_multiprocess(opt, pick_device: Callable[[], torch.device]) -> torch.device:
    """Join the gang a rank environment names and return this rank's
    device: ``pick_device()`` (the CLI's ``utils.device.platform_device``)
    when there is none, else the rank's card on a CUDA machine.

    ``cli.supervise --ranks N`` hands each gang member the ``EADGAN_MP_*``
    rank triple, a cluster scheduler may set a coordinator address
    instead, and ``torchrun`` sets ``WORLD_SIZE``, ``RANK`` and
    ``MASTER_ADDR``; ``parallel.initialize`` reads any of them and joins
    one process group, one rank per card.  The JAX CLIs' refusals hold,
    raised as ``SystemExit`` before the card is touched:

    * a multi-process run without ``--data_parallel``: each rank would
      train an independent model against the same checkpoint paths (a
      trainer without the flag, the approximator, always refuses);
    * ``--zero_opt`` in a multi-process run: the cadence checkpoints are
      written by rank 0 alone, which cannot gather moments sliced over
      the ranks (a library loop that routes every save through
      ``parallel.save_on_coordinator`` can);

    so does a rank environment that names a gang without its coordinator,
    world size or rank.  A single-process ``--data_parallel`` run joins a
    group of one (``parallel.join_local``), which puts the data axis's
    collectives on its path.  The refusals come before ``pick_device``
    is called."""
    why = _gang_request()
    data_parallel = getattr(opt, "data_parallel", False)
    if why:
        if not data_parallel:
            flag = ("pass --data_parallel so the ranks join one gang" if hasattr(opt, "data_parallel")
                    else "this trainer has no --data_parallel; run one process")
            raise SystemExit(
                f"multi-process run requested ({why}): {flag}. Without it every rank would "
                "train an independent model against the same checkpoint paths")
        if getattr(opt, "zero_opt", False):
            raise SystemExit(
                f"multi-process run requested ({why}): --zero_opt is not supported in "
                "multi-process CLI runs. Cadence checkpoints are written by rank 0 alone, "
                "which cannot gather Adam moments sliced over the ranks; a library loop "
                "that saves through parallel.save_on_coordinator on every rank can")
    try:
        multihost.check_rank_environment()
    except ValueError as e:
        raise SystemExit(f"multi-process run requested ({why}): {e}") from None
    device = multihost.initialize(device=pick_device())
    if data_parallel:
        device = multihost.join_local(device)
    return device


def setup_preemption(opt):
    """Arm the graceful-preemption SIGTERM guard for a trainer CLI
    (``--preempt_save on``, the default).  Returns the guard, or None
    when it is off: pass ``stop_event=guard.requested if guard else
    None`` and an ``on_shutdown`` final save to ``run_epochs``, and call
    :func:`exit_if_preempted` after the run (``utils/preempt.py``)."""
    if getattr(opt, "preempt_save", "on") != "on":
        return None
    from eadgan_tpu_torch.utils.preempt import PreemptionGuard

    return PreemptionGuard().install()


def exit_if_preempted(guard) -> None:
    """After ``run_epochs`` returns: if the run stopped on the guard's
    signal and the stop cut the schedule short, exit with
    ``PREEMPT_EXIT_CODE`` (86).  Exiting 0 would tell supervisors and
    scripts the run is done; 87 would tell ``cli.supervise`` to relaunch
    at once.  A signal that lands on the final step, or after the
    schedule ended (the engine then never saw it and set no
    ``cut_short``), exits 0, so ``cli.supervise --restart_on_error``
    does not relaunch a finished run (``--max_steps`` counts from the
    restored step, so a relaunch would train steps nobody asked for)."""
    if guard is None or not guard.requested.is_set():
        return
    from eadgan_tpu_torch.utils.preempt import PREEMPT_EXIT_CODE

    if not getattr(guard.requested, "cut_short", False):
        print(
            "preemption signal landed at/after schedule completion: the "
            "run is COMPLETE, exiting 0 (no restart needed)",
            flush=True,
        )
        return
    print(
        f"preemption save complete: exiting {PREEMPT_EXIT_CODE} "
        "(continue later with --resume auto)",
        flush=True,
    )
    sys.exit(PREEMPT_EXIT_CODE)


def disable_tf32() -> None:
    """Run float32 convolutions (cuDNN) and matrix products (cuBLAS) in
    full float32, never TF32.  Torch allows TF32 in cuDNN convolutions by
    default; the CPU-vs-card step gates, the card tests and the timings
    all run with it off, so the CLIs do too.  Safe without a card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def add_adam_args(parser: argparse.ArgumentParser, lr: float) -> None:
    parser.add_argument("--lr", type=float, default=lr, help="adam: learning rate")
    parser.add_argument("--b1", type=float, default=0.5, help="adam: decay of first order momentum of gradient")
    parser.add_argument("--b2", type=float, default=0.999, help="adam: decay of first order momentum of gradient")


def add_run_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--n_cpu", type=int, default=8, help="number of cpu threads to use during batch generation")
    parser.add_argument("--data_dir", type=str, default=".", help="dataset directory")
    parser.add_argument("--out_dir", type=str, default="images", help="artifact directory")
    parser.add_argument("--ckpt_dir", type=str, default=".", help="checkpoint directory")
    parser.add_argument("--seed", type=int, default=0, help="PRNG seed")
    parser.add_argument(
        "--max_steps", type=int, default=0,
        help="stop after N batches, counted from the restored step (0 = full schedule)",
    )
    parser.add_argument("--jsonl", type=str, default="", help="metrics JSONL path")
    parser.add_argument(
        "--resume", type=str, default="",
        help="train-state file to resume from, or 'auto' for the newest loadable one in --ckpt_dir",
    )
    parser.add_argument(
        "--keep_states", type=int, default=0,
        help="keep only the N newest train-state files, pruning older ones after each save "
        "(0 = keep all). Use >= 2 so --resume auto keeps a fallback when the newest file is "
        "damaged. Reference-contract model files (checkpoint_*.tar) are never pruned",
    )
    parser.add_argument(
        "--chain", type=_positive_int, default=32,
        help="train steps per window: on the card, the step is captured once as a CUDA graph "
        "and each window replays it this many times (up to the next sample/checkpoint step), "
        "gathering every batch on the card from the resident dataset; 1 = one eagerly "
        "launched step per batch, gathered on the host (debugging)",
    )
    parser.add_argument(
        "--compute", choices=["bf16", "f32"], default=None,
        help="model compute type; parameters, BatchNorm statistics and spectral-norm state "
        "stay float32 either way. Default: bf16 on the CUDA card (tensor-core passes, the "
        "configuration a production run trains in) and f32 on the CPU (the parity tests). "
        "The warp runs on the float32 real batch and accumulates in float32 in both modes "
        "(the JAX package's EADGAN_WARP_PRECISION=fast selects TPU matrix-unit passes and "
        "has no counterpart here). GAN trainers only: the pxy pretrainers always run f32 "
        "(their codes feed the exact 3x3 affine algebra)",
    )
    parser.add_argument(
        "--data_parallel", action="store_true",
        help="data-parallel training over the ranks of a gang (cli.supervise --ranks N, "
        "torchrun), one rank per card: each rank takes its slice of every global batch of "
        "--batch_size, gradients, BatchNorm statistics and logged metrics are averaged over "
        "the ranks (all-reduces that the CUDA graph captures), rank 0 writes. In one process, "
        "a gang of one",
    )
    parser.add_argument(
        "--zero_opt", action="store_true",
        help="with --data_parallel: shard the Adam moments over the ranks (ZeRO-1, "
        "parallel/zero.py) instead of replicating them, ~1/N the optimizer memory per "
        "card; parameters stay replicated. Requires the chained engine (--chain > 1); "
        "refused in a multi-process CLI run",
    )
    parser.add_argument(
        "--profile_dir", type=str, default="",
        help="write a torch.profiler trace of the run (CPU and CUDA activity) here as a "
        "Chrome trace; keep such runs short, the profiler holds every event in memory",
    )
    parser.add_argument(
        "--no_download", action="store_true",
        help="never fetch missing dataset archives from the network (accepted for the JAX "
        "CLIs' command lines; this package never downloads: absent datasets are replaced "
        "by synthetic stand-ins, or must be placed under --data_dir)",
    )
    parser.add_argument(
        "--preempt_save", choices=["on", "off"], default="on",
        help="graceful preemption shutdown: on SIGTERM (a cloud preemption or maintenance "
        "notice, kill, a supervisor's teardown) finish the in-flight window, save a final "
        "train state at the exact current step, and exit 86; --resume auto then continues "
        "with no lost step. A second SIGTERM terminates immediately (the atomic writer "
        "keeps that safe). 'off' restores the default die-on-SIGTERM disposition",
    )
    parser.add_argument(
        "--watchdog", type=float, default=0.0,
        help="stall watchdog: if the card proves no training progress for this many "
        "seconds, dump every thread's stack and exit 87 so cli.supervise can relaunch "
        "with --resume auto. The first window (kernel build with nvcc on a cold cache, "
        "cuDNN's algorithm choice, the CUDA graph capture) gets EADGAN_WATCHDOG_FIRST "
        "seconds, default max(this, 900) (utils/watchdog.py). 0 = off",
    )


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def resolve_compute_dtype(opt, device):
    """``--compute`` as a model ``dtype``: ``torch.bfloat16`` or ``None``
    (float32).  Unset, it follows the run's ``device``, as the JAX
    package's follows its backend: bf16 on the CUDA card, so a production
    run trains in the configuration the step is timed in, and f32 on the
    CPU, where the parity tests run."""
    choice = opt.compute or ("bf16" if torch.device(device).type == "cuda" else "f32")
    return torch.bfloat16 if choice == "bf16" else None


def maybe_resume(state, resume: str, ckpt_dir: str, stem: str):
    """Handle ``--resume``: a path restores that train-state file; the
    literal ``auto`` restores the newest *loadable* ``<stem>_%d.ckpt`` in
    ``ckpt_dir`` (no-op when there is none), skipping a damaged newest
    file with a warning.  A file may be the port's or the JAX package's
    (``train/checkpoint.py::read_file``).  Restores into ``state`` in
    place; returns it."""
    if not resume:
        return state
    if resume != "auto":
        return restore_train_state(resume, state)
    state, step = restore_latest(ckpt_dir, stem, state)
    if step < 0:
        print(f"--resume auto: no loadable {stem}_*.ckpt in {ckpt_dir}, starting fresh")
    else:
        print(f"--resume auto: restored {os.path.join(ckpt_dir, f'{stem}_{step}.ckpt')} "
              f"at step {state.step}")
    return state
