"""Shared CLI plumbing: flag definitions, the compute type, the float32
matmul mode, resume, the SIGTERM guard and the rank environment.

PyTorch counterpart of ``eadgan_tpu/cli/common.py``.  The device is
chosen by ``utils.device.platform_device`` (``EADGAN_PLATFORM=cpu`` for
the CPU, the CUDA card otherwise).  Every trainer CLI first calls
:func:`init_multiprocess`, which refuses a multi-process rank
environment (multi-process training is not ported yet), then
:func:`disable_tf32` before it picks the device, so its float32 convs
and matrix products run in full float32, the mode the CPU-vs-card gates
check (torch's default lets cuDNN convolve in TF32).  It arms the
SIGTERM guard (:func:`setup_preemption`, ``--preempt_save on`` by
default), passes ``--watchdog`` and ``--profile_dir`` to ``run_epochs``
and ends with :func:`exit_if_preempted`.  ``--data_parallel`` and
``--zero_opt`` belong to the scale-out slice of the port and are not
defined, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

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

# the rank environment the JAX package's ``parallel.initialize`` reads
# (``cli.supervise --ranks N`` sets the EADGAN_MP_* triple)
_COORDINATOR_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
    "EADGAN_MP_COORDINATOR",
)


def init_multiprocess() -> None:
    """Refuse a multi-process run, which the port cannot do yet.

    ``cli.supervise --ranks N`` hands each gang member the ``EADGAN_MP_*``
    rank triple, a cluster scheduler may set a coordinator address
    instead, and ``torchrun`` sets ``WORLD_SIZE``.  The JAX package joins
    such ranks into one global mesh under ``--data_parallel``; the port
    has no multi-process training yet, so each rank would train an
    independent copy on its card and write the same checkpoint paths.
    When the environment names more than one process (``WORLD_SIZE`` > 1,
    ``EADGAN_MP_NUM_PROCESSES`` > 1, or a coordinator address without
    ``EADGAN_MP_NUM_PROCESSES`` <= 1) this raises ``SystemExit`` before
    the CLI touches the card; otherwise it does nothing."""
    n = os.environ.get("EADGAN_MP_NUM_PROCESSES", "")
    world = os.environ.get("WORLD_SIZE", "")
    if world and int(world) > 1:
        why = f"WORLD_SIZE={world}"
    elif n:
        if int(n) <= 1:
            return
        why = f"EADGAN_MP_NUM_PROCESSES={n}"
    else:
        named = [v for v in _COORDINATOR_ENV_VARS if os.environ.get(v)]
        if not named:
            return
        why = f"{named[0]}={os.environ[named[0]]}"
    raise SystemExit(
        f"multi-process run requested ({why}): multi-process training is not yet "
        "ported to eadgan_tpu_torch, and every rank would train an independent model "
        "against the same checkpoint paths. Run one process (unset the rank "
        "environment, or cli.supervise without --ranks)"
    )


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
        "--compute", choices=["bf16", "f32"], default="f32",
        help="model compute type; parameters, BatchNorm statistics and spectral-norm state "
        "stay float32 either way. The warp runs on the float32 real batch and accumulates "
        "in float32 in both modes (the JAX package's EADGAN_WARP_PRECISION=fast selects "
        "TPU matrix-unit passes and has no counterpart here)",
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


def resolve_compute_dtype(opt):
    """``--compute`` as a model ``dtype``: ``torch.bfloat16`` or ``None``
    (float32).  The default is f32, the JAX package's default off the
    TPU."""
    return torch.bfloat16 if opt.compute == "bf16" else None


def maybe_resume(state, resume: str, ckpt_dir: str, stem: str):
    """Handle ``--resume``: a path restores that train-state file; the
    literal ``auto`` restores the newest *loadable* ``<stem>_%d.ckpt`` in
    ``ckpt_dir`` (no-op when there is none), skipping a damaged newest
    file with a warning.  Restores into ``state`` in place; returns it."""
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
