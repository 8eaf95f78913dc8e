"""Shared CLI plumbing: flag definitions, the compute type, the float32
matmul mode and resume.

PyTorch counterpart of part of ``eadgan_tpu/cli/common.py``.  The device
is chosen by ``utils.device.platform_device`` (``EADGAN_PLATFORM=cpu``
for the CPU, the CUDA card otherwise).  Every CLI calls
:func:`disable_tf32` before it picks the device, so its float32 convs
and matrix products run in full float32, the mode the CPU-vs-card gates
check (torch's default lets cuDNN convolve in TF32).  The flags whose
machinery belongs to later slices of the port (``--data_parallel``,
``--zero_opt``, ``--watchdog``, ``--preempt_save``, ``--profile_dir``,
``--no_download``) are not defined, so argparse rejects them.
"""

from __future__ import annotations

import argparse
import os

import torch

from eadgan_tpu_torch.train.checkpoint import restore_latest, restore_train_state

__all__ = [
    "add_adam_args",
    "add_run_args",
    "disable_tf32",
    "maybe_resume",
    "resolve_compute_dtype",
]


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
