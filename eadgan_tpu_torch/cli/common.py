"""Shared CLI plumbing: flag definitions.

PyTorch counterpart of part of ``eadgan_tpu/cli/common.py``.  The device
is chosen by ``utils.device.platform_device`` (``EADGAN_PLATFORM=cpu``
for the CPU, the CUDA card otherwise).  The flags whose machinery
belongs to later slices of the port (``--resume``, ``--keep_states``,
``--compute``, ``--chain``, ``--data_parallel``, ``--zero_opt``,
``--watchdog``, ``--preempt_save``, ``--profile_dir``, ``--no_download``)
are not defined, so argparse rejects them.
"""

from __future__ import annotations

import argparse

__all__ = ["add_adam_args", "add_run_args"]


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
    parser.add_argument("--max_steps", type=int, default=0, help="stop after N batches (0 = full schedule)")
    parser.add_argument("--jsonl", type=str, default="", help="metrics JSONL path")
