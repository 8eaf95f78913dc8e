"""CUDA wrapper of the device clock stamp (``csrc/stamp.cu``).

Replaces no TPU kernel: a traced replayed step (``train/chain.py``)
writes the card's nanosecond clock (``%globaltimer``) into a slot of an
int64 buffer at each phase boundary, on the current stream, so the
stamps ride inside the captured graph and bound each phase's device
time.  There is no plain version: the CPU has no device clock, and the
CPU path records no stamps.
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.ops import _build

__all__ = ["stamp"]


def stamp(slots: torch.Tensor, index: int) -> None:
    """Write the device clock into ``slots[index]`` once the work enqueued
    before it on the current stream has finished."""
    if not slots.is_cuda or slots.dtype != torch.int64 or not slots.is_contiguous():
        raise ValueError("stamp needs a contiguous int64 CUDA tensor")
    if not 0 <= index < slots.numel():
        raise IndexError(f"stamp slot {index} outside a buffer of {slots.numel()}")
    with torch.cuda.device(slots.device):
        err = _build.load_library().eadgan_stamp(slots.data_ptr(), index,
                                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: CUDA error {err}")
