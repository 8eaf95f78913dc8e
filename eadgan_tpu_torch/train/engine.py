"""Training engine: the epoch/batch loop a trainer runs its step under.

PyTorch counterpart of the single-device path of
``eadgan_tpu/train/engine.py``.  It draws the same epoch permutations from
``np.random.default_rng(seed)`` and the same per-batch flip masks from
``np.random.default_rng([seed, 0x464C4950])``, one draw per batch in
batch order, so both packages feed their steps the same batches.
Batches are gathered, normalized and flipped in numpy on the host, then
copied to the device.

A run resumed at a step inside an epoch starts from fresh generators, as
the JAX engines do: the resumed epoch draws a fresh permutation and runs
only its remaining ``n_batches - start_step % n_batches`` batches, taken
from the start of that permutation (the rows the JAX CLI's default
chained engine gives those steps, ``plan_windows``), and the run ends at
the planned total, ``n_epochs * n_batches``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

from eadgan_tpu_torch.models.layers import no_stat_updates
from eadgan_tpu_torch.utils.logging import MetricLogger

__all__ = ["run_epochs", "epoch_batches", "generator_apply"]

_FLIP_STREAM = 0x464C4950


def epoch_batches(
    data: np.ndarray, batch_size: int, n_epochs: int, seed: int = 0,
    start_step: int = 0, scale: float = 1.0, shift: float = 0.0,
    random_flip: bool = False,
):
    """Yield ``(epoch, host_batch)`` in training order from step
    ``start_step`` on: for each epoch a permutation of the uint8 ``data``,
    cut into full batches (the ragged tail is dropped), each gathered as
    float32 ``x * scale + shift`` and, with ``random_flip``, mirrored
    along the width where a fresh draw is below 0.5.  A 3-D (N, H, W)
    ``data`` (dSprites) gains a channel axis, (B, H, W, 1), as the JAX
    engine's ``add_channel`` gives it.  The epoch holding ``start_step``
    yields only its remaining batches, from the start of its
    permutation."""
    host_rng = np.random.default_rng(seed)
    flip_rng = np.random.default_rng([seed, _FLIP_STREAM])
    n = data.shape[0]
    n_batches = n // batch_size
    first_epoch, done = divmod(start_step, max(n_batches, 1))
    for epoch in range(first_epoch, n_epochs):
        perm = host_rng.permutation(n)
        skip = done if epoch == first_epoch else 0
        for s in range(0, (n_batches - skip) * batch_size, batch_size):
            idx = perm[s : s + batch_size]
            out = data[idx].astype(np.float32) * scale + shift
            if random_flip:
                mask = flip_rng.random(len(idx)) < 0.5
                out[mask] = out[mask, :, ::-1]
            if data.ndim == 3:
                out = out[..., None]
            yield epoch, out


def run_epochs(
    *,
    n_epochs: int,
    data: np.ndarray,
    batch_size: int,
    state,
    step_fn: Callable,
    on_batch: Callable,
    device,
    seed: int = 0,
    max_steps: int = 0,
    logger: Optional[MetricLogger] = None,
    metric_keys: Optional[Iterable[str]] = None,
    scale: float = 1.0,
    shift: float = 0.0,
    random_flip: bool = False,
):
    """The reference's epoch/batch double loop.

    ``step_fn(state, batch) -> (state, metrics)`` with ``batch`` a
    contiguous float32 NHWC tensor on ``device``;
    ``on_batch(batches_done, state, metrics, (batch,))`` handles sampling
    and checkpoint side effects.  Metrics stay device tensors: the
    logger converts them only when it prints or writes.  ``max_steps``
    stops after that many steps (0: the whole schedule).  Closes
    ``logger`` at the end.
    """
    if random_flip and data.dtype != np.uint8:
        raise ValueError("random_flip requires the uint8 image ingest path")
    n_batches = data.shape[0] // batch_size
    start_step = state.step
    batches_done = start_step
    try:
        for epoch, host in epoch_batches(
            data, batch_size, n_epochs, seed=seed, start_step=start_step,
            scale=scale, shift=shift, random_flip=random_flip,
        ):
            batch = torch.from_numpy(host).to(device)
            state, metrics = step_fn(state, batch)
            if logger is not None:
                shown = {k: metrics[k] for k in metric_keys} if metric_keys else metrics
                logger.log(
                    batches_done,
                    shown,
                    epoch=epoch,
                    n_epochs=n_epochs,
                    batch=batches_done % n_batches,
                    n_batches=n_batches,
                )
            on_batch(batches_done, state, metrics, (batch,))
            batches_done += 1
            if max_steps and batches_done - start_step >= max_steps:
                break
    finally:
        if logger is not None:
            logger.close()
    return state


def generator_apply(get_generator: Callable):
    """Generator forward for sampling (counterpart of the JAX package's
    ``jit_generator_apply``): numpy inputs in, NHWC numpy images out.
    ``get_generator()`` returns the current model, so samples reflect the
    latest weights.  The forward runs without gradients, in training-mode
    BatchNorm (batch statistics, as in training) that leaves the running
    statistics untouched."""

    def apply(*inputs):
        g = get_generator()
        dev = next(g.parameters()).device
        with torch.no_grad(), no_stat_updates(g):
            out = g(*[torch.as_tensor(np.asarray(x), device=dev) for x in inputs])
        return out.permute(0, 2, 3, 1).cpu().numpy()

    return apply
