"""The ``data`` axis: replicated state, sliced batches, global statistics.

PyTorch counterpart of the data axis of ``eadgan_tpu/parallel/mesh.py``.
There, batches are sharded over the ``data`` mesh axis, parameters and
optimizer state are replicated, and XLA's SPMD partitioner turns every
mean over the batch into a cross-device reduction: the gradients'
``psum``, and BatchNorm statistics over the *global* batch.  Here each
rank is one process with its slice of the global batch, and the same
three reductions are written out as all-reduces over the process group:

* the gradients, averaged before each optimizer step: one all-reduce of
  a flat buffer per step (:func:`mean_gradients`, from a step pre-hook
  :func:`replicate` registers on each ``opt*`` optimizer);
* the BatchNorm statistics (``models/layers.py::TorchBatchNorm``), through
  :func:`global_mean`, whose backward all-reduces the gradient;
* the logged metrics (:func:`data_parallel_step`).

The random draws of a step (codes, noise, colours) are made at the global
batch from the step's generator, identical on every rank, and each rank
keeps its rows (:func:`local_rows`): a step on N ranks computes what one
rank computes on the global batch.

All of this is active only inside :func:`data_axis`, which the engine
enters around each train step on the thread that runs it.  Rank 0's
sample grids and saves run outside it and alone, so they issue no
collective (one there would wait forever for the other ranks).  At a
world size of 1 every number is bit-equal to the step without a group:
a sum over one rank and a division by 1.0 are exact.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from eadgan_tpu_torch.parallel.multihost import process_count, process_index

__all__ = [
    "data_axis",
    "axis_size",
    "local_rows",
    "global_mean",
    "all_reduce_mean",
    "mean_gradients",
    "replicate",
    "shard_batch",
    "shard_window",
    "data_parallel_step",
    "collective_count",
]

_AXIS = threading.local()
_COUNT = [0]  # collectives issued from Python (a captured graph replays them uncounted)


def collective_count() -> int:
    """Collectives the data axis has issued in this process so far (a
    CUDA-graph replay runs the captured ones without counting)."""
    return _COUNT[0]


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    _COUNT[0] += 1
    dist.all_reduce(t)
    return t


@contextlib.contextmanager
def data_axis():
    """Inside the block, on this thread: BatchNorm statistics and the
    gradients of optimizer steps are reduced over the process group, and
    the steps' draws are sliced to this rank's rows."""
    if not dist.is_initialized():
        raise RuntimeError("the data axis needs a process group (parallel.initialize or join_local)")
    prev = getattr(_AXIS, "size", None)
    _AXIS.size, _AXIS.index = process_count(), process_index()
    try:
        yield
    finally:
        _AXIS.size = prev


def axis_size() -> int:
    """The data axis's size inside :func:`data_axis`, 0 outside it."""
    return getattr(_AXIS, "size", None) or 0


def local_rows(x, local_batch: int):
    """This rank's ``local_batch`` rows of ``x``, a draw (or a ``fixed=``
    input) made at the global batch.  Outside :func:`data_axis`, ``x``
    itself: the global batch is the local one."""
    n = axis_size()
    if not n or len(x) == local_batch:
        return x
    if len(x) != n * local_batch:
        raise ValueError(f"a draw of {len(x)} rows for {n} ranks of {local_batch}")
    start = _AXIS.index * local_batch
    return x[start : start + local_batch]


def global_batch(local_batch: int) -> int:
    """The global batch a step's draws are made at: ``local_batch`` times
    the data axis's size (``local_batch`` outside it)."""
    return local_batch * (axis_size() or 1)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the gradient over them (each
    rank's loss depends on every rank's input through the sum)."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the ranks of ``x``, each rank's mean over its equal
    slice of the batch, so the mean over the global batch; differentiable.
    Outside :func:`data_axis`, ``x`` itself."""
    n = axis_size()
    if not n:
        return x
    return _AllReduceSum.apply(x) / float(n)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks in place (no autograd)."""
    return _all_reduce(x).div_(float(process_count()))


def mean_gradients(params) -> None:
    """Average the gradients of ``params`` over the ranks: one all-reduce
    of one flat buffer, then a division by the world size, copied back.
    Parameters without a gradient are left alone (the same on every rank:
    each runs the same graph)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def _params(opt):
    return [p for group in opt.param_groups for p in group["params"]]


def _mean_gradients_hook(opt, args, kwargs):
    if axis_size():
        mean_gradients(_params(opt))


def _state_values(state):
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None]


def replicate(state):
    """Make a train state data-parallel in place; returns it.  Every
    parameter and buffer of its models (spectral-norm ``u``/``sigma``,
    BatchNorm statistics), the Adam state of its optimizers and its
    generator's state are broadcast from rank 0, so a fresh or restored
    state is identical on every rank (nothing moves at a world size of
    1); each ``opt*`` optimizer gets the step pre-hook that averages its
    gradients inside :func:`data_axis`."""
    broadcast = process_count() > 1
    for value in _state_values(state):
        if isinstance(value, nn.Module):
            if broadcast:
                for t in value.state_dict().values():
                    dist.broadcast(t, src=0)
        elif isinstance(value, torch.optim.Optimizer):
            if broadcast:
                for p in _params(value):
                    for k in sorted(value.state.get(p, {})):
                        if torch.is_tensor(value.state[p][k]):
                            dist.broadcast(value.state[p][k], src=0)
            if not getattr(value, "_eadgan_mean_gradients", False):
                value.register_step_pre_hook(_mean_gradients_hook)
                value._eadgan_mean_gradients = True
        elif isinstance(value, torch.Generator) and broadcast:
            rng = value.get_state()
            dist.broadcast(rng, src=0)
            value.set_state(rng)
    return state


def shard_batch(batch: np.ndarray, rows: slice) -> np.ndarray:
    """This rank's ``rows`` of a host batch's leading (batch) axis."""
    return batch[rows]


def shard_window(window: np.ndarray, rows: slice) -> np.ndarray:
    """This rank's ``rows`` of a (K, B, ...) window's batch axis: each
    step of the window then sees the slice :func:`shard_batch` gives."""
    return window[:, rows]


def data_parallel_step(step_fn: Callable) -> Callable:
    """``step_fn`` run inside :func:`data_axis`, its metrics averaged over
    the ranks in one all-reduce (the means over the global batch)."""

    def step(state, *batch, **kwargs):
        with data_axis():
            state, metrics = step_fn(state, *batch, **kwargs)
            keys = sorted(metrics)
            packed = all_reduce_mean(torch.stack([metrics[k].float().reshape(()) for k in keys]))
        return state, {k: packed[i] for i, k in enumerate(keys)}

    return step
