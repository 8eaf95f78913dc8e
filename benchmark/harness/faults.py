"""Faults planted under a cell's timed path, for the checks that the
comparison catches them (``tests/``, ``calibrate.py``):

- ``unchanged``: the train step returns its state unchanged (every
  parameter put back after the step);
- ``half_batch``: the train step sees half of its batch, its means taken
  over the rest;
- ``half_batch_replayed``: the same, in the captured graph alone: the
  eager first step is sound and every replayed step sees half its batch
  (a fault of the path the measured window times that the first step
  cannot show).  On the CPU nothing is captured and the step is sound.
"""

from __future__ import annotations

import torch


def unchanged(program):
    step = program.step
    params = [t for m in program.models.values() for t in m.parameters()]

    def faulty(state, batch, **kw):
        saved = [t.detach().clone() for t in params]
        state, metrics = step(state, batch, **kw)
        with torch.no_grad():
            for t, s in zip(params, saved):
                t.copy_(s)
        return state, metrics

    return faulty


def half_batch(program):
    step = program.step

    def faulty(state, batch, **kw):
        return step(state, batch[: batch.shape[0] // 2].contiguous(), **kw)

    return faulty


def half_batch_replayed(program):
    step = program.step

    def faulty(state, batch, **kw):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            batch = batch[: batch.shape[0] // 2].contiguous()
        return step(state, batch, **kw)

    return faulty


TRAIN = {"unchanged": unchanged, "half_batch": half_batch, "half_batch_replayed": half_batch_replayed}
