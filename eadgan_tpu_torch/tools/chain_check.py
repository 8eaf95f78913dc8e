"""The chained engine (CUDA-graph replay) against the per-step engine.

``python -m eadgan_tpu_torch.tools.chain_check [--pipeline celeba|pxy|
pxy_color|rp|rp_color|mnist] [--steps 8] [--chain 4] [--batch 128]`` builds
one pipeline's f32 train state and synthetic dataset (uint8; MNIST's
float32)
(``utils/profiler.py::build_step``) and runs ``--steps`` steps of
``train/engine.py::run_epochs`` four times, each from a copy of that
state, with the pipeline's batch arguments and events every ``--chain``
steps:

* per-step runs A and B (``chain=1``): each batch gathered and
  normalized on the host by the engine's prefetch thread (the native
  batcher for uint8 images), into pinned memory, copied to the card on a
  stream of its own and passed to the step;
* the chained run C (``chain=--chain``): the windows ``plan_windows``
  makes, the dataset resident on the card and each batch gathered there,
  the run's first step eager, then the step captured once and replayed,
  the metrics drained one window behind, the event batches made on the
  card, and the events run on the engine's worker with a snapshot of the
  state (``EADGAN_SYNC_EVENTS=1`` in the environment runs them inline);
* the chained run D: C with ``EADGAN_DEVICE_DATA_MAX=0``, so the dataset
  stays on the host and each window carries its raw rows, gathered on a
  prefetch thread and normalized in the graph.

It reports ``spread``, the largest relative difference of a logged loss
between A and B, and ``err`` and ``err_raw``, the largest between C and
A and between D and A, with the warp's launches in C and in D.  cuDNN is
held to its deterministic algorithms, so a step is a function of its
inputs: the check passes when ``spread``, ``err`` and ``err_raw`` are all
0, C and D logged every step, ran their events at A's steps on A's
batches bit for bit, with the first parameter of the state's first model
as A's there, ended at A's step, and launched the warp ``WARPS_PER_STEP``
times a step.

Prints one JSON line; exits non-zero when the check fails.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.train.chain import snapshot_state
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.utils.profiler import PIPELINES, build_step

__all__ = ["WARPS_PER_STEP", "run_check", "main"]

WARPS_PER_STEP = {"celeba": 1, "pxy": 1, "pxy_color": 1, "rp": 3, "rp_color": 3, "mnist": 1}


class _Records:
    """A logger that keeps every step's metrics as floats."""

    def __init__(self):
        self.steps = {}

    def log(self, step, metrics, **_):
        self.steps[int(step)] = {k: float(v) for k, v in metrics.items()}

    def close(self):
        pass


@contextlib.contextmanager
def _cudnn_deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


def run_check(pipeline: str = "pxy", steps: int = 8, chain: int = 4, batch: int = 128) -> dict:
    """The three runs; returns the report (see the module docstring)."""
    state0, step, data, prep = build_step(pipeline, batch)

    def run(k, raw=False):
        records, events = _Records(), []

        def on_batch(i, state, metrics, batches):
            if i % chain == 0:  # as the trainers gate their grids and saves
                model = next(v for v in vars(state).values() if isinstance(v, torch.nn.Module))
                events.append((i, batches[0].cpu().numpy(),
                               next(model.parameters()).detach().cpu().numpy()))

        before = stn_cuda.launch_count
        with mock.patch.dict(os.environ, {"EADGAN_DEVICE_DATA_MAX": "0"} if raw else {}):
            state = run_epochs(
                n_epochs=steps, data=data, batch_size=batch, state=snapshot_state(state0),
                step_fn=step, on_batch=on_batch, device="cuda", max_steps=steps, logger=records,
                chain=k, chain_periods=(chain,), **prep,
            )
        torch.cuda.synchronize()
        return state.step, records.steps, events, stn_cuda.launch_count - before

    with _cudnn_deterministic():
        runs = [run(1), run(1), run(chain), run(chain, raw=True)]
    a = runs[0]
    keys = sorted(a[1][0])
    table = [np.array([[r[1][s][k] for k in keys] for s in sorted(r[1])]) for r in runs]

    def events_equal(r):
        return [e[0] for e in r[2]] == [e[0] for e in a[2]] and all(
            np.array_equal(x, y) and np.array_equal(px, py)
            for (_, x, px), (_, y, py) in zip(r[2], a[2])
        )

    def rel(i):
        return _rel(table[i], table[0]) if sorted(runs[i][1]) == sorted(a[1]) else float("inf")

    spread, err, err_raw = rel(1), rel(2), rel(3)
    want_warps = WARPS_PER_STEP[pipeline] * steps
    chained = runs[2:]
    return {
        "chain_check": pipeline, "batch": batch, "steps": steps, "chain": chain,
        "keys": keys, "spread": spread, "err": err, "err_raw": err_raw,
        "final_step": [r[0] for r in runs], "event_steps": [e[0] for e in runs[2][2]],
        "event_batches_equal": [events_equal(r) for r in chained],
        "warp_launches": [r[3] for r in chained], "expected_warp_launches": want_warps,
        "last_per_step": table[0][-1].tolist(), "last_chained": table[2][-1].tolist(),
        "last_raw_windows": table[3][-1].tolist(),
        "ok": all(np.isfinite(t).all() for t in table) and sorted(a[1]) == list(range(steps))
        and spread == 0 and err == 0 and err_raw == 0
        and all(events_equal(r) for r in chained)
        and all(r[0] == steps for r in runs) and all(r[3] == want_warps for r in chained),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=PIPELINES, default="pxy")
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--chain", type=int, default=4)
    parser.add_argument("--batch", type=int, default=128)
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the chained engine's check needs the card")
    report = run_check(opt.pipeline, opt.steps, opt.chain, opt.batch)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
