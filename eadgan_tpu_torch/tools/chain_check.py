"""The chained engine (CUDA-graph replay) against the per-step engine.

``python -m eadgan_tpu_torch.tools.chain_check [--pipeline celeba|pxy|
pxy_color|rp|rp_color|mnist] [--steps 8] [--chain 4] [--batch 128]`` builds
one pipeline's f32 train state and synthetic dataset (uint8; MNIST's
float32)
(``utils/profiler.py::build_step``) and runs ``--steps`` steps of
``train/engine.py::run_epochs`` three times, each from a copy of that
state, with the pipeline's batch arguments and events every ``--chain``
steps:

* per-step runs A and B (``chain=1``): each batch gathered and
  normalized on the host, copied to the card and passed to the step;
* the chained run C (``chain=--chain``): the windows ``plan_windows``
  makes, the dataset resident on the card and each batch gathered there,
  the run's first step eager, then the step captured once and replayed,
  the metrics drained one window behind, the event batches made on the
  card, and the events run on the engine's worker with a snapshot of the
  state (``EADGAN_SYNC_EVENTS=1`` in the environment runs them inline).

It reports ``spread``, the largest relative difference of a logged loss
between A and B, and ``err``, the largest between C and A, with the
warp's launches in C.  cuDNN is held to its deterministic algorithms, so
a step is a function of its inputs: the check passes when ``spread`` and
``err`` are both 0, C logged every step, ran its events at A's steps on
A's batches bit for bit, with the first parameter of the state's first
model as A's there, ended at A's step, and launched the warp
``WARPS_PER_STEP`` times a step.

Prints one JSON line; exits non-zero when the check fails.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

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

    def run(k):
        records, events = _Records(), []

        def on_batch(i, state, metrics, batches):
            if i % chain == 0:  # as the trainers gate their grids and saves
                model = next(v for v in vars(state).values() if isinstance(v, torch.nn.Module))
                events.append((i, batches[0].cpu().numpy(),
                               next(model.parameters()).detach().cpu().numpy()))

        state = run_epochs(
            n_epochs=steps, data=data, batch_size=batch, state=snapshot_state(state0), step_fn=step,
            on_batch=on_batch, device="cuda", max_steps=steps, logger=records, chain=k,
            chain_periods=(chain,), **prep,
        )
        torch.cuda.synchronize()
        return state.step, records.steps, events

    with _cudnn_deterministic():
        a, b = run(1), run(1)
        before = stn_cuda.launch_count
        c = run(chain)
        warps = stn_cuda.launch_count - before

    keys = sorted(a[1][0])
    table = [np.array([[r[s][k] for k in keys] for s in sorted(r)]) for r in (a[1], b[1], c[1])]
    logged = [sorted(r[1]) for r in (a, b, c)]
    events_equal = [e[0] for e in c[2]] == [e[0] for e in a[2]] and all(
        np.array_equal(x, y) and np.array_equal(px, py)
        for (_, x, px), (_, y, py) in zip(c[2], a[2])
    )
    spread = _rel(table[1], table[0]) if logged[1] == logged[0] else float("inf")
    err = _rel(table[2], table[0]) if logged[2] == logged[0] else float("inf")
    want_warps = WARPS_PER_STEP[pipeline] * steps
    return {
        "chain_check": pipeline, "batch": batch, "steps": steps, "chain": chain,
        "keys": keys, "spread": spread, "err": err,
        "final_step": [a[0], c[0]], "event_steps": [e[0] for e in c[2]],
        "event_batches_equal": events_equal, "warp_launches": warps,
        "expected_warp_launches": want_warps,
        "last_per_step": table[0][-1].tolist(), "last_chained": table[2][-1].tolist(),
        "ok": bool(np.isfinite(table[2]).all()) and logged[0] == list(range(steps))
        and spread == 0 and err == 0 and events_equal and a[0] == c[0] == steps
        and warps == want_warps,
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
