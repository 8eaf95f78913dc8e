"""A graceful stop against a run that ends at the same step.

``python -m eadgan_tpu_torch.tools.stop_check [--pipeline celeba|pxy|
pxy_color|rp|rp_color|mnist] [--batch 128] [--chain 32] [--stop_at 40]
[--n_images 8192]`` builds one pipeline's f32 train state and synthetic
dataset (``utils/profiler.py::build_step``; CelebA on ``--n_images``
synthetic faces, so that an epoch holds whole windows) and runs
``train/engine.py::run_epochs`` twice, each from a copy of that state,
with cuDNN held to its deterministic algorithms:

* run A at ``--chain``, with an inline event at every window end (no
  event periods) that sets ``stop_event`` once the step index reaches
  ``--stop_at``; its ``on_shutdown`` copies the live train state to the
  host the way the final save does
  (``train/checkpoint.py::train_state_payload``) at its step S;
* run B from the same state and seed with ``max_steps=S``.

The check passes when the two host states are equal bit for bit in every
tensor (parameters, BatchNorm statistics, spectral-norm ``u``/``sigma``,
the optimizers' moments and step counts, the generator's state) and in
the step, ``stop_event.cut_short`` is true, and S is the end of the
window whose event set the flag, at most ``stop_at + chain``.  On the
card that also shows the final save's copies are ordered after the last
replay of the graph.  Prints one JSON line; exits non-zero when the check
fails.  ``--device cpu`` runs the same check on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

import torch

from eadgan_tpu_torch.data.celeba import _synthetic_faces
from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.train.chain import snapshot_state
from eadgan_tpu_torch.train.checkpoint import train_state_payload
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.utils.profiler import PIPELINES, build_step

__all__ = ["run_stop_check", "mismatches", "main"]


def _flatten(obj, prefix=""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _flatten(v, f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _flatten(v, f"{prefix}/{i}")
    else:
        yield prefix, obj


def mismatches(a: dict, b: dict) -> tuple:
    """``(compared tensors, paths that differ)`` of two host train states
    (``train_state_payload``): tensors by dtype, shape and bits, every
    other leaf by ``==``."""
    fa, fb = dict(_flatten(a)), dict(_flatten(b))
    bad = sorted(set(fa) ^ set(fb))
    tensors = 0
    for path in sorted(set(fa) & set(fb)):
        x, y = fa[path], fb[path]
        if isinstance(x, torch.Tensor):
            tensors += 1
            same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x, y))
        else:
            same = x == y
        if not same:
            bad.append(path)
    return tensors, bad


@contextlib.contextmanager
def _cudnn_deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def run_stop_check(pipeline: str = "celeba", batch: int = 128, chain: int = 32,
                   stop_at: int = 40, n_images: int = 8192, device: str = "cuda") -> dict:
    """Runs A and B (see the module docstring); returns the report, with
    the warp's launches in run A (``warp_launches``) and both runs'
    seconds."""
    state0, step, data, prep = build_step(pipeline, batch, device=device)
    if pipeline == "celeba":
        data = _synthetic_faces(n=n_images, size=64, seed=0)
    on_card = torch.device(device).type == "cuda"

    def run(**kw):
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run_epochs(n_epochs=1 << 20, data=data, batch_size=batch,
                         state=snapshot_state(state0), step_fn=step, device=device,
                         chain=chain, **prep, **kw)
        if on_card:
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    stop, ends, seen = threading.Event(), [], {}

    def on_batch(i, state, metrics, batches):
        ends.append(i + 1)
        if i >= stop_at and not stop.is_set():
            seen["flag_window_end"] = i + 1
            stop.set()

    def on_shutdown(final_step, state):
        seen["state"] = train_state_payload(state)  # the final save's copies
        seen["step"] = final_step

    with _cudnn_deterministic():
        before = stn_cuda.launch_count
        _, seconds_a = run(on_batch=on_batch, stop_event=stop, on_shutdown=on_shutdown)
        warps = stn_cuda.launch_count - before
        stopped = seen.get("step", -1)
        state_b, seconds_b = run(on_batch=lambda *a: None, max_steps=max(stopped, 1))
        b = train_state_payload(state_b)
    compared, bad = mismatches(seen.get("state", {}), b)
    return {
        "stop_check": pipeline, "device": str(device), "batch": batch, "chain": chain,
        "stop_at": stop_at, "stopped_at": stopped, "window_ends": ends,
        "cut_short": getattr(stop, "cut_short", None), "step_b": state_b.step,
        "tensors_compared": compared, "mismatched": bad[:10], "warp_launches": warps,
        "seconds": [seconds_a, seconds_b],
        "ok": bool(compared) and not bad and getattr(stop, "cut_short", False) is True
        and stopped == seen.get("flag_window_end") == ends[-1] and stopped <= stop_at + chain
        and state_b.step == stopped,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=PIPELINES, default="celeba")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--chain", type=int, default=32)
    parser.add_argument("--stop_at", type=int, default=40)
    parser.add_argument("--n_images", type=int, default=8192)
    parser.add_argument("--device", default="cuda")
    opt = parser.parse_args(argv)
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for the CPU")
    report = run_stop_check(opt.pipeline, opt.batch, opt.chain, opt.stop_at, opt.n_images,
                            opt.device)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
