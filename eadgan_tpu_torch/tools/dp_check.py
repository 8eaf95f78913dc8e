"""Data-parallel training in a group of one against the plain engine.

``python -m eadgan_tpu_torch.tools.dp_check [--pipeline celeba|pxy|rp|
rp_color|pxy_color|mnist] [--compute bf16|f32] [--steps 64] [--chain 32]
[--batch 128]`` builds one pipeline's train state and synthetic dataset
(``utils/profiler.py::build_step``; CelebA with ``steps`` batches of
faces, so no epoch end cuts a window), joins a process group of one on
the card (``parallel.join_local``: NCCL) and runs ``--steps`` steps of
``train/engine.py::run_epochs`` chained three times, each from a copy of
that state, under cuDNN's deterministic algorithms:

* plain (``data_parallel=False``);
* ``data_parallel=True``: the step inside ``parallel.data_axis``, its
  gradient, BatchNorm and metric all-reduces captured in the CUDA graph;
* ``data_parallel=True, zero_opt=True``: Adam over this rank's slices
  (all of each parameter at a world size of 1), gathered back.

A sum over one rank and a division by 1.0 are exact, so the check passes
when every logged loss and every tensor of the three final states (the
Adam moments included) are bit-equal and each run launched the warp its
pipeline's count a step.  It also reports the collectives one step
issues (``parallel.mesh.collective_count``, from an eager step of each
form) and the replayed step of each form, timed as ``chip_smoke.py``'s
phase 5 times a step (``utils/profiler.py::chained_replays``: after the
eager step and the capture, windows of ``--chain`` replays between CUDA
events, the median over the windows, over ``--chain``), in the order
plain, dp, zero, zero, dp, plain.  With ``profile`` (the CLI's
``--profile``), one more window of each form runs under
``torch.profiler``: its kernels a step and their device time a step, and
the kernels by name whose time a step the data-parallel form adds to the
plain one, and ZeRO to the data-parallel one.

Prints one JSON line; exits non-zero when the check fails.  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys

import torch

from eadgan_tpu_torch import parallel
from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.parallel.mesh import collective_count
from eadgan_tpu_torch.tools.chain_check import WARPS_PER_STEP, _cudnn_deterministic, _Records
from eadgan_tpu_torch.train.chain import snapshot_state
from eadgan_tpu_torch.train.checkpoint import train_state_payload
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.utils.profiler import PIPELINES, build_step, chained_replays, step_args

__all__ = ["FORMS", "run_dp_check", "main"]

# (data_parallel, zero_opt) of each form
FORMS = {"plain": (False, False), "dp": (True, False), "zero": (True, True)}


def _equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _prepared(state0, step, form):
    """A copy of ``state0`` and ``step`` as ``run_epochs`` runs them in
    ``form``."""
    state = snapshot_state(state0)
    data_parallel, zero = FORMS[form]
    if data_parallel:
        parallel.replicate(state)
        if zero:
            parallel.zero_place(state)
        step = parallel.data_parallel_step(step)
    return state, step


def _kernels_per_step(run, chain: int) -> dict:
    """``{kernel name: [launches, device ms]}`` a step over one window of
    ``run()`` under ``torch.profiler`` (CUPTI sees the graph's kernels)."""
    from torch.profiler import ProfilerActivity, profile

    per = collections.defaultdict(lambda: [0.0, 0.0])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                e, "is_user_annotation", False):
            per[e.name][0] += 1 / chain
            per[e.name][1] += e.time_range.elapsed_us() / 1e3 / chain
    return dict(per)


def _added(more: dict, less: dict, top: int = 10) -> list:
    """The kernels by name whose device time a step ``more`` adds to
    ``less``, largest first."""
    names = set(more) | set(less)
    diff = {n: (more.get(n, [0, 0])[0] - less.get(n, [0, 0])[0],
                more.get(n, [0, 0])[1] - less.get(n, [0, 0])[1]) for n in names}
    return [{"name": n[:120], "launches_per_step": c, "device_ms_per_step": ms}
            for n, (c, ms) in sorted(diff.items(), key=lambda kv: -kv[1][1])[:top] if ms > 0]


def run_dp_check(pipeline: str = "celeba", dtype=torch.bfloat16, steps: int = 64, chain: int = 32,
                 batch: int = 128, device="cuda", time_windows: int = 2,
                 profile: bool = False) -> dict:
    """The three runs, the collective counts, (``time_windows`` > 0) the
    timing and (``profile``) the kernels of each form; returns the report
    (see the module docstring)."""
    device = parallel.join_local(device)
    state0, step, data, prep = build_step(pipeline, batch, dtype, device=device)
    if pipeline == "celeba":
        from eadgan_tpu_torch.data.celeba import _synthetic_faces

        data = _synthetic_faces(n=steps * batch, size=64, seed=0)
    n_epochs = -(-steps // (data.shape[0] // batch))
    report = {"dp_check": pipeline, "compute": "bf16" if dtype == torch.bfloat16 else "f32",
              "batch": batch, "steps": steps, "chain": chain, "world_size": 1,
              "backend": parallel.multihost.backend()}
    runs, launches = {}, {}
    with _cudnn_deterministic():
        for form, (data_parallel, zero) in FORMS.items():
            records = _Records()
            stn_cuda.reset_launch_count()  # counts from here read this run only
            state = run_epochs(
                n_epochs=n_epochs, data=data, batch_size=batch, state=snapshot_state(state0),
                step_fn=step, on_batch=lambda *a: None, device=device, max_steps=steps,
                logger=records, chain=chain, data_parallel=data_parallel, zero_opt=zero, **prep,
            )
            if device.type == "cuda":
                torch.cuda.synchronize()
            launches[form] = stn_cuda.launch_count
            runs[form] = (records.steps, train_state_payload(state))
            del state
        args = step_args(data, prep, batch, device)
        per_step = {}
        for form in ("dp", "zero"):
            state, dp_step = _prepared(state0, step, form)
            before = collective_count()
            dp_step(state, *args)
            per_step[form] = collective_count() - before
            del state
    plain_records, plain_state = runs["plain"]
    report.update({
        "logged_steps": sorted(plain_records),
        "losses_equal": {f: runs[f][0] == plain_records for f in ("dp", "zero")},
        "states_equal": {f: _equal(runs[f][1], plain_state) for f in ("dp", "zero")},
        "last_losses": plain_records[max(plain_records)] if plain_records else None,
        "warp_launches": launches,
        "expected_warp_launches": WARPS_PER_STEP.get(pipeline, 0) * steps,
        "all_reduces_per_step": per_step,
    })
    if time_windows:
        times = {f: [] for f in FORMS}
        for form in ("plain", "dp", "zero", "zero", "dp", "plain"):
            state, form_step = _prepared(state0, step, form)
            run = chained_replays(state, form_step, data, prep, batch, chain)
            torch.cuda.synchronize()
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(time_windows + 1)]
            marks[0].record()
            for i in range(time_windows):
                _, packed = run()
                marks[i + 1].record()
            torch.cuda.synchronize()
            windows = [a.elapsed_time(b) / chain for a, b in zip(marks, marks[1:])]
            times[form].append(statistics.median(windows))
            report.setdefault("metrics_finite", True)
            report["metrics_finite"] &= bool(torch.isfinite(packed).all())
            del state, run
        report["replayed_ms_cuda_events"] = times
        report["replayed_ms_median"] = {f: statistics.median(t) for f, t in times.items()}
        report["minus_plain_ms"] = {f: report["replayed_ms_median"][f]
                                    - report["replayed_ms_median"]["plain"] for f in ("dp", "zero")}
    if profile:
        kernels = {}
        for form in FORMS:
            state, form_step = _prepared(state0, step, form)
            run = chained_replays(state, form_step, data, prep, batch, chain)
            run()
            kernels[form] = _kernels_per_step(run, chain)
            del state, run
        report["profile"] = {
            "per_form": {f: {"kernels_per_step": sum(c for c, _ in k.values()),
                             "kernel_ms_per_step": sum(ms for _, ms in k.values())}
                         for f, k in kernels.items()},
            "dp_adds": _added(kernels["dp"], kernels["plain"]),
            "zero_adds": _added(kernels["zero"], kernels["dp"]),
        }
    report["ok"] = bool(
        report["logged_steps"] == list(range(steps))
        and all(report["losses_equal"].values()) and all(report["states_equal"].values())
        and all(v == report["expected_warp_launches"] for v in launches.values())
        and report.get("metrics_finite", True)
    )
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--pipeline", choices=[p for p in PIPELINES if p != "approximator"],
                        default="celeba")
    parser.add_argument("--compute", choices=["bf16", "f32"], default="bf16")
    parser.add_argument("--steps", type=int, default=64)
    parser.add_argument("--chain", type=int, default=32)
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--profile", action="store_true",
                        help="also trace one window of each form: kernels a step and what DP adds")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the data-parallel check needs the card")
    report = run_dp_check(opt.pipeline, torch.bfloat16 if opt.compute == "bf16" else None,
                          opt.steps, opt.chain, opt.batch, profile=opt.profile)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
