"""The training driver: a configuration's trainer driven through the
port's chained engine, ``train/engine.py::run_epochs``, as its CLI calls
it, for one run.

Set-up builds one train state from the run's seed (the stand-in dataset,
the weights, the step's generator) and drives it through its first
``correctness_steps`` steps with a ``run_epochs`` call of its own (call
A): the same call, step and feed as the window's, on rows that all
differ; its first step runs eagerly and the rest are replays of the graph
it captures, as in the window.  Call A declares an event at every step,
so each step ends a window of one and the engine's event worker copies
the state after it (models and Adams) to the host, from which each
step's gradients are worked out; the logger keeps each step's losses;
after the call the parameters' change since the start is read.  The same state then goes to
the measured call (call B), with the CLI's callbacks at the CLI's
cadence, a ``MetricLogger`` of the CLI's and a stop event.  The measured
window opens when call B's second window has drained (its first holds
the eager step and the capture) and closes at the drain of the window in
which the stop event, set ``--seconds`` after the opening, is seen.

In a traced run (``--trace 1``) the program's own spans and counters
(``eadgan_tpu_torch/utils/trace.py``) are on for call B alone: reset and
enabled before it, collected after it, their counters read again when
the window opens; call A stays untraced.  A program without that module
records nothing, and the readers of its spans and counters find nothing.

Once the window has closed, the peak memory is read and the program's
state freed, and the reference trains the same first steps in float32
from the same weights, rows, flips and draws; :mod:`harness.compare`
holds the two runs' readings against each other.
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import threading
import time

import torch

from counts.step import step_flops
from counts.warp import warp_bytes
from counts.work import kernel_work
from harness import compare, datasets, spec, tracing, weights as weights_mod
from harness.schedule import first_batches
from harness.seeds import derive


class Window:
    """The measured window, kept by the logger's calls: each drained step
    is stamped on the host clock; the step that ends the second window
    opens it, arms the stop and (traced) starts the profiler, whose
    stretch runs from the end of the next window over the next
    ``profile_windows`` windows.  With the program's ``tracer`` its
    counters are read as the window opens."""

    def __init__(self, open_step, stretch_begin, stretch_end, seconds, stop, stretch, tracer=None):
        self.open_step = open_step
        self.stretch_begin = stretch_begin
        self.stretch_end = stretch_end
        self.seconds = seconds
        self.stop = stop
        self.stretch = stretch
        self.tracer = tracer
        self.counters_open = None
        self.t_open = None
        self.t_last = None
        self.last_step = None
        self.timer = None
        self.t_stretch_end = None

    def on_step(self, step: int) -> None:
        now = time.perf_counter()
        if step == self.open_step:
            self.t_open = now
            self.timer = threading.Timer(self.seconds, self.stop.set)
            self.timer.daemon = True
            self.timer.start()
            if self.stretch is not None:
                self.stretch.start()
            if self.tracer is not None:
                self.counters_open = self.tracer.collect()["counters"]
        elif self.t_open is not None:
            self.t_last, self.last_step = now, step
            if self.stretch is not None and step == self.stretch_begin:
                self.stretch.begin()
            if self.stretch is not None and step == self.stretch_end and self.stretch.started:
                self.stretch.stop()
                self.stretch.steps = self.stretch_end - self.stretch_begin
                self.t_stretch_end = time.perf_counter()

    def close(self) -> None:
        if self.timer is not None:
            self.timer.cancel()
            self.timer.join()


def _logger(base, on_step):
    class Logger(base):
        def log(self, step, metrics, **kw):
            on_step(step, metrics)
            super().log(step, metrics, **kw)

    return Logger


def _windows_of(plan_windows, start, chain, periods, n_batches, count=64):
    """The last steps of the first ``count`` windows the engine runs from
    ``start``: each epoch's remaining steps planned on their own."""
    ends = []
    s = start
    while len(ends) < count:
        epoch_end = (s // n_batches + 1) * n_batches
        for ws, k in plan_windows(s, epoch_end - s, chain, periods):
            ends.append(ws + k - 1)
        s = epoch_end
    return ends


def _program_tracer():
    """The program's span and counter module, or None where the program
    has none."""
    try:
        from eadgan_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _mark(ctx, what: str) -> None:
    """Set-up's progress on standard error: seconds since the process began."""
    print(f"setup {what}: {time.perf_counter() - ctx.t_start:.3f} s", file=sys.stderr, flush=True)


class FirstSteps:
    """What set-up leaves: the program with its state after its first
    steps, the call's arguments, the first steps' readings and what the
    reference needs to train them again."""


def first_steps(ctx) -> FirstSteps:
    """Set-up up to the measured call: the stand-in data, the weights, the
    program's state, and call A over the first steps."""
    from eadgan_tpu_torch.cli.common import disable_tf32
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils import MetricLogger

    cell, traffic, cfg = ctx.cell, ctx.cell.traffic, ctx.cell.config
    device = ctx.device
    batch = traffic["batch_size"]
    n_first = traffic["correctness_steps"]
    f = FirstSteps()
    f.ref = spec.reference(cell.config_name, ctx.bench_dir)
    prog = spec.program(cell.config_name, ctx.bench_dir)
    disable_tf32()

    _mark(ctx, "imports")
    data = datasets.make(cfg["data"], derive(ctx.seed, "data"), device, cfg["model"]["img_size"])
    _mark(ctx, "dataset")
    f.weights = weights_mod.make(f.ref.init_spec(cfg), derive(ctx.seed, "weights"), device)
    f.rng_seed, feed_seed = derive(ctx.seed, "draws"), derive(ctx.seed, "feed")
    p = prog.TrainProgram(cfg, batch, f.weights, f.rng_seed, device)
    if ctx.fault is not None:
        p.step = ctx.fault(p)
    _mark(ctx, "weights and program")
    start_params = {f"{k}.{n}": t.detach().clone() for k, m in p.models.items()
                    for n, t in m.named_parameters()}
    f.common = dict(n_epochs=traffic["epochs"], data=data, batch_size=batch, step_fn=p.step,
                    device=device, seed=feed_seed, chain=traffic["chain"], **p.run_kwargs)

    # call A: the first steps, through the window's own call and feed
    first = {"losses": {}, "change": {}}
    f.states = []

    def keep_loss(step, metrics):
        first["losses"][step] = {k: float(v) for k, v in metrics.items()}

    def keep_state(step, state, metrics, b):
        f.states.append(compare.host_state({k: getattr(state, k) for k in p.MODELS},
                                           {o: getattr(state, o) for o in p.OPTIMIZERS}))

    with contextlib.redirect_stdout(sys.stderr):
        f.state = run_epochs(state=p.state, on_batch=keep_state, max_steps=n_first,
                             logger=_logger(MetricLogger, keep_loss)(None, print_every=10 ** 9),
                             **dict(f.common, chain_periods=(1,)))
    if len(f.states) != n_first:
        raise RuntimeError(f"call A kept {len(f.states)} states of {n_first} steps")
    first["steps"] = compare.step_grads(f.states, cfg["optimizer"]["b1"])
    _mark(ctx, "first steps")
    first["change"] = compare.change_norms(
        {f"{k}.{n}": t for k, m in p.models.items() for n, t in m.named_parameters()}, start_params)
    f.first = first
    f.batches = [(data[rows], mask) for rows, mask in
                 first_batches(data.shape[0], batch, n_first, feed_seed, cfg["data"]["flip"])]
    f.program = p
    return f


def run(ctx) -> dict:
    from eadgan_tpu_torch.train.chain import plan_windows
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils import MetricLogger

    cell, traffic, cfg = ctx.cell, ctx.cell.traffic, ctx.cell.config
    device = ctx.device
    batch, chain = traffic["batch_size"], traffic["chain"]
    f = first_steps(ctx)
    p, state, common, data = f.program, f.state, f.common, f.common["data"]
    n_batches = data.shape[0] // batch
    out_dir = tempfile.mkdtemp(prefix="bench-train-", dir=os.environ.get("TMPDIR"))

    # call B: the measured window
    ends = _windows_of(plan_windows, state.step, chain, common["chain_periods"], n_batches)
    open_step = ends[1]
    profile = traffic["profile_windows"]
    stretch = tracing.Stretch() if ctx.trace else None
    tracer = _program_tracer() if ctx.trace else None
    stop = threading.Event()
    window = Window(open_step, ends[2], ends[2 + profile], ctx.seconds, stop, stretch, tracer)
    if ctx.trace:
        tracing.warm_up()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    program = None
    try:
        if tracer is not None:
            tracer.reset()
            tracer.enable()
        with contextlib.redirect_stdout(sys.stderr):
            state = run_epochs(
                state=state, on_batch=p.cli_on_batch(out_dir, data.shape[0]),
                logger=_logger(MetricLogger, lambda s, m: window.on_step(s))(
                    None, print_every=p.print_every),
                stop_event=stop, **common)
        if tracer is not None:
            program = tracer.collect()
    finally:
        window.close()
        if tracer is not None:
            tracer.disable()
    if window.t_open is not None:
        print(f"setup window opened: {window.t_open - ctx.t_start:.3f} s", file=sys.stderr)
    if window.t_open is None or window.last_step is None:
        raise RuntimeError("the measured window never opened: the run ended before its third window")
    steps = window.last_step - window.open_step
    window_s = window.t_last - window.t_open
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    stretch_rec = stretch.reduce() if stretch is not None else None
    shutil.rmtree(out_dir, ignore_errors=True)
    del state, p, common, data, f.state, f.program, f.common
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the program is freed
    ref_first = compare.reference_first_steps(f.ref, cfg, f.weights, f.batches, f.rng_seed, device)
    followed = compare.followed_grads(f.ref, cfg, f.weights, f.states, f.batches, f.rng_seed, device)
    checks = compare.with_limits(compare.train_gaps(f.first, ref_first, followed),
                                 spec.limits(cell.name, ctx.bench_dir))
    result = {
        "attempted": steps, "failed": 0, "checks": checks, "memory_peak_bytes": memory_peak,
        "end_to_end": {"train_img_per_s": (steps * batch / window_s, "img/s")},
        "window_s": window_s, "setup_s": window.t_open - ctx.t_start,
    }
    if ctx.trace:
        # the rate outside the profiled stretch (the profiler slows what it traces)
        after = None
        if window.t_stretch_end is not None and window.last_step > window.stretch_end:
            after = {"seconds": window.t_last - window.t_stretch_end,
                     "steps": window.last_step - window.stretch_end, "batch": batch}
        result["records"] = {
            "stretch": stretch_rec, "window": after,
            "flops_per_step": step_flops(f.ref, cfg, batch), "compute": cfg["compute"],
            "work": kernel_work(f.ref, cfg, batch, cell.config_name, ctx.bench_dir),
            "warp": {"bytes_per_launch": warp_bytes(batch, cfg["model"]["img_size"], cfg["model"]["img_size"],
                                                  cfg["model"]["channels"]),
                     "launches_per_step": cfg["program"]["warps_per_step"]},
        }
        if program is not None and window.counters_open is not None:
            # the program's spans and counters of call B, on the host clock of t_open
            result["records"]["program"] = dict(
                program, counters_open=window.counters_open,
                t_open_ns=int(window.t_open * 1e9), t_close_ns=int(window.t_last * 1e9))
    return result

