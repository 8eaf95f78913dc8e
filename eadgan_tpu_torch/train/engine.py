"""Training engines: the epoch/batch loops a trainer runs its step under.

PyTorch counterpart of the single-device paths of
``eadgan_tpu/train/engine.py``.  Both engines draw the same epoch
permutations from ``np.random.default_rng(seed)`` and the same per-batch
flip masks from ``np.random.default_rng([seed, 0x464C4950])``, one draw
per batch in batch order (:func:`_schedule`), so both packages feed their
steps the same batches:

* the **per-step engine** (``chain=1``) gathers, normalizes and flips
  each batch on a :class:`~eadgan_tpu_torch.data.loader.Prefetcher`
  thread (uint8 images through the native batcher of ``data/native.py``,
  MNIST's float32 ones in numpy) into pinned memory, copies it to the
  card on a stream of its own while the current step runs, and calls the
  step on it;
* the **chained engine** (``chain > 1``, the CLIs' default) runs windows
  of up to ``chain`` steps through ``train/chain.py``: on the card, one
  CUDA graph of the step replayed per step, each batch gathered on the
  card from the resident dataset (uint8 images, or MNIST's float32
  images already in [-1, 1]), or, for a dataset above
  ``EADGAN_DEVICE_DATA_MAX`` bytes, from raw windows gathered on the host
  by a prefetch thread; side effects run at the window ends that
  ``plan_windows`` puts on the event steps, on a background
  ``EventWorker`` against a snapshot of the state (``EADGAN_SYNC_EVENTS=1``
  runs them inline).

A run resumed at a step inside an epoch starts from fresh generators, as
the JAX engines do: the resumed epoch draws a fresh permutation and runs
only its remaining ``n_batches - start_step % n_batches`` batches, taken
from the start of that permutation (the rows the JAX CLI's default
chained engine gives those steps, ``plan_windows``), and the run ends at
the planned total, ``n_epochs * n_batches``.  (The JAX chained engine
plans a whole epoch from the resume point and so runs past that total;
the port does not copy that.)

With ``data_parallel`` both engines run on the ``data`` axis of
``parallel/`` and keep the JAX engine's multi-process contract: every
rank draws the same batches and flips and gathers its own rows of each,
rank 0 alone logs and runs ``on_batch``, and a stop is a gang decision
(:class:`_GangStopView`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from eadgan_tpu_torch.data import native
from eadgan_tpu_torch.data.loader import PinnedStager, Prefetcher, Staged
from eadgan_tpu_torch.models.layers import no_stat_updates
from eadgan_tpu_torch.parallel.mesh import shard_window
from eadgan_tpu_torch.train.chain import (
    EventWorker,
    LazyHostBatch,
    LazyLastMetrics,
    make_chained_step,
    normalize_prepare,
    plan_windows,
    snapshot_state,
)
from eadgan_tpu_torch.utils import trace
from eadgan_tpu_torch.utils.logging import MetricLogger

__all__ = ["run_epochs", "epoch_batches", "generator_apply"]

_FLIP_STREAM = 0x464C4950
_PREFETCH_DEPTH = 2  # batches or windows a prefetch thread prepares ahead of the step
_DEVICE_DATA_MAX = 4 << 30  # EADGAN_DEVICE_DATA_MAX's default, as in the JAX engine


def _schedule(n_rows, batch_size, n_epochs, seed, start_step, stop, chain=1, chain_periods=(),
              random_flip=False, rows=slice(None)):
    """Yield ``(epoch, start, k, idx, mask)`` for each window of up to
    ``chain`` steps (``plan_windows``) from step ``start_step`` up to
    ``stop``: ``idx`` the (k, b) row indices, ``mask`` the (k, b) flip
    masks (None without ``random_flip``), cut to this rank's ``rows``.
    For each epoch a permutation of the rows, cut into full batches (the
    ragged tail is dropped); the epoch holding ``start_step`` takes its
    remaining batches from the start of its permutation.  The masks are
    drawn for the whole batch, one draw per batch in batch order, so every
    rank and every ``chain`` sees the same stream."""
    host_rng = np.random.default_rng(seed)
    flip_rng = np.random.default_rng([seed, _FLIP_STREAM])
    n_batches = n_rows // batch_size
    s = start_step
    epoch = s // max(n_batches, 1)
    while epoch < n_epochs and s < stop:
        perm = host_rng.permutation(n_rows)
        epoch_end = min((epoch + 1) * n_batches, stop)
        first = s
        for ws, k in plan_windows(s, epoch_end - s, chain, chain_periods, stop):
            idx = perm[(ws - first) * batch_size : (ws - first + k) * batch_size]
            idx = idx.reshape(k, batch_size)
            mask = None
            if random_flip:
                mask = shard_window(np.stack([flip_rng.random(batch_size) < 0.5 for _ in range(k)]),
                                    rows)
            yield epoch, ws, k, shard_window(idx, rows), mask
        s = epoch_end
        epoch += 1


def epoch_batches(
    data: np.ndarray, batch_size: int, n_epochs: int, seed: int = 0,
    start_step: int = 0, scale: float = 1.0, shift: float = 0.0,
    random_flip: bool = False, rows: slice = slice(None),
):
    """Yield ``(epoch, host_batch)``, the batches the per-step engine
    trains on from step ``start_step`` on (:func:`_schedule`), each made
    by the plain numpy gathers of ``data/native.py``: float32 ``x * scale
    + shift`` of ``data`` (uint8, or float32 taken with scale 1 and shift
    0, which leave it as it is) and, with ``random_flip``, mirrored along
    the width where a fresh draw is below 0.5.  A 3-D (N, H, W) ``data``
    (dSprites) gains a channel axis, (B, H, W, 1), as the JAX engine's
    ``add_channel`` gives it.  ``rows`` keeps those rows of each batch (a
    data-parallel rank's slice, ``parallel.host_batch_slice``).  The
    reference the engines' batches are held to (the profiler's first
    batch, the tests)."""
    total = n_epochs * (data.shape[0] // batch_size)
    for epoch, _, _, idx, mask in _schedule(data.shape[0], batch_size, n_epochs, seed, start_step,
                                            total, random_flip=random_flip, rows=rows):
        if random_flip:
            yield epoch, native.gather_normalize_flip_plain(data, idx[0], mask[0], scale, shift)
        else:
            yield epoch, native.gather_normalize_plain(data, idx[0], scale, shift)


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
    chain: int = 1,
    chain_periods: tuple = (),
    watchdog: float = 0.0,
    stop_event=None,
    on_shutdown: Optional[Callable] = None,
    profile_dir: str = "",
    data_parallel: bool = False,
    zero_opt: bool = False,
):
    """The reference's epoch/batch double loop.

    ``step_fn(state, batch) -> (state, metrics)`` with ``batch`` a
    contiguous float32 NHWC tensor on ``device``;
    ``on_batch(batches_done, state, metrics, (batch,))`` handles sampling
    and checkpoint side effects.  Metrics stay device tensors: the
    logger converts them only when it prints or writes.  ``max_steps``
    stops after that many steps (0: the whole schedule).  Closes
    ``logger`` at the end.

    ``chain > 1`` runs the chained engine (:func:`_run_epochs_chained`):
    ``chain_periods`` are the intervals of ``on_batch``'s side effects,
    and ``on_batch`` runs only at window ends that are multiples of one
    of them (every window end when there are none), where the state is
    the true post-step state.  Every trainer's callback gates itself on
    those intervals, so what it writes is what the per-step engine
    writes.

    ``stop_event`` (a ``threading.Event``; the CLIs pass their SIGTERM
    guard's, ``utils/preempt.py``) asks for a graceful early stop.  The
    per-step engine stops after the step in which it sees the flag set;
    the chained engine at the end of the window in which it sees it,
    after that window's events are queued.  Then the last window's
    metrics are drained, the event worker is closed (every queued
    cadence save is written, so a final save is the newest file and
    ``checkpoint.prune_saved`` stays anchored on it), and only then
    ``on_shutdown(final_step, state)`` is called once, with the live
    state.  On the card the graph's replays wrote that state in place on
    the current stream, and ``on_shutdown`` runs on the same stream, so
    its copies to the host are ordered after the last replay
    (``chip_smoke.py``'s robustness phase checks the state it sees bit
    for bit against a run that ends at the same step).  After a stop,
    ``stop_event.cut_short`` says whether the stop cut the schedule short
    (``final_step`` below the planned end): a stop that lands on a
    finished schedule is no preemption (``cli/common.py::
    exit_if_preempted``).

    ``watchdog`` > 0 arms a :class:`~eadgan_tpu_torch.utils.watchdog.
    Watchdog` of that many seconds.  It is beaten only on progress the
    device has proven: in the per-step engine once a step's metrics are
    on the host, in the chained engine once ``drain`` has waited for a
    window's metrics, and after an inline event (a save on the main
    thread holds the loop for seconds, and its copies to the host wait
    for the window).  The window that captures the
    CUDA graph runs under a grace that its drain releases.
    ``EADGAN_FAULT_HANG_STEP=N`` (a drill hook) makes the first beat at a
    step >= N hang forever, as a wedged call would; with
    ``EADGAN_FAULT_HANG_MARKER=<path>`` the hang creates that file and a
    process that finds it already there does not hang, so a supervised
    restart survives.  ``profile_dir`` wraps the run in
    :func:`~eadgan_tpu_torch.utils.profiler.chrome_trace`.
    ``EADGAN_TRACE=<path>`` turns the port's spans and counters on for
    the run (``utils/trace.py``, dropping what was recorded before) and
    writes them to ``<path>`` as JSON at its end.

    ``data_parallel`` trains on the ``data`` axis of ``parallel/``: each
    rank of the process group (one of a world size of 1 is joined on
    ``device`` when there is none, ``parallel.join_local``) takes its
    slice of every global batch of ``batch_size``, the state is
    broadcast from rank 0, and the step runs inside
    ``parallel.data_axis`` (gradients, BatchNorm statistics and the
    logged metrics averaged over the ranks; on the card the chained
    engine's graph captures those all-reduces).  ``zero_opt`` (with
    ``data_parallel`` and ``chain`` > 1, as in the JAX package) shards
    the Adam moments (``parallel.zero_place``).  Multi-process contract,
    after the JAX engine's: rank 0 alone runs ``on_batch`` and logs;
    ``stop_event`` becomes a gang decision, polled once a window (a step
    in the per-step engine) and once after the loop on every rank
    (``parallel.any_process_flag``), so a SIGTERM to any rank stops every
    rank at one boundary and sets every rank's event; ``on_shutdown``
    then runs on every rank, so a final save must be collective
    (``checkpoint.save_train_state_sync``).  Ranks that share a card
    over gloo run the per-step engine: ``chain`` > 1 raises there.

    A state sharded over a model axis (``parallel.shard_model_params``)
    raises ``ValueError``: the JAX engine builds its mesh at
    ``model_parallel=1`` only, and rank 0's grids and saves, run alone,
    would wait forever on a model group's gather.  A grid trains through
    the library API (``parallel.data_parallel_step`` with its mesh).
    """
    from eadgan_tpu_torch.parallel.mesh import has_model_shards

    if has_model_shards(state):
        raise ValueError(
            "run_epochs trains at model_parallel=1: this state is sharded over a model axis "
            "(parallel.shard_model_params); step it with parallel.data_parallel_step(step, mesh)"
        )
    if zero_opt and not (data_parallel and chain > 1):
        raise ValueError(
            "--zero_opt shards optimizer state over the data axis: it requires "
            "--data_parallel and the chained engine (--chain > 1)"
        )
    if random_flip and data.dtype != np.uint8:
        raise ValueError("random_flip requires the uint8 image ingest path")
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    from eadgan_tpu_torch.utils.profiler import chrome_trace

    device = torch.device(device)
    rows = slice(None)
    local_stop = stop_event
    coordinator = True
    if data_parallel:
        from eadgan_tpu_torch import parallel
        from eadgan_tpu_torch.parallel import multihost

        device = parallel.join_local(device)
        if chain > 1 and device.type == "cuda" and multihost.backend() == "gloo":
            raise ValueError(
                "gloo collectives cannot be captured in a CUDA graph: ranks that share a card "
                "over gloo (EADGAN_DIST_BACKEND=gloo) train with the per-step engine, --chain 1"
            )
        mesh = parallel.default_mesh()
        rows = parallel.host_batch_slice(batch_size, mesh)
        state = parallel.replicate(state)
        if zero_opt:
            parallel.zero_place(state, mesh)
        step_fn = parallel.data_parallel_step(step_fn, mesh)
        coordinator = parallel.is_coordinator()
        if stop_event is not None and multihost.process_count() > 1:
            stop_event = _GangStopView(stop_event)
    if not coordinator:
        on_batch = None
        if logger is not None:
            logger.close()
            logger = None

    n_batches = data.shape[0] // batch_size
    start_step = state.step
    total = n_epochs * n_batches
    planned_end = min(total, start_step + max_steps) if max_steps else total
    wd = None
    if watchdog:
        from eadgan_tpu_torch.utils.watchdog import Watchdog

        wd = Watchdog(watchdog).start()
    beat, grace, clear_grace = _heartbeat(wd)
    trace_path = os.environ.get("EADGAN_TRACE", "")
    if trace_path:
        trace.reset()
        trace.enable()
    loop = dict(
        n_epochs=n_epochs, data=data, batch_size=batch_size, state=state, step_fn=step_fn,
        on_batch=on_batch, device=device, seed=seed, max_steps=max_steps,
        logger=logger, metric_keys=metric_keys, scale=scale, shift=shift,
        random_flip=random_flip, beat=beat, stop_event=stop_event, rows=rows,
    )
    try:
        with chrome_trace(profile_dir or None):
            if chain > 1:
                state = _run_epochs_chained(**loop, chain=chain, chain_periods=chain_periods,
                                            grace=grace, clear_grace=clear_grace)
            else:
                state = _run_epochs_per_step(**loop, verify_progress=wd is not None)
            # in a gang, one more collective poll, on every rank once
            if stop_event is not None and stop_event.is_set():
                final_step = state.step
                local_stop.cut_short = final_step < planned_end
                if on_shutdown is not None:
                    # one write a line: the ranks may share a stdout, and an
                    # unbuffered print writes the text and its newline apart
                    if coordinator:
                        print(f"graceful shutdown: saving final train state at step {final_step}\n",
                              end="", flush=True)
                    else:  # every rank says where it stopped
                        print(f"graceful shutdown: rank {multihost.process_index()} "
                              f"stopped at step {final_step}\n", end="", flush=True)
                    if wd is not None:
                        wd.grace()  # the save's seconds are no stall
                    t0 = time.perf_counter()
                    on_shutdown(final_step, state)
                    if coordinator:
                        print(f"graceful shutdown: final train state saved in "
                              f"{time.perf_counter() - t0:.3f} s", flush=True)
    finally:
        if wd is not None:
            wd.stop()
        if logger is not None:
            logger.close()
        if trace_path:
            trace.disable()
            trace.write(trace_path)
    return state


class _GangStopView:
    """A stop event seen by the whole gang: :meth:`is_set` ORs every
    rank's local flag (``parallel.any_process_flag``, a collective, so
    the engines poll it at the same boundaries on every rank) and, when
    the gang stops, sets the local event too, so every rank saves and
    exits 86, not only the signalled ones."""

    def __init__(self, event):
        self._event = event

    def is_set(self) -> bool:
        from eadgan_tpu_torch.parallel import any_process_flag

        if any_process_flag(self._event.is_set()):
            self._event.set()
            return True
        return False

    def set(self) -> None:
        self._event.set()


def _heartbeat(wd):
    """``(beat, grace, clear_grace)`` of the watchdog ``wd`` (no-ops
    without one), ``beat`` wrapped by the ``EADGAN_FAULT_HANG_STEP`` /
    ``EADGAN_FAULT_HANG_MARKER`` drill hook (see :func:`run_epochs`)."""
    beat = wd.beat if wd is not None else (lambda step: None)
    grace = wd.grace if wd is not None else (lambda: None)
    clear_grace = wd.clear_grace if wd is not None else (lambda: None)
    hang_at = int(os.environ.get("EADGAN_FAULT_HANG_STEP", 0) or 0)
    marker = os.environ.get("EADGAN_FAULT_HANG_MARKER", "")
    if hang_at and marker and os.path.exists(marker):
        hang_at = 0
    if hang_at:
        inner = beat

        def beat(step):
            if step >= hang_at:
                if marker:
                    open(marker, "w").close()
                print(f"fault injection: hanging at step {step}", flush=True)
                while True:
                    time.sleep(3600)
            inner(step)

    return beat, grace, clear_grace


def _run_epochs_per_step(
    *, n_epochs, data, batch_size, state, step_fn, on_batch, device, seed, max_steps, logger,
    metric_keys, scale, shift, random_flip, beat, stop_event, verify_progress, rows,
):
    """One eagerly launched step a batch, each batch (this rank's ``rows``
    of it) prepared on a :class:`~eadgan_tpu_torch.data.loader.Prefetcher`
    thread up to two batches ahead, as the JAX engine does: uint8 images
    through the native gather (``data/native.py``, with the flip masks
    drawn on that thread), float32 ones in numpy, written into pinned
    memory and copied to the card on a stream of their own
    (:class:`~eadgan_tpu_torch.data.loader.PinnedStager`); the step's
    stream waits for the copy.  The batches equal :func:`epoch_batches`'
    bit for bit.  With ``verify_progress`` (a watchdog is armed) each
    step's metrics are copied to the host before the beat, which proves
    the device finished the step.  ``on_batch`` None: no side effects (a
    rank other than 0).  Traced (``utils/trace.py``), a step's host time
    is ``engine.feed`` (the batch waited for; its ``s`` is the step),
    ``engine.step`` (the step enqueued) and ``engine.callback`` (logging,
    ``on_batch``, the beat), and ``engine.steps`` counts the steps."""
    n_batches = data.shape[0] // batch_size
    start_step = state.step
    batches_done = start_step
    total = n_epochs * n_batches
    stop = min(total, start_step + max_steps) if max_steps else total
    if data.dtype == np.uint8:
        data = np.ascontiguousarray(data)  # the native gather reads C-contiguous rows
        gather = native.gather_normalize_flip if random_flip else native.gather_normalize
    else:
        gather = native.gather_normalize_plain
    shape = native.output_shape(data, len(range(batch_size)[rows]))
    stager = PinnedStager(device, slots=_PREFETCH_DEPTH + 2)

    def place(item):
        epoch, _, _, idx, mask = item
        flip = (mask[0],) if random_flip else ()

        def fill(out):
            gather(data, idx[0], *flip, scale, shift, out=out)

        return epoch, stager.stage([(shape, np.float32, fill)])

    feed = Prefetcher(
        _schedule(data.shape[0], batch_size, n_epochs, seed, start_step, stop,
                  random_flip=random_flip, rows=rows),
        place=place, depth=_PREFETCH_DEPTH,
    )
    batches = iter(feed)
    try:
        while True:
            with trace.span("engine.feed") as fed:
                item = next(batches, None)
                if item is None:
                    break
                epoch, staged = item
                (batch,) = staged.get()
                fed.set(s=batches_done)
            with trace.span("engine.step"):
                state, metrics = step_fn(state, batch)
            with trace.span("engine.callback"):
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
                if on_batch is not None:
                    on_batch(batches_done, state, metrics, (batch,))
                batches_done += 1
                if verify_progress:
                    torch.stack([torch.as_tensor(v).float().reshape(()) for v in metrics.values()]).cpu()
                beat(batches_done)
            trace.count("engine.steps")
            if stop_event is not None and stop_event.is_set():
                break
    finally:
        feed.close()
    return state


def _run_epochs_chained(
    *, n_epochs, data, batch_size, state, step_fn, on_batch, device, seed, max_steps,
    logger, metric_keys, scale, shift, random_flip, chain, chain_periods, beat, grace,
    clear_grace, stop_event, rows,
):
    """Windows of up to ``chain`` steps through a :class:`~eadgan_tpu_torch.
    train.chain.ChainedStep` of ``step_fn``, after
    ``eadgan_tpu/train/engine.py::_run_epochs_chained``.

    A dataset of at most ``EADGAN_DEVICE_DATA_MAX`` bytes (default 4 GiB,
    as in the JAX engine) is staged on ``device`` once, as it is: uint8
    images (real CelebA, 2.4 GB, and real dSprites, 2.9 GB) or float32
    ones (real MNIST at 32x32, 246 MB); one larger than the card's free
    memory raises.  A window then carries only its (k, B) int32 row
    indices, plus the (k, B) flip masks, copied in once from pinned host
    memory, and the batches are gathered on the card.  A larger dataset
    stays on the host: each window carries its raw (k, B, H, W[, C])
    rows (uint8, which the graph flips and normalizes,
    ``normalize_prepare(gather=False)``; float32 images as they are),
    plus the flip masks, gathered on a :class:`~eadgan_tpu_torch.data.
    loader.Prefetcher` thread into pinned memory and copied to the card on
    a stream of its own while the previous windows run.  The capture of
    the graph holds that thread's CUDA calls
    (:attr:`~eadgan_tpu_torch.data.loader.PinnedStager.lock`).

    Window w + 1 is enqueued before window w's (k, M) metrics, copied to
    pinned host memory behind it, are waited for and logged one record
    per step, so the host never waits for the window it has just
    enqueued.  ``on_batch`` then runs at event window ends with the
    window's last step: its index, the state, the metrics and that
    step's batch, made on the device from the window's last row by the
    steps' own prepare.

    With ``chain_periods`` declared (and ``EADGAN_SYNC_EVENTS`` not
    ``1``) an event runs on an :class:`~eadgan_tpu_torch.train.chain.
    EventWorker`, as in the JAX engine: the host enqueues a snapshot of
    the state (:func:`~eadgan_tpu_torch.train.chain.snapshot_state`,
    cloned on the card behind the window, sharing no storage with the
    live state that the next replays write in place) and a CUDA event
    behind it, and goes on to the next window.  The worker waits for that
    event, reads the metrics from the window's pinned host copy, and calls
    ``on_batch`` on a CUDA stream of its own with the snapshot, the
    metrics as a dict and the event batch (a tensor no one else holds); it
    drops the snapshot only after every device operation it issued has
    completed.  The worker is closed in a ``finally``: every queued
    checkpoint is written, or its error raised, before the engine
    returns.  A graph capture must not overlap the worker's device work,
    so the engine waits for the worker before the window that captures;
    that window also runs under the watchdog's ``grace``, which its
    drain releases.  ``beat`` is called with a window's end once its
    metrics are on the host, and after an inline event; ``stop_event``
    is polled at the end of each window.
    Without periods, or with ``EADGAN_SYNC_EVENTS=1``, ``on_batch`` runs
    inline with the live state and lazily fetched metrics.

    Traced (``utils/trace.py``), each window is an ``engine.window`` span
    (with its ``s`` and ``k``) over ``engine.feed`` (the window's indices
    and masks made and copied, or its raw rows waited for),
    ``engine.dispatch`` (its steps enqueued; ``engine.capture`` for the
    eager first step and the capture), ``engine.drain.wait`` and
    ``engine.drain.log`` (the previous window's metrics waited for, then
    logged) and ``engine.event`` (``on_batch``, or its snapshot and
    submit); ``engine.flush`` before a capture; a last ``engine.window``
    without ``s`` drains the last window.  Consecutive window spans
    tile the loop.  A graph captured while tracing is on also stamps the
    device's phases of each replayed step, which the drain adds to the
    ``step.*`` counters (:meth:`~eadgan_tpu_torch.train.chain.
    ChainedStep.count_phases`).

    A data-parallel rank gathers its ``rows`` of each step's batch: its
    columns of the window's (k, B) indices and flip masks, drawn for the
    whole batch, or of its raw rows; a resident dataset stays whole on
    every rank's card.  ``on_batch`` None: no side effects and no
    snapshots (a rank other than 0), with the same windows, so every rank
    polls ``stop_event`` at the same window ends.
    """
    n_rows = data.shape[0]
    n_batches = n_rows // batch_size
    start_step = state.step
    total = n_epochs * n_batches
    stop = min(total, start_step + max_steps) if max_steps else total
    on_card = device.type == "cuda"
    add_channel = data.ndim == 3
    schedule = _schedule(n_rows, batch_size, n_epochs, seed, start_step, stop, chain,
                         chain_periods, random_flip, rows)

    stager = None
    if data.nbytes <= int(os.environ.get("EADGAN_DEVICE_DATA_MAX", _DEVICE_DATA_MAX)):
        if on_card:
            free, _ = torch.cuda.mem_get_info(device)
            if data.nbytes > free:
                raise RuntimeError(
                    f"the {data.nbytes / 2**30:.2f} GiB {data.dtype} dataset does not fit in the "
                    f"card's {free / 2**30:.2f} GiB of free memory, where the chained engine keeps "
                    "it (set EADGAN_DEVICE_DATA_MAX below its size to stream it in raw windows)"
                )
        prepare = normalize_prepare(scale, shift, flip=random_flip, add_channel=add_channel)
        consts = (torch.from_numpy(data).to(device),)

        def to_device(array):
            t = torch.from_numpy(np.ascontiguousarray(array))
            return t.pin_memory().to(device, non_blocking=True) if on_card else t

        def place(item):
            epoch, ws, k, idx, mask = item
            window = [to_device(idx.astype(np.int32))]
            if random_flip:
                window.append(to_device(mask))
            return epoch, ws, k, Staged(tuple(window))

        windows = map(place, schedule)
    else:
        prepare = None
        if data.dtype == np.uint8:
            prepare = normalize_prepare(scale, shift, flip=random_flip, add_channel=add_channel,
                                        gather=False)
        consts = ()
        stager = PinnedStager(device, slots=_PREFETCH_DEPTH + 2)

        def place(item):
            epoch, ws, k, idx, mask = item
            # the indices are a permutation's: in range, so no bounds pass
            specs = [(idx.shape + data.shape[1:], data.dtype,
                      lambda out: np.take(data, idx, axis=0, out=out, mode="clip"))]
            if random_flip:
                specs.append((mask.shape, np.bool_, lambda out: np.copyto(out, mask)))
            return epoch, ws, k, stager.stage(specs)

        windows = Prefetcher(schedule, place=place, depth=_PREFETCH_DEPTH)

    def batch_of(rows_):
        return prepare(consts, *rows_)[0] if prepare is not None else rows_[0]

    rng = getattr(state, "rng", None)
    chained = make_chained_step(
        step_fn, prepare, pack_keys="auto", generators=(rng,) if on_card and rng is not None else ()
    )

    async_events = (bool(chain_periods) and on_batch is not None
                    and os.environ.get("EADGAN_SYNC_EVENTS", "") != "1")
    worker = EventWorker() if async_events else None
    event_stream = torch.cuda.Stream(device) if worker is not None and on_card else None
    # the previous window: (start, k, epoch, host metrics, host stamps, ready event)
    pending = None
    grace_end = None  # the end of the window that captures, while in flight

    def drain():
        nonlocal pending, grace_end
        if pending is None:
            return
        ps, pk, pepoch, host, stamps, ready = pending
        pending = None
        if ready is not None:
            with trace.span("engine.drain.wait"):
                ready.synchronize()
        with trace.span("engine.drain.log"):
            if logger is not None:
                keys = chained.resolved_pack_keys
                values = host.numpy()
                shown = [keys.index(m) for m in metric_keys] if metric_keys else range(len(keys))
                for i in range(pk):
                    logger.log(
                        ps + i, {keys[j]: values[i, j] for j in shown}, epoch=pepoch,
                        n_epochs=n_epochs, batch=(ps + i) % n_batches, n_batches=n_batches,
                    )
            if stamps is not None:
                chained.count_phases(stamps.numpy())
            if grace_end is not None and ps + pk >= grace_end:
                grace_end = None
                clear_grace()  # the captured graph ran: the steady timeout governs
            beat(ps + pk)  # the device finished the window

    batches = iter(windows)
    stopped = False
    try:
        while True:
            with trace.span("engine.window") as window_span:
                item = None
                if not stopped:
                    with trace.span("engine.feed"):
                        item = next(batches, None)
                        if item is not None:
                            epoch, ws, k, staged = item
                            window = list(staged.get())
                if item is None:
                    drain()  # the run's end: the last window's metrics
                    break
                window_span.set(s=ws, k=k)
                capturing = chained.will_capture(window)
                if capturing:
                    if worker is not None:
                        with trace.span("engine.flush"):
                            worker.flush()
                    grace()
                    grace_end = ws + k
                    trace.count("engine.captures")
                eager = chained.runs_eagerly(window)
                with trace.span("engine.capture" if eager else "engine.dispatch"):
                    # no other thread may make CUDA calls while the graph is captured
                    with stager.lock if capturing and stager is not None else contextlib.nullcontext():
                        state, stacked = chained(state, consts, *window)
                    state.step = ws + k
                    host, stamps, ready = stacked, chained.window_stamps, None
                    if on_card:
                        host = torch.empty(stacked.shape, pin_memory=True)
                        host.copy_(stacked, non_blocking=True)
                        if stamps is not None:
                            stamps = torch.empty(stamps.shape, dtype=stamps.dtype,
                                                 pin_memory=True).copy_(stamps, non_blocking=True)
                        ready = torch.cuda.Event()
                        ready.record()
                drain()
                pending = (ws, k, epoch, host, stamps, ready)
                trace.count("engine.windows")
                trace.count("engine.steps", k)
                is_event = any((ws + k - 1) % p == 0 for p in chain_periods if p)
                if on_batch is not None and (is_event or not chain_periods):
                    with trace.span("engine.event"):
                        last = [w[-1] for w in window]
                        fetch = lambda last=last: batch_of(last)  # noqa: E731
                        batch = fetch() if is_event else LazyHostBatch(fetch)
                        if worker is not None and is_event:
                            snapshot = snapshot_state(state)
                            done = None
                            if on_card:
                                done = torch.cuda.Event()
                                done.record()
                            worker.submit(functools.partial(
                                _run_event, on_batch, ws + k - 1, snapshot,
                                chained.resolved_pack_keys, host, batch, done, event_stream,
                            ))
                        else:
                            on_batch(ws + k - 1, state,
                                     LazyLastMetrics(chained.resolved_pack_keys, stacked), (batch,))
                            if is_event:
                                # an inline save holds the loop for seconds, and
                                # its copies to the host prove the window ran
                                beat(ws + k)
                stopped = stop_event is not None and stop_event.is_set()
    finally:
        if isinstance(windows, Prefetcher):
            windows.close()
        if worker is not None:
            worker.close()
    return state


def _run_event(on_batch, step, snapshot, keys, host, batch, done, stream):
    """An event on the worker: wait until the snapshot, the event batch and
    the window's metrics are on hand (``done``; None on the CPU), call
    ``on_batch`` with the worker's own CUDA ``stream`` current, so its
    device work and copies run beside the next windows' replays instead
    of queueing behind them, then wait for that work before the snapshot's
    memory, allocated on the training stream, goes back to the allocator.
    Traced: ``worker.wait`` (the snapshot waited for) and
    ``worker.callback`` (``on_batch`` and its device work)."""
    on_card = done is not None
    with torch.cuda.stream(stream) if on_card else contextlib.nullcontext():
        if on_card:
            with trace.span("worker.wait"):
                done.synchronize()
        with trace.span("worker.callback"):
            row = host.detach().numpy()[-1]
            on_batch(step, snapshot, {k: row[i] for i, k in enumerate(keys)}, (batch,))
            if on_card:
                finished = torch.cuda.Event()
                finished.record()
                finished.synchronize()


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
