"""Chained training: windows of up to K steps replayed from one CUDA graph.

PyTorch counterpart of ``eadgan_tpu/train/chain.py``.  The JAX package
chains K steps into one ``lax.scan`` program so that one dispatch round
trip serves K steps.  On the card the host's cost is issuing the step's
~2,750 kernel launches one by one, so the counterpart here is one
``torch.cuda.CUDAGraph`` of the train step, captured once per run and
replayed K times per window:

- the dataset stays resident on the card as it is, uint8 images or
  MNIST's float32 ones, and each step's batch is gathered, flipped and
  normalized inside the graph (:func:`normalize_prepare`), from int32
  row indices copied in once a window; a dataset above
  ``EADGAN_DEVICE_DATA_MAX`` instead sends each window's raw rows,
  gathered on the host, and the graph flips and normalizes them;
- the step's metrics are packed into one (M,) float32 tensor, copied
  into row i of a (K, M) window buffer after replay i, so a window
  returns its metrics in one tensor;
- the window planner (:func:`plan_windows`, a copy of the JAX one) puts
  every sample/checkpoint step at the end of a window, where the
  engine runs the side effects, on an :class:`EventWorker` against a
  :func:`snapshot_state` of the train state.

On the CPU the same windows, gather and packed metrics run with the
step called eagerly K times; that path exists only because the caller
asked for the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from eadgan_tpu_torch.ops import _build, adam_cuda, sn_cuda, stamp_cuda, stn_cuda
from eadgan_tpu_torch.utils import trace

__all__ = [
    "ChainedStep",
    "make_chained_step",
    "plan_windows",
    "normalize_prepare",
    "gather_prepare",
    "LazyLastMetrics",
    "LazyHostBatch",
    "EventWorker",
    "snapshot_state",
]


class ChainedStep:
    """``chained(state, consts, *windows) -> (state, packed)``: run one
    step per row of the windows (each with a leading axis K) and return
    the (K, M) float32 metrics, in the order of ``resolved_pack_keys``.

    ``body(state, *batch) -> (state, metrics)`` is the train step, which
    updates ``state`` in place; ``prepare(consts, *rows)`` turns one row
    of each window into the step's batch (None: the rows are the batch).

    On a CUDA card the first step this object runs is eager: it is a
    real step of the schedule and creates the optimizers' state and the
    libraries' handles before capture.  The next step that needs running
    captures prepare, body and the packing of the metrics as one
    ``torch.cuda.CUDAGraph``; every step after that is a replay of it:
    the row's inputs are copied into the graph's static inputs on the
    card, the graph replays, and its metrics are copied into the window's
    row.  The ``generators`` the body draws from are registered with the
    graph, so each replay draws the next values of the same Philox stream
    that an eager step would.  The graph's memory is one step's; one
    graph serves every window length.  Capture that fails raises; there
    is no fall back to eager steps.

    The host's step counter (``state.step += 1`` in the bodies) moves
    once at capture and never on replay: the caller sets it after each
    window.  The warp, Adam and spectral-norm kernels' launches recorded
    by the capture are counted after each replay
    (``stn_cuda.count_replayed``, ``adam_cuda.count_replayed``,
    ``sn_cuda.count_replayed``).

    With tracing on at capture (``utils/trace.py``) the graph also holds
    the step's device phase stamps (:class:`_Stamps`): while tracing is
    on, after each replay they are copied into row i of a (K, P) int64
    window buffer, ``window_stamps``, which the caller brings to the host
    with the metrics and hands to :meth:`count_phases`.  With tracing off
    at capture the graph holds no stamp; with it off at a call,
    ``window_stamps`` is None.
    """

    def __init__(self, body: Callable, prepare: Optional[Callable] = None,
                 pack_keys="auto", generators: Sequence[torch.Generator] = ()):
        self.body = body
        self.prepare = prepare
        self.pack_keys = pack_keys
        self.generators = tuple(generators)
        self.resolved_pack_keys: list = []
        self.graph = None
        self.warmed = False  # the first step ran eagerly
        self.captured_warps = 0  # warp launches one replay runs
        self.captured_adams = 0  # Adam kernel launches one replay runs
        self.captured_sn = 0  # spectral-norm kernel launches one replay runs
        self.stamps = None  # the graph's phase stamps, when captured with tracing on
        self.window_stamps = None  # the last call's (K, P) stamps; row 0 zero if eager
        self._static_in = None
        self._static_out = None

    def _step(self, state, consts, rows, stamps=None):
        if stamps is not None:
            stamps.mark("start")
        batch = self.prepare(consts, *rows) if self.prepare is not None else tuple(rows)
        if not isinstance(batch, tuple):
            batch = (batch,)
        if stamps is not None:
            stamps.mark("prepare")
        with stamps.around_optimizers() if stamps is not None else contextlib.nullcontext():
            state, metrics = self.body(state, *batch)
        if not self.resolved_pack_keys:
            keys = sorted(metrics) if self.pack_keys == "auto" else self.pack_keys
            self.resolved_pack_keys.extend(keys)
        packed = torch.stack([metrics[k].to(torch.float32) for k in self.resolved_pack_keys])
        if stamps is not None:
            stamps.mark("end")
        return state, packed

    def _capture(self, state, consts, windows) -> None:
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                f"torch {torch.__version__} has no CUDAGraph.register_generator_state: "
                "the chained engine cannot replay the step's draws (use --chain 1)"
            )
        _build.load_library()  # nvcc runs at first use: never inside a capture
        self._static_in = [w[0].clone() for w in windows]
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        stamps = _Stamps(windows[0].device) if trace.enabled() else None
        warps, adams, sn = stn_cuda.captured_count, adam_cuda.captured_count, sn_cuda.captured_count
        with torch.cuda.graph(graph):
            _, self._static_out = self._step(state, consts, self._static_in, stamps)
        self.captured_warps = stn_cuda.captured_count - warps
        self.captured_adams = adam_cuda.captured_count - adams
        self.captured_sn = sn_cuda.captured_count - sn
        self.graph = graph
        self.stamps = stamps

    def will_capture(self, windows) -> bool:
        """Whether a call with these windows captures the graph: on the
        card, before any capture, unless the call is only the eager first
        step."""
        return bool(windows[0].is_cuda and self.graph is None
                    and (self.warmed or windows[0].shape[0] > 1))

    def runs_eagerly(self, windows) -> bool:
        """Whether a call with these windows runs the eager first step or
        captures the graph (the engine's ``engine.capture`` span), rather
        than only replaying it."""
        return bool(windows[0].is_cuda and (not self.warmed or self.will_capture(windows)))

    def __call__(self, state, consts, *windows):
        k = windows[0].shape[0]
        if not windows[0].is_cuda:
            rows = []
            for i in range(k):
                state, packed = self._step(state, consts, [w[i] for w in windows])
                rows.append(packed)
            return state, torch.stack(rows)
        first = 0
        if not self.warmed:
            state, eager = self._step(state, consts, [w[0] for w in windows])
            self.warmed = True
            first = 1
        if first < k and self.graph is None:
            self._capture(state, consts, windows)
        out = torch.empty((k, len(self.resolved_pack_keys)), device=windows[0].device)
        if first:
            out[0].copy_(eager)
        stamped = None
        if self.stamps is not None and trace.enabled():
            stamped = torch.empty((k, len(self.stamps.kinds)), dtype=torch.int64,
                                  device=windows[0].device)
            if first:
                stamped[0].zero_()  # the eager step: no stamps
        for i in range(first, k):
            for static, w in zip(self._static_in, windows):
                static.copy_(w[i])
            self.graph.replay()
            stn_cuda.count_replayed(self.captured_warps)
            adam_cuda.count_replayed(self.captured_adams)
            sn_cuda.count_replayed(self.captured_sn)
            out[i].copy_(self._static_out)
            if stamped is not None:
                stamped[i].copy_(self.stamps.slots[: len(self.stamps.kinds)])
        self.window_stamps = stamped
        return state, out

    def count_phases(self, stamps: np.ndarray) -> None:
        """Add the device nanoseconds of each stamped step in ``stamps``, a
        window's (K, P) stamps on the host, to the trace's counters by
        phase: ``step.prepare_ns`` (the batch made), ``step.optimizer_ns``
        (every ``optimizer.step()``), ``step.fwd_bwd_ns`` (the rest: the
        forward and backward passes, the losses, the metrics packed); and
        the steps to ``step.stamped``.  Rows of 0 (an eager step) are
        skipped."""
        rows = stamps[stamps[:, 0] != 0]
        if not len(rows):
            return
        kinds = np.array(self.stamps.kinds)
        total = int((rows[:, -1] - rows[:, 0]).sum())
        prepare = int((rows[:, 1] - rows[:, 0]).sum())
        optimizer = int((rows[:, kinds == "opt_post"] - rows[:, kinds == "opt_pre"]).sum())
        trace.count("step.stamped", len(rows))
        trace.count("step.prepare_ns", prepare)
        trace.count("step.optimizer_ns", optimizer)
        trace.count("step.fwd_bwd_ns", total - prepare - optimizer)


class _Stamps:
    """The device phase stamps captured into a traced step's graph: the
    card's clock written (``ops/stamp_cuda.py``) into ``slots`` at the
    step's start, after its prepare, before and after every
    ``optimizer.step()`` and at its end; ``kinds`` names each slot in
    order (``start``, ``prepare``, ``opt_pre`` / ``opt_post`` pairs,
    ``end``)."""

    MAX = 64

    def __init__(self, device):
        self.slots = torch.zeros(self.MAX, dtype=torch.int64, device=device)
        self.kinds: list = []

    def mark(self, kind: str) -> None:
        if len(self.kinds) == self.MAX:
            raise RuntimeError(f"a step stamps at most {self.MAX} phase boundaries")
        self._write(len(self.kinds))
        self.kinds.append(kind)

    def _write(self, index: int) -> None:
        stamp_cuda.stamp(self.slots, index)

    @contextlib.contextmanager
    def around_optimizers(self):
        """Stamp before and after every optimizer step inside, through
        ``torch.optim``'s global step hooks, registered only here."""
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        pre = register_optimizer_step_pre_hook(lambda *_: self.mark("opt_pre"))
        post = register_optimizer_step_post_hook(lambda *_: self.mark("opt_post"))
        try:
            yield
        finally:
            pre.remove()
            post.remove()


def make_chained_step(body: Callable, prepare: Optional[Callable] = None,
                      pack_keys="auto", generators: Sequence[torch.Generator] = ()) -> ChainedStep:
    """A :class:`ChainedStep` of ``body``.  ``pack_keys``: an ordered
    metric-name sequence, or ``"auto"`` for every metric the body emits
    in sorted order (resolved at the first step, then exposed as
    ``resolved_pack_keys``)."""
    return ChainedStep(body, prepare, pack_keys, generators)


def normalize_prepare(scale: float, shift: float, flip: bool = False,
                      add_channel: bool = False, gather: bool = True):
    """The step's batch from a window row, in the JAX function's op order.

    ``gather=True`` (the resident dataset): ``consts = (dataset,)`` is the
    dataset on the card, uint8 or float32 (MNIST, taken with scale 1 and
    shift 0), and a row carries int32 indices (``index_select``).
    ``gather=False`` (the raw windows of a dataset above
    ``EADGAN_DEVICE_DATA_MAX``): a row is the raw uint8 batch (B, H, W[,
    C]) itself, gathered on the host, and ``consts`` is unused.

    With ``flip``, a bool mask row mirrors those images along the width
    while still uint8 (``torch.where``, no host sync), after the channel
    axis of 2-D images is added; then ``x.float() * scale + shift`` in
    float32.  Without flip the channel axis comes last.  The values equal
    the per-step engine's host batches (``data/native.py``) bit for bit,
    on either path: a flip permutes pixels, and both compute one float32
    multiply then one add."""

    def load(consts, x):
        return torch.index_select(consts[0], 0, x) if gather else x

    if flip:

        def prep(consts, x, mask):
            x = load(consts, x)
            if add_channel:
                x = x[..., None]
            x = torch.where(mask[:, None, None, None], x.flip(2), x)
            return (x.float() * scale + shift,)

    else:

        def prep(consts, x):
            img = load(consts, x).float() * scale + shift
            if add_channel:
                img = img[..., None]
            return (img,)

    return prep


def gather_prepare():
    """Prepare for datasets resident on the card whole (``consts`` holds
    the arrays): a row carries int32 indices, and the batch is one
    ``index_select`` from each array."""

    def prep(consts, idx):
        return tuple(torch.index_select(c, 0, idx) for c in consts)

    return prep


def plan_windows(
    start: int,
    count: int,
    chain: int,
    periods: Sequence[int] = (),
    stop: Optional[int] = None,
) -> Iterator[Tuple[int, int]]:
    """Yield ``(global_start_index, k)`` windows covering step indices
    ``[start, start + count)``.

    Every index ``e`` with ``e % p == 0`` for any period ``p`` (the
    sample / checkpoint intervals whose side effects need the exact
    post-step state) is forced to be the LAST index of its window; ``k``
    never exceeds ``chain`` and never crosses ``stop`` (the absolute
    max-steps bound).  With all periods equal to 1 this degenerates to
    k=1 per window — the per-step debugging path.

    Emitted ``k`` are always POWERS OF TWO, as in the JAX package, where
    each distinct window length is a separate compile; one CUDA graph
    serves every length here, but the same plan gives the same window
    ends, and so the same event steps, as the JAX engine.  Shrinking a
    window never crosses an event index (k only decreases), so the
    event-at-window-end invariant is preserved.
    """
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")
    s = start
    end = start + count
    if stop is not None:
        end = min(end, stop)
    periods = [p for p in periods if p and p > 0]
    while s < end:
        k = min(chain, end - s)
        for p in periods:
            # smallest event index >= s under period p
            e = s if s % p == 0 else s + (p - s % p)
            if e < s + k:
                k = e - s + 1
        k = 1 << (k.bit_length() - 1)  # largest power of two <= k
        yield s, k
        s += k


class LazyLastMetrics:
    """Dict-like view of the LAST step's metrics in a packed (K, M)
    tensor.  Most windows never read per-step metrics (the logger gets
    the window's host copy), so nothing is fetched until a key is read;
    the first access copies the whole packed tensor to the host once and
    caches its last row."""

    def __init__(self, keys: Sequence[str], packed: torch.Tensor):
        self._keys = tuple(keys)
        self._packed = packed
        self._row = None

    def _fetch(self):
        if self._row is None:
            self._row = self._packed.detach().cpu().numpy()[-1]
        return self._row

    def __getitem__(self, key):
        if key not in self._keys:
            raise KeyError(key)  # dict parity with the per-step engine
        return self._fetch()[self._keys.index(key)]

    def __contains__(self, key):
        return key in self._keys

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def get(self, key, default=None):
        return self._fetch()[self._keys.index(key)] if key in self._keys else default

    def keys(self):
        return self._keys

    def values(self):
        row = self._fetch()
        return [row[i] for i in range(len(self._keys))]

    def items(self):
        row = self._fetch()
        return [(k, row[i]) for i, k in enumerate(self._keys)]


class LazyHostBatch:
    """A window's last batch, made only if ``on_batch`` touches it
    (``fn()`` builds it once)."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._value = None

    def _get(self):
        if self._value is None:
            self._value = self._fn()
        return self._value

    def __getitem__(self, item):
        return self._get()[item]

    def __array__(self, dtype=None, copy=None):
        value = self._get()
        arr = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return self._get().shape

    @property
    def dtype(self):
        return self._get().dtype


class EventWorker:
    """One ordered background thread for the side effects of event
    windows (sample grids, checkpoint writes), after
    ``eadgan_tpu/train/chain.py::EventWorker``.

    A CelebA save window copies a ~520 MB train state to the host and
    serializes it, and renders and writes PNG grids; inline, the card
    idles that long.  The engine instead hands the callback a snapshot of
    the state (:func:`snapshot_state`) and submits it here, so the copy,
    the serialization and the PNGs overlap the next windows' device work.
    The queue is bounded (``maxsize``): when events outpace the worker,
    :meth:`submit` blocks (counted as ``worker.submit_blocked``; the
    spans and counters are ``utils/trace.py``'s).  An exception in a callback re-raises at the
    next :meth:`submit`, :meth:`flush` or :meth:`close`, so a failed
    checkpoint write cannot pass silently."""

    def __init__(self, maxsize: int = 2):
        self._q = queue.Queue(maxsize=maxsize)
        self._err = None
        self._t = threading.Thread(target=self._run, name="eadgan-event-worker", daemon=True)
        self._t.start()

    def _run(self):
        while True:
            fn = self._q.get()
            try:
                if fn is None:
                    return
                trace.count("worker.events")
                with trace.span("worker.event"):
                    fn()
            except BaseException as e:  # noqa: BLE001 — surfaced on submit/flush/close
                self._err = e
            finally:
                fn = None  # drop the callback's references (a snapshot) before waiting
                self._q.task_done()

    def _check(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, fn: Callable) -> None:
        self._check()
        with trace.span("engine.event.submit"):
            try:
                self._q.put_nowait(fn)
            except queue.Full:
                trace.count("worker.submit_blocked")
                self._q.put(fn)

    def flush(self) -> None:
        """Wait until every submitted callback has run."""
        self._q.join()
        self._check()

    def close(self) -> None:
        self._q.put(None)
        self._t.join()
        self._check()


def snapshot_state(state):
    """A copy of a train state that shares no storage with it: its
    models (parameters, buffers), optimizers (moments and step counts,
    over the copied parameters) and step, deep-copied, and a generator at
    the same position of its stream.  The tensors are cloned on the
    current stream, so on the card the copy is enqueued behind the work
    already issued that writes them, and ahead of any issued later."""
    rng = getattr(state, "rng", None)
    if rng is not None:
        state.rng = None
    try:
        twin = copy.deepcopy(state)
    finally:
        if rng is not None:
            state.rng = rng
    if rng is not None:
        twin.rng = torch.Generator(device=rng.device)
        twin.rng.set_state(rng.get_state())
    return twin
