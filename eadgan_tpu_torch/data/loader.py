"""Batching and host-to-card prefetching.

After ``eadgan_tpu/data/loader.py``: shuffled epoch batching on the host
(:func:`epoch_batches`) and a background thread that prepares the next
batches while the current step runs (:class:`Prefetcher`).  The card's
half of the JAX package's ``device_put`` is :class:`PinnedStager`: a batch
is written into one of a ring of pinned host buffers and copied to the
card on a CUDA stream of its own, and the consumer's stream waits for
that copy's event before the step reads the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["epoch_batches", "Prefetcher", "PinnedStager", "Staged"]


def epoch_batches(
    data: np.ndarray,
    batch_size: int,
    rng: np.random.Generator,
    *,
    labels: Optional[np.ndarray] = None,
    drop_last: bool = True,
) -> Iterator:
    """Shuffled minibatches for one epoch (torch DataLoader
    ``shuffle=True``; ``drop_last`` keeps every batch the same shape)."""
    n = data.shape[0]
    perm = rng.permutation(n)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        idx = perm[start : start + batch_size]
        if labels is None:
            yield data[idx]
        else:
            yield data[idx], labels[idx]


class Prefetcher:
    """Iterate ``place(batch)`` for each of ``batches``, computed on a
    background thread up to ``depth`` items ahead of the consumer.

    Both the iteration of ``batches`` and ``place`` run on the worker
    thread; an exception there is raised on the consumer's side when it
    reaches that item.  :meth:`close` releases the worker and the staged
    items (call it when leaving the loop early, as on a ``max_steps``
    cutoff or a stop)."""

    def __init__(self, batches: Iterable, place: Optional[Callable] = None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._place = place if place is not None else (lambda item: item)
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._batches = batches
        self._thread = threading.Thread(target=self._work, name="eadgan-prefetch", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that gives up once the consumer has closed us."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self) -> None:
        try:
            for batch in self._batches:
                if not self._put(self._place(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — raised on the consumer's side
            self._err = e
        finally:
            self._put(self._sentinel)

    def close(self) -> None:
        """Stop the worker, drop what it staged, and wait for it to end."""
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._sentinel:
                if self._err is not None:
                    raise self._err
                return
            yield item


class Staged:
    """Tensors staged by :meth:`PinnedStager.stage`; :meth:`get` hands
    them to the consumer's current stream."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors: Tuple[torch.Tensor, ...], event=None):
        self.tensors = tensors
        self.event = event

    def get(self) -> Tuple[torch.Tensor, ...]:
        """The tensors, after the current stream has been made to wait for
        their copy; each is marked as used on that stream, so its memory
        goes back to the allocator only after the work enqueued there
        before it is dropped has run."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.event)
            for t in self.tensors:
                t.record_stream(stream)
            self.event = None
        return self.tensors


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class PinnedStager:
    """Host-to-card staging for a :class:`Prefetcher`'s ``place``, which
    runs on the worker thread.

    :meth:`stage` lets ``fill`` functions write a batch's arrays into one
    of a ring of ``slots`` pinned host buffers, copies them to ``device``
    with ``non_blocking=True`` on a CUDA stream of its own, and records an
    event behind the copies.  A pinned buffer is written again only after
    the copy that read it has completed (its event is waited for first);
    the card's tensors are allocated on the copy stream, and
    :meth:`Staged.get` marks them used on the consumer's stream.  Every
    CUDA call it makes holds :attr:`lock`: a caller that captures a CUDA
    graph holds it across the capture, during which no other thread may
    allocate or wait on the card.

    On the CPU nothing is pinned or copied: each batch is a host array of
    its own, as a tensor."""

    _ALIGN = 64

    def __init__(self, device, slots: int = 4):
        self.device = torch.device(device)
        self.lock = threading.Lock()
        self._slots = [[None, None] for _ in range(slots)]  # pinned buffer, its copy's event
        self._next = 0
        self._stream = None

    def stage(self, specs: Sequence[Tuple[tuple, object, Callable]]) -> Staged:
        """``specs``: ``(shape, numpy dtype, fill)`` for each array of the
        batch; ``fill(out)`` writes the array into ``out``."""
        if self.device.type != "cuda":
            arrays = [np.empty(shape, dtype) for shape, dtype, _ in specs]
            for out, (_, _, fill) in zip(arrays, specs):
                fill(out)
            return Staged(tuple(torch.from_numpy(a) for a in arrays))
        sizes = [int(np.prod(shape)) * np.dtype(dtype).itemsize for shape, dtype, _ in specs]
        offsets = np.cumsum([0] + [-(-s // self._ALIGN) * self._ALIGN for s in sizes])
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        with self.lock:
            if slot[1] is not None:
                slot[1].synchronize()  # the copy that last read this buffer has completed
            if slot[0] is None or slot[0].numel() < offsets[-1]:
                slot[0] = torch.empty(int(offsets[-1]), dtype=torch.uint8, pin_memory=True)
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
        views = []
        for (shape, dtype, fill), off, size in zip(specs, offsets, sizes):
            view = slot[0][off : off + size].view(_torch_dtype(dtype)).view(shape)
            fill(view.numpy())
            views.append(view)
        with self.lock, torch.cuda.stream(self._stream):
            tensors = tuple(v.to(self.device, non_blocking=True) for v in views)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot[1] = event
        return Staged(tensors, event)
