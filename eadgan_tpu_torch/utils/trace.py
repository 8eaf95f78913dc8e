"""Spans and counters of the port: where a run's host time goes, layer by
layer, and how much work each layer did.

``span(name)`` is a context manager that records the name, the start and
end on ``time.perf_counter_ns()``, the enclosing span of the same thread
(its ``parent``) and the thread; ``count(name, n)`` adds to a counter.
Both record nothing until :func:`enable` is called, and cost one flag
check while off: ``span`` returns one shared null context, ``count``
returns at once, nothing is allocated or registered.  While on, each
span also opens a ``torch.profiler.record_function`` of its name, so
under an active profiler the span lands in its trace on the profiler's
own clock, beside the device's operations.

Spans are kept in memory and handed out whole by :func:`collect`, or
written as JSON by :func:`write`.  ``EADGAN_TRACE=<path>`` makes
``train/engine.py::run_epochs`` turn tracing on for its run and write
``<path>`` at its end.  The names the port records:

- the chained engine, one set a window: ``engine.window`` (the parent),
  ``engine.feed`` (the window's indices and masks made and copied, or its
  raw rows waited for), ``engine.dispatch`` (its replays enqueued), or
  ``engine.capture`` for the window that runs the eager first step and
  captures the graph, ``engine.drain.wait`` (the previous window's
  ``ready.synchronize()``), ``engine.drain.log`` (its logging and the
  watchdog's beat), ``engine.event`` (the snapshot, the event batch and
  the submit to the worker, whose queue ``put`` is
  ``engine.event.submit``; an inline callback runs inside it too) and
  ``engine.flush`` (the worker waited for before a capture).  The last
  ``engine.window`` of a run, with no ``s`` and ``k``, drains the last
  window;
- the per-step engine, one set a step: ``engine.feed``, ``engine.step``
  and ``engine.callback``;
- the event worker's thread: ``worker.event``, with ``worker.wait`` (the
  snapshot waited for on the card) and ``worker.callback``; inside the
  callbacks ``sample.grid`` (a grid rendered and written) and
  ``checkpoint.save``;
- counters: ``engine.windows``, ``engine.steps``, ``engine.captures``,
  ``worker.events``, ``worker.submit_blocked``, ``checkpoint.saves``,
  ``checkpoint.bytes``, ``sample.grids``, from the replayed step's
  device stamps (``train/chain.py``) ``step.stamped``, ``step.prepare_ns``,
  ``step.fwd_bwd_ns`` and ``step.optimizer_ns``, ``adam.launches``
  (the Adam kernel's launches, ``ops/adam_cuda.py``) and ``sn.launches``
  (the spectral norm's kernel launches, ``ops/sn_cuda.py``), each
  replay's counted as it is replayed.
"""

from __future__ import annotations

import itertools
import json
import threading
import time

import torch

__all__ = ["span", "count", "enable", "disable", "enabled", "reset", "collect", "write"]

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
_ids = itertools.count(1)
_local = threading.local()


class _NullSpan:
    """What :func:`span` returns while tracing is off: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "id", "parent", "start", "attrs", "_mark")

    def __init__(self, name: str):
        self.name = name
        self.attrs = None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        stack.append(self)
        self._mark = torch.profiler.record_function(self.name)
        self._mark.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._mark.__exit__(None, None, None)
        _local.stack.pop()
        record = {"name": self.name, "id": self.id, "parent": self.parent, "start_ns": self.start,
                  "end_ns": end, "thread": threading.current_thread().name}
        if self.attrs:
            record.update(self.attrs)
        with _lock:
            _spans.append(record)
        return False

    def set(self, **attrs) -> None:
        """Attributes the record carries beside its times (the window's
        ``s`` and ``k``)."""
        self.attrs = {**(self.attrs or {}), **attrs}


def span(name: str):
    """A context manager timing the code inside as the span ``name``."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every span and counter recorded so far."""
    with _lock:
        _spans.clear()
        _counters.clear()


def collect() -> dict:
    """``{"spans": [...], "counters": {...}}``, copies of what was recorded:
    each span a dict of ``name``, ``id``, ``parent`` (the id of the
    enclosing span of its thread, or None), ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns()``), ``thread`` (its name) and its
    attributes, in the order the spans ended."""
    with _lock:
        return {"spans": [dict(s) for s in _spans], "counters": dict(_counters)}


def write(path: str) -> None:
    """Write :func:`collect`'s result to ``path`` as JSON."""
    with open(path, "w") as f:
        json.dump(collect(), f)
