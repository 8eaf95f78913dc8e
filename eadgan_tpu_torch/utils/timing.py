"""Timing on the card with CUDA events.

Counterpart of ``tools/perf_breakdown_small.py::timed`` (the JAX
package's fori_loop differencing harness).  PyTorch runs eagerly, so a
run of back-to-back calls is bracketed by two CUDA events instead; the
events are queued behind a spin kernel long enough for the host to
enqueue every call, so they bracket device work only, not the host's
launch overhead.  :func:`host_ms_per_call` gives the other number, what a
caller pays per call on the host clock, and :func:`host_enqueue_ms` the
host's own cost of a call, without waiting for the device.  Every
function needs a CUDA card, except :func:`host_ms_per_call` with
``cuda=False``, which times work on the CPU.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch

__all__ = ["sleep_cycles_per_ms", "device_ms", "host_ms_per_call", "host_enqueue_ms"]


def sleep_cycles_per_ms() -> float:
    """Clock cycles ``torch.cuda._sleep`` spins per millisecond."""
    cycles = 20_000_000
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn: Callable[[], object], iters: int, cycles_per_ms: float, repeats: int = 5) -> float:
    """Median device time of one ``fn()`` call over ``repeats`` samples
    of ``iters`` back-to-back calls.  Each sample first parks the stream
    behind a spin kernel lasting twice the host's enqueue time of the
    ``iters`` calls (plus 5 ms), so the events bracket device work only."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(int(cycles_per_ms * (2.0 * host_ms + 5.0)))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def host_ms_per_call(fn: Callable[[], object], iters: int, cuda: bool = True) -> float:
    """Host clock per call of back-to-back ``fn()``, ending in a
    synchronize (with ``cuda``): what a caller pays, launch overhead
    included."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def host_enqueue_ms(fn: Callable[[], object], iters: int) -> float:
    """Host clock per call of back-to-back ``fn()`` calls, stopped before
    the device is waited for: the host's own cost of a call (checks,
    arguments, launch), which the device hides while it is the slower."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms
