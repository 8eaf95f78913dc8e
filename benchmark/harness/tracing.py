"""The traced stretch: ``torch.profiler`` over a few windows of the
measured run, reduced to what the per-layer readers take.

The profiler keeps every event in memory, so it covers a short stretch
only, opened and closed by the driver at window boundaries.  A
``bench.stretch`` annotation on the host marks the stretch on the
profiler's own clock; device operations are clipped to it.  The device's
busy time is the union of the intervals of every device operation
(kernels, copies, sets) on every stream, so two streams' overlapping work
counts once.

Where the program records its own spans (``eadgan_tpu_torch/utils/
trace.py``, on while the driver's traced call runs), each also opens a
``record_function`` of its name, so the stretch holds them on the
profiler's clock beside the device's operations and the launch queue's
"Command Buffer Full" stalls; ``reduce`` hands them on as ``host_spans``
with every idle interval, ``idle``.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch

MARK = "bench.stretch"
QUEUE_FULL = "Command Buffer Full"  # the host blocked on a full launch queue
_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_ns(intervals: List[Tuple[int, int]]) -> int:
    """Total length of the union of ``(start, end)`` intervals."""
    total = 0
    end = None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        elif b > end:
            end = b
    if end is not None:
        total += end - start
    return total


def idle_gaps(intervals: List[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """The gaps in ``[lo, hi]`` that no interval covers."""
    gaps = []
    cursor = lo
    for a, b in sorted(intervals):
        if a > cursor:
            gaps.append((cursor, min(a, hi)))
        cursor = max(cursor, b)
        if cursor >= hi:
            break
    if cursor < hi:
        gaps.append((cursor, hi))
    return [(a, b) for a, b in gaps if b > a]


def _kind(event):
    kind = getattr(event, "activity_type", None)
    return kind() if callable(kind) else None


def _is_annotation(event) -> bool:
    flag = getattr(event, "is_user_annotation", None)
    if callable(flag):
        return bool(flag())
    return _kind(event) == "user_annotation"


def warm_up() -> None:
    """Start and stop the profiler once: the first start in a process
    initialises the device tracer, which takes seconds, so a traced run
    pays it in set-up and not inside its window."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class Stretch:
    """``start()`` starts the profiler, ``begin()`` opens the stretch (a
    window later, once the first launches under the profiler, which it
    slows, are behind) and ``stop()`` closes it, all on the driver's main
    thread; ``reduce()`` then gives the records the readers take."""

    def __init__(self):
        self._prof = None
        self._mark = None
        self.steps = 0  # the work the stretch holds, set by the driver

    def start(self) -> None:
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()

    def begin(self) -> None:
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
        self._prof.stop()

    @property
    def started(self) -> bool:
        return self._prof is not None

    def reduce(self, top: int = 10) -> Optional[dict]:
        """Device time by operation name, the busy union, the stretch's
        length and the longest idle gaps named by the host event that
        was running through each; None without a marked stretch."""
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        lo = hi = None
        device: List[Tuple[int, int, str]] = []
        host: List[Tuple[int, int, str]] = []
        marks: List[Tuple[int, int, str, int]] = []  # the program's spans, the queue's stalls
        # ranges a host annotation opens are mirrored on the device's
        # timeline; they are no device operation
        annotations = {MARK}
        for e in events:
            if e.device_type() != torch.autograd.DeviceType.CUDA and _is_annotation(e):
                annotations.add(e.name())
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                kind = _kind(e)
                if (kind is None or kind in _DEVICE_KINDS) and e.name() not in annotations:
                    device.append((start, end, e.name()))
            elif e.name() == MARK:
                lo, hi = start, end
            elif e.name() in annotations:
                marks.append((start, end, e.name(), e.device_resource_id()))
            else:
                host.append((start, end, e.name()))
                if e.name() == QUEUE_FULL:
                    marks.append((start, end, e.name(), e.device_resource_id()))
        self._prof = None
        if lo is None:
            return None
        clipped = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
        intervals = [(a, b) for a, b, _ in clipped]
        by_name: Dict[str, float] = collections.defaultdict(float)
        counts: Dict[str, int] = collections.Counter()
        for a, b, n in clipped:
            by_name[n] += (b - a) * 1e-9
            counts[n] += 1
        idle = idle_gaps(intervals, lo, hi)
        gaps = sorted(idle, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            around = [(e - s, n) for s, e, n in host if s <= mid <= e and n != MARK]
            named.append([f"host: {min(around)[1]}" if around else "host: no traced call",
                          (b - a) * 1e-9])
        return {
            "stretch_s": (hi - lo) * 1e-9,
            "busy_s": union_ns(intervals) * 1e-9,
            "kernel_s": dict(by_name),
            "kernel_count": dict(counts),
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": named,
            "steps": self.steps,
            # from the stretch's start, in ns: [name, start, end, thread]
            # of each span overlapping it, and each idle interval
            "host_spans": [[n, a - lo, b - lo, t] for a, b, n, t in marks if b > lo and a < hi],
            "idle": [[a - lo, b - lo] for a, b in idle],
        }
