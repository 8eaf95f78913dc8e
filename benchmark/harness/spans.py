"""Interval arithmetic over the program's spans in a traced stretch
(``tracing.Stretch.reduce``'s ``host_spans`` and ``idle``), for the
chained engine's readers.  An interval set is a sorted list of disjoint
``(start, end)`` pairs in ns from the stretch's start."""

from __future__ import annotations

from typing import List, Optional, Tuple

Intervals = List[Tuple[int, int]]

WINDOW, WAIT, QUEUE_FULL = "engine.window", "engine.drain.wait", "Command Buffer Full"
DISPATCH = ("engine.dispatch", "engine.capture")


def merge(pairs, lo: int, hi: int) -> Intervals:
    """The union of ``pairs`` clipped to ``[lo, hi]``."""
    out: Intervals = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in pairs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def intersect(x: Intervals, y: Intervals) -> Intervals:
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append((a, b))
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(x: Intervals, y: Intervals) -> Intervals:
    out, j = [], 0
    for a, b in x:
        while j < len(y) and y[j][1] <= a:
            j += 1
        k = j
        while k < len(y) and y[k][0] < b:
            if y[k][0] > a:
                out.append((a, y[k][0]))
            a = max(a, y[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(x: Intervals) -> int:
    return sum(b - a for a, b in x)


def named(stretch: dict, names) -> Intervals:
    hi = int(stretch["stretch_s"] * 1e9)
    return merge([(a, b) for n, a, b, _ in stretch["host_spans"] if n in names], 0, hi)


def engine_work(stretch: dict, queue_full_anywhere: bool) -> Optional[Intervals]:
    """The engine thread's own work in the stretch: inside an
    ``engine.window`` span, outside ``engine.drain.wait``, and outside
    the launch queue's stalls (those inside ``engine.dispatch`` /
    ``engine.capture``, or anywhere with ``queue_full_anywhere``); None
    where the stretch holds no window span (a program without spans)."""
    if not stretch or "host_spans" not in stretch:
        return None
    windows = named(stretch, (WINDOW,))
    if not windows:
        return None
    stalls = named(stretch, (QUEUE_FULL,))
    if not queue_full_anywhere:
        stalls = intersect(stalls, named(stretch, DISPATCH))
    return subtract(subtract(windows, named(stretch, (WAIT,))), stalls)
