"""A kernel's share of its roofline over the traced stretch, from the
work a step that ``records["work"]`` holds for it (``counts/work.py``):
the least time the card could take for a step's work (``peaks.bound_s``)
times the stretch's steps, over the time of every launch in the stretch
whose name holds the kernel's."""

from __future__ import annotations

from typing import Optional

from harness.peaks import COMPUTE_PEAK, bound_s


def kernel_roofline(rec: dict, kernel: str) -> Optional[float]:
    """The share in %, or None where the run holds no stretch, no work
    for ``kernel`` or no launch of it."""
    s, work = rec.get("stretch"), rec.get("work")
    if not s or not s.get("steps") or not work or kernel not in work:
        return None
    seconds = sum(t for name, t in s["kernel_s"].items() if kernel in name)
    if seconds <= 0:
        return None
    w = work[kernel]
    return 100.0 * bound_s(w["bytes"], w["ops"], COMPUTE_PEAK[w["compute"]]) * s["steps"] / seconds
