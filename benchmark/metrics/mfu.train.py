"""``mfu.train``: the whole train step's share of the card's peak.  The
step's operations (the reference step's, counted on the meta device from
the cell's shapes, ``counts/step.py``) times the steps of the traced
run's measured window after its profiled stretch, over that part's time
(the profiler slows the stretch it traces), against the peak of the
configuration's compute type (``harness/peaks.py``)."""

from harness.peaks import COMPUTE_PEAK


def read(rec):
    w = rec.get("window")
    flops = rec.get("flops_per_step")
    if not w or not flops or not w.get("steps") or w["seconds"] <= 0:
        return None
    return 100.0 * flops * w["steps"] / w["seconds"] / COMPUTE_PEAK[rec["compute"]]
