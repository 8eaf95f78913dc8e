"""``host_idle_ms.train``: the device's idle time a step over the profiled
stretch while the chained engine's thread was doing its own work: inside
an ``engine.window`` span, outside ``engine.drain.wait`` and outside any
"Command Buffer Full" stall.  The rest of ``device_idle.train`` is the
device's own gaps, inside and between the replayed graphs."""

from harness.spans import engine_work, intersect, length, merge


def read(rec):
    s = rec.get("stretch")
    work = engine_work(s, queue_full_anywhere=True)
    if work is None or not s.get("steps") or "idle" not in s:
        return None
    idle = merge(s["idle"], 0, int(s["stretch_s"] * 1e9))
    return length(intersect(work, idle)) / s["steps"] / 1e6
