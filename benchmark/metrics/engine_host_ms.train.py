"""``engine_host_ms.train``: the chained engine thread's own host work a
step over the profiled stretch: its ``engine.window`` spans less
``engine.drain.wait`` (the device waited for) and less the launch
queue's "Command Buffer Full" stalls inside ``engine.dispatch`` (the
host blocked behind the device), over the stretch's steps."""

from harness.spans import engine_work, length


def read(rec):
    s = rec.get("stretch")
    work = engine_work(s, queue_full_anywhere=False)
    if work is None or not s.get("steps"):
        return None
    return length(work) / s["steps"] / 1e6
