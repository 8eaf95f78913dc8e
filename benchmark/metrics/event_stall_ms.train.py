"""``event_stall_ms.train``: the chained engine thread's time in its event
work, ``engine.event`` (the snapshot, the event batch, the submit to the
worker) and ``engine.flush`` (the worker waited for), inside the
measured window, per event the worker started in it (``worker.event``
spans); None in a window without events."""


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    lo, hi = p["t_open_ns"], p["t_close_ns"]
    events = sum(1 for s in p["spans"] if s["name"] == "worker.event" and lo <= s["start_ns"] < hi)
    if not events:
        return None
    stall = sum(max(0, min(s["end_ns"], hi) - max(s["start_ns"], lo)) for s in p["spans"]
                if s["name"] in ("engine.event", "engine.flush"))
    return stall / events / 1e6
