"""``device_idle.train``: the device's idle share of the profiled stretch
of a training cell: 100 x (1 - union of every device operation's interval
on every stream / the stretch's wall time)."""


def read(rec):
    s = rec.get("stretch")
    if not s or s["stretch_s"] <= 0 or not s.get("steps"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["stretch_s"])
