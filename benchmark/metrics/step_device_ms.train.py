"""``step_device_ms.train``: the device's busy time a train step, the
union of every device operation's interval over the profiled stretch (a
few replayed windows inside the measured window), over the steps the
stretch holds."""


def read(rec):
    s = rec.get("stretch")
    if not s or not s.get("steps") or s["busy_s"] <= 0:
        return None
    return 1e3 * s["busy_s"] / s["steps"]
