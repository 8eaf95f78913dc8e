"""``optimizer_ms.train``: the device time of a replayed step's
``optimizer.step()`` calls, from the step's device stamps (the program's
``step.optimizer_ns`` and ``step.stamped`` counters), over the steps
the measured window drained: the counters at its close less those at
its opening."""


def read(rec):
    p = rec.get("program")
    if not p:
        return None
    end, start = p["counters"], p["counters_open"]
    steps = end.get("step.stamped", 0) - start.get("step.stamped", 0)
    if steps <= 0:
        return None
    return (end["step.optimizer_ns"] - start.get("step.optimizer_ns", 0)) / steps / 1e6
