"""Stall watchdog: detect a wedged training process so a supervisor can
relaunch it with ``--resume auto``.

PyTorch counterpart of ``eadgan_tpu/utils/watchdog.py`` (a copy: the
port imports nothing of the JAX package).  A call that hangs inside
foreign code (a CUDA call that never returns, a hung file system under
a save) cannot be interrupted from Python: the main
thread never comes back to the interpreter, so signal handlers and
exceptions never run.  Recovery comes from outside the call: a daemon
thread watches a heartbeat that the engine taps once the device has
proven progress (``train/engine.py::run_epochs``), and when no beat
lands for ``timeout`` seconds it writes a one-line JSON stall record,
dumps every thread's stack with ``faulthandler``, and hard-exits the
process with :data:`STALL_EXIT_CODE`.  ``eadgan_tpu_torch.cli.supervise``
recognizes that code and relaunches the trainer with ``--resume auto``.

The wait for the first beat is judged against a separate, larger
``first_timeout``.  On the card the first window holds, besides the
process's start:

* the first launch of each hand-written kernel, which builds the kernel
  library with nvcc when the cache in ``ops/_build.py`` is cold (minutes
  a source file);
* cuDNN's first choice of algorithm for each convolution shape;
* the capture of the train step as a CUDA graph (``train/chain.py``).

``first_timeout`` must cover all of these.  Its default is
``EADGAN_WATCHDOG_FIRST`` seconds when that is set, else
``max(timeout, 900)``.  The chained engine also opens a grace
(:meth:`Watchdog.grace`) around the window that captures the graph, and
closes it once that window's metrics are back.
"""

from __future__ import annotations

import faulthandler
import json
import os
import sys
import threading
import time

__all__ = ["Watchdog", "STALL_EXIT_CODE"]

# Distinctive exit code the supervisor keys on, clear of shell conventions
# (1, 2), Python's own codes and the 128 + signal band.
STALL_EXIT_CODE = 87


class Watchdog:
    """Heartbeat monitor that hard-exits a wedged process.

    ``beat(step)`` is called by the training loop after proven progress;
    ``start()`` arms the monitor thread; ``stop()`` disarms it.  If
    ``on_stall`` is given it replaces the default exit (tests); the
    default writes the stall record and every thread's stack to stderr
    and calls ``os._exit(STALL_EXIT_CODE)``: ``sys.exit`` would only raise in the
    watchdog thread while the wedged main thread goes on not responding.
    ``os._exit`` skips every ``finally``, the event worker's close
    included; that is intended, since a wedged process cannot unwind, and
    the atomic writer (``train/checkpoint.py``) keeps the newest complete
    file.
    """

    def __init__(
        self,
        timeout: float,
        first_timeout: float | None = None,
        on_stall=None,
    ):
        if timeout <= 0:
            raise ValueError("watchdog timeout must be > 0")
        self.timeout = float(timeout)
        if first_timeout is None:
            first_timeout = float(
                os.environ.get("EADGAN_WATCHDOG_FIRST", 0) or 0
            ) or max(self.timeout, 900.0)
        self.first_timeout = float(first_timeout)
        self._on_stall = on_stall
        self._lock = threading.Lock()
        self._last_beat = None  # None until the first beat
        self._armed_at = None
        self._last_step = None
        self._grace_until = None
        self._stop = threading.Event()
        self._thread = None

    # -- training-loop side -------------------------------------------------
    def beat(self, step=None) -> None:
        with self._lock:
            self._last_beat = time.monotonic()
            if step is not None:
                self._last_step = step

    def grace(self) -> None:
        """Allowance of ``first_timeout`` seconds for a known-expensive
        operation in flight, released by :meth:`clear_grace` (or by its
        own expiry).  Beats do not release it: the chained engine opens
        it before the window that captures the train step as a CUDA
        graph, and beats of the window before can land while that
        capture (and its first replays) are still on the way."""
        with self._lock:
            self._grace_until = time.monotonic() + self.first_timeout

    def clear_grace(self) -> None:
        """Release an active grace: the engine proved the expensive
        operation completed (the capturing window's metrics came back),
        so the steady timeout governs again."""
        with self._lock:
            self._grace_until = None

    def start(self) -> "Watchdog":
        self._armed_at = time.monotonic()
        self._thread = threading.Thread(
            target=self._watch, name="eadgan-watchdog", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- monitor side --------------------------------------------------------
    def _watch(self) -> None:
        poll = min(self.timeout / 4.0, 5.0)
        while not self._stop.wait(poll):
            now = time.monotonic()
            with self._lock:
                last, step = self._last_beat, self._last_step
                grace_until = self._grace_until
            if grace_until is not None and now < grace_until:
                continue
            if last is None:
                # still inside the first window
                if now - self._armed_at <= self.first_timeout:
                    continue
                waited, limit = now - self._armed_at, self.first_timeout
            else:
                if now - last <= self.timeout:
                    continue
                waited, limit = now - last, self.timeout
            self._fire(step, waited, limit)
            return

    def _fire(self, step, waited, limit) -> None:
        record = {
            "event": "watchdog_stall",
            "step": step,
            "seconds_since_heartbeat": round(waited, 1),
            "timeout": limit,
            "pid": os.getpid(),
            "exit_code": STALL_EXIT_CODE,
        }
        try:
            print(
                f"watchdog: no training progress for {waited:.0f}s "
                f"(limit {limit:.0f}s, last step {step}); dumping stacks "
                f"and exiting {STALL_EXIT_CODE} for supervised restart",
                file=sys.stderr, flush=True,
            )
            print(json.dumps(record), file=sys.stderr, flush=True)
            faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
            sys.stderr.flush()
        finally:
            if self._on_stall is not None:
                self._on_stall(record)
            else:
                os._exit(STALL_EXIT_CODE)
