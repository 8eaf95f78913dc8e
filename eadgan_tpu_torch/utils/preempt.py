"""Graceful preemption shutdown: SIGTERM becomes a final train-state save
instead of lost work.

PyTorch counterpart of ``eadgan_tpu/utils/preempt.py`` (a copy: the port
imports nothing of the JAX package).  A cloud machine that is preempted,
evicted for maintenance or stopped by ``kill`` gets SIGTERM and a short
grace window (often 30 s) before it goes away.  Without a guard a
trainer dies at once and loses every step since its last cadence save
(CelebA saves its train state every 15 sample intervals).  The trainer
CLIs install a :class:`PreemptionGuard`; on SIGTERM the engine finishes
the in-flight window (its side effects included), stops at that window's
end, writes ONE final atomic train state at the exact step (the
trainer's ``on_shutdown``), and the process exits with
:data:`PREEMPT_EXIT_CODE`.  ``--resume auto`` then continues with no
lost step.  The time from the signal to the exit is at most one window
of replayed steps plus the final save; ``chip_smoke.py``'s robustness
phase measures both on the card.

Each failure has its own channel:

* **SIGTERM** -> graceful save (this module): a preemption notice,
  ``kill <pid>``, a supervisor winding a gang down.
* **SIGINT** (Ctrl-C) -> the default ``KeyboardInterrupt``: queued event
  writes still flush through the engine's ``finally``
  (``train/engine.py``), but no final train state is written.
* **watchdog stall** -> ``os._exit(87)``: a wedged process cannot run a
  signal handler (its main thread is parked in foreign code), so
  ``cli.supervise`` relaunches it instead (``utils/watchdog.py``).

A second SIGTERM escalates: the handler restores the default disposition
and re-delivers, so an impatient operator still ends the process at
once.  That is safe: train-state writes are atomic
(``train/checkpoint.py``), so a kill inside the final save leaves the
previous complete file.

Under ``cli.supervise`` (which marks its children with
``EADGAN_SUPERVISED=1``) a second SIGTERM does not escalate.  A stop
sent to the supervisor's whole process group or cgroup (Slurm, systemd's
``KillMode=control-group``, ``kill -TERM -<pgid>``) reaches each trainer
twice: once directly and once from the supervisor's graceful ladder a
few milliseconds later.  Both are the same request, and the ladder's
SIGKILL after 30 s is the supervisor's escalation.
"""

from __future__ import annotations

import os
import signal
import threading

__all__ = ["PreemptionGuard", "PREEMPT_EXIT_CODE"]

# Distinct from a clean finish (0) and from the watchdog's STALL_EXIT_CODE
# (87, "relaunch me").  Under a plain ``cli.supervise`` a preemption
# propagates (the host is going away); ``--restart_on_error`` opts into a
# relaunch with ``--resume auto``.
PREEMPT_EXIT_CODE = 86


class PreemptionGuard:
    """Installable SIGTERM-to-graceful-save flag.

    ``install()`` arms the handler; ``requested`` is a ``threading.Event``
    that the engines poll once a step (``chain=1``) or once a window
    (``run_epochs(stop_event=...)``).  A signal can land at any instant,
    inside a replay or a wait on the card included; CPython runs the
    handler when that call returns, and the flag is observed at the next
    step or window end, where a true post-step train state exists.
    """

    def __init__(self):
        self.requested = threading.Event()
        self._supervised = os.environ.get("EADGAN_SUPERVISED") == "1"
        self._previous = None  # the disposition install() replaced
        self._armed = False

    def _handle(self, signum, frame) -> None:
        if self.requested.is_set():
            if self._supervised:
                return  # the same stop again (see the module docstring)
            # second delivery: out now.  The atomic writer makes dying
            # inside the final save safe.
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        self.requested.set()
        # The flag is set FIRST, so the graceful path survives a failure of
        # the notice below.  os.write(2, ...), not print(): CPython runs
        # this handler between bytecodes, possibly in the middle of another
        # buffered write to stderr (watchdog diagnostics, warnings), and
        # print() would then raise "reentrant call inside BufferedWriter"
        # at an arbitrary bytecode of the main thread, aborting the run
        # without the save this handler exists for.  os.write is an
        # unbuffered, async-signal-safe write.
        try:
            os.write(
                2,
                (
                    f"preemption: caught signal {signum}; finishing the "
                    "in-flight window, saving a final train state, then "
                    f"exiting {PREEMPT_EXIT_CODE} ("
                    + ("a repeated SIGTERM is ignored under cli.supervise"
                       if self._supervised else "send again to terminate immediately")
                    + ")\n"
                ).encode(),
            )
        except OSError:
            pass

    def install(self) -> "PreemptionGuard":
        """Arm the SIGTERM handler (idempotent).  Outside the main thread
        CPython forbids ``signal.signal``: the guard then stays unarmed
        and is still usable as a plain stop flag."""
        if not self._armed:
            try:
                self._previous = signal.signal(signal.SIGTERM, self._handle)
                self._armed = True
            except ValueError:
                pass  # not the main thread
        return self

    def uninstall(self) -> None:
        """Restore the previous disposition."""
        if self._armed:
            signal.signal(signal.SIGTERM, signal.SIG_DFL if self._previous is None else self._previous)
            self._armed = False
