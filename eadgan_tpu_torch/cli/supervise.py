"""Supervised trainer launcher: automatic stall recovery for long runs.

    python -m eadgan_tpu_torch.cli.supervise [--max_restarts N] \
        [--restart_on_error] [--ranks N] <trainer> [--] [trainer args...]

PyTorch counterpart of ``eadgan_tpu/cli/supervise.py``.  ``<trainer>``
is a trainer CLI name (``celeba``, ``rp``, ``mnist``, ``pxy``,
``rp_color``, ...), which resolves to ``eadgan_tpu_torch.cli.<name>``; a
dotted name is used as a module path as it is, and a path ending in
``.py`` is run as a script.  The child runs as a subprocess; when it
exits with the watchdog's ``STALL_EXIT_CODE`` (87; pass ``--watchdog
SECONDS`` to the trainer to arm it, ``utils/watchdog.py``), the
supervisor relaunches it with ``--resume auto``, which restores the
newest train state.

``--restart_on_error`` widens the restart condition to any nonzero exit
(a crash, an out-of-memory error, a preemption's 86), still bounded by
``--max_restarts``.

Exit codes of a trainer: 0 the schedule finished; 86 a SIGTERM stopped
it after a final save (``utils/preempt.py``); 87 the watchdog found it
stalled.

Multi-process runs (``--ranks N``): the supervisor owns the whole gang.
It launches N replicas of the command, each with the rank environment
``EADGAN_MP_PROCESS_ID``, ``EADGAN_MP_NUM_PROCESSES`` and
``EADGAN_MP_COORDINATOR`` (a fresh localhost coordinator port each
life, since a coordinator cannot be rejoined after a member died).  A
trainer run with ``--data_parallel`` joins the gang through
``parallel.initialize`` (``cli/common.py::init_multiprocess``), one rank
per card (``EADGAN_DIST_BACKEND=gloo`` lets ranks share one); without
the flag it refuses the rank environment.  Ranks of a distributed run
fail together: one wedged rank parks every peer inside a collective, so
the first rank to exit nonzero condemns the gang; the supervisor kills
the survivors (SIGTERM, then SIGKILL after 2 s) and relaunches all ranks
with ``--resume auto``.

* **SIGTERM to the supervisor** (host eviction): it fans SIGTERM out
  with the graceful 30 s ladder, each rank saves at its window's end and
  exits 86, and the supervisor exits 143.  A second SIGTERM to the
  supervisor is ignored once the teardown has begun, so the ladder
  always reaches its SIGKILL and no rank is orphaned.  When the stop is
  sent to the whole process group or cgroup (Slurm, systemd's
  ``KillMode=control-group``, ``kill -TERM -<pgid>``) each rank gets
  SIGTERM twice, directly and from the ladder.  The supervisor sets
  ``EADGAN_SUPERVISED=1`` in every rank's environment, and a rank's guard
  then takes the second SIGTERM as the same request
  (``utils/preempt.py``), so the rank still saves and exits 86.
* **A first rank exit of 86** means the gang stopped gracefully: the
  peers get 30 s to finish their own exits, and 86 propagates (the
  supervisor gives up unless ``--restart_on_error``).  A peer that exits
  with another nonzero code in that window is reported, and its code is
  returned instead (a stall still restarts); a peer still running after
  it is killed, with a warning that its final save may be missing.
* **A first rank exit of anything else** (87, a crash) tears the gang
  down with the fast ladder and restarts from the last cadence save.

On restart any ``--resume`` the command carried is replaced by a single
``--resume auto`` (:func:`with_resume_auto`).  The trainers count
``--max_steps`` from the restored step, so a restarted ``--max_steps N``
run trains N further steps; schedules bounded by ``--n_epochs`` resume to
their original end.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time

from eadgan_tpu_torch.utils.preempt import PREEMPT_EXIT_CODE
from eadgan_tpu_torch.utils.watchdog import STALL_EXIT_CODE

__all__ = ["with_resume_auto", "main"]

PEER_GRACE_S = 30.0  # a graceful stop: window + final save
FAST_GRACE_S = 2.0  # condemned ranks: parked in a collective, waiting buys nothing


def with_resume_auto(args):
    """Return ``args`` with exactly one trailing ``--resume auto``: any
    ``--resume X`` / ``--resume=X`` is stripped first, so repeated
    restarts do not grow the command line."""
    out, i = [], 0
    while i < len(args):
        if args[i] == "--resume":
            i += 2  # the flag and its value
            continue
        if args[i].startswith("--resume="):
            i += 1
            continue
        out.append(args[i])
        i += 1
    return out + ["--resume", "auto"]


def _free_port() -> int:
    """An ephemeral port that was free when probed.  The probe socket
    closes before rank 0 binds it, so another service can take it in
    between; the gang then fails at start, which costs one
    ``--restart_on_error`` life (a fresh port next time)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_gang(cmd, ranks):
    """Start ``ranks`` replicas of ``cmd`` as one gang, each marked with
    ``EADGAN_SUPERVISED=1``.  More than one rank also get the
    ``EADGAN_MP_*`` triple with a fresh coordinator port."""
    supervised = dict(os.environ, EADGAN_SUPERVISED="1")
    if ranks == 1:
        return [subprocess.Popen(cmd, env=supervised)]
    port = _free_port()
    procs = []
    try:
        for i in range(ranks):
            env = dict(
                supervised,
                EADGAN_MP_PROCESS_ID=str(i),
                EADGAN_MP_NUM_PROCESSES=str(ranks),
                EADGAN_MP_COORDINATOR=f"localhost:{port}",
            )
            procs.append(subprocess.Popen(cmd, env=env))
    except BaseException:
        # a failed spawn mid-gang must not orphan the ranks already started
        _kill_gang(procs)
        raise
    return procs


def _kill_gang(procs, grace: float = FAST_GRACE_S) -> None:
    """Terminate every rank still running: SIGTERM, ``grace`` s, SIGKILL.

    The fast ladder (2 s) is for a condemned gang, whose survivors are
    parked in a collective their dead peer never joins: their SIGTERM
    guard only sets a flag they cannot poll.  The graceful ladder (30 s)
    is for a supervisor that got SIGTERM itself: every rank is healthy,
    finishes its window, saves and exits 86.  SIGKILL is always safe:
    checkpoint writes are atomic."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is not None:
            continue
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def _reap_gang(procs) -> int:
    """Wait until every rank exits 0, or any rank exits nonzero, and
    return 0 or that rank's code (see the module docstring for 86)."""
    live = list(procs)
    while live:
        for p in list(live):
            rc = p.poll()
            if rc is None:
                continue
            live.remove(p)
            if rc == 0:
                continue
            if rc == PREEMPT_EXIT_CODE:
                return _reap_graceful(live, rc)
            _kill_gang(live)
            return rc
        if live:
            time.sleep(0.25)
    return 0


def _reap_graceful(peers, rc: int) -> int:
    """A rank exited 86: give its peers ``PEER_GRACE_S`` to finish their
    own graceful exits, report what each did, and return 86 unless a peer
    failed otherwise (then its code)."""
    deadline = time.monotonic() + PEER_GRACE_S
    for q in peers:
        try:
            q.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    stragglers = [q for q in peers if q.poll() is None]
    failed = [q.returncode for q in peers
              if q.returncode not in (None, 0, PREEMPT_EXIT_CODE)]
    if peers:
        print("supervise: peers after a graceful stop exited "
              f"{[q.returncode for q in peers]}", flush=True)
    if stragglers:
        print(f"supervise: warning: {len(stragglers)} rank(s) still running "
              f"{PEER_GRACE_S:.0f} s after a graceful stop are killed; their final "
              "save may be missing", flush=True)
        _kill_gang(stragglers)
    return failed[0] if failed else rc


def _ignore_sigterm() -> None:
    try:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
    except ValueError:
        pass  # not the main thread


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument(
        "--max_restarts", type=int, default=5,
        help="restart budget before giving up and propagating the exit code",
    )
    parser.add_argument(
        "--restart_on_error", action="store_true",
        help="restart on ANY nonzero exit, not only the watchdog's stall code",
    )
    parser.add_argument(
        "--ranks", type=int, default=1,
        help="launch N replicas as one gang (rank environment and a localhost "
        "coordinator injected); any rank's failure restarts all. The port's "
        "trainers refuse a multi-process environment until multi-process "
        "training is ported",
    )
    parser.add_argument("trainer", help="trainer CLI name (e.g. celeba, rp, mnist)")
    parser.add_argument(
        "args", nargs=argparse.REMAINDER,
        help="arguments passed through to the trainer",
    )
    opt = parser.parse_args(argv)

    # SIGTERM would kill this process without unwinding and orphan the
    # gang; as SystemExit the teardown below runs.
    try:
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    except ValueError:
        pass  # not the main thread

    if opt.trainer.endswith(".py"):
        base_cmd = [sys.executable, opt.trainer]
    else:
        module = (
            opt.trainer if "." in opt.trainer else f"eadgan_tpu_torch.cli.{opt.trainer}"
        )
        base_cmd = [sys.executable, "-m", module]
    child_args = list(opt.args)
    if child_args[:1] == ["--"]:
        child_args = child_args[1:]

    restarts = 0
    while True:
        cmd = base_cmd + child_args
        gang = f" x{opt.ranks} ranks" if opt.ranks > 1 else ""
        print(f"supervise: launching {' '.join(cmd)}{gang}", flush=True)
        procs = _launch_gang(cmd, opt.ranks)
        try:
            rc = _reap_gang(procs)
        except BaseException as exc:
            # The supervisor itself is dying: take the gang down with it.
            # Its own SIGTERM is a host preemption (graceful ladder); a
            # second one must not cut the ladder short.
            _ignore_sigterm()
            preempted = isinstance(exc, SystemExit) and exc.code == 128 + signal.SIGTERM
            _kill_gang(procs, grace=PEER_GRACE_S if preempted else FAST_GRACE_S)
            raise
        if rc == 0:
            print(f"supervise: trainer finished cleanly after {restarts} restart(s)",
                  flush=True)
            return
        stalled = rc == STALL_EXIT_CODE
        if (stalled or opt.restart_on_error) and restarts < opt.max_restarts:
            restarts += 1
            print(
                f"supervise: child exited {rc} "
                f"({'watchdog stall' if stalled else 'error'}); "
                f"restart {restarts}/{opt.max_restarts} with --resume auto",
                flush=True,
            )
            child_args = with_resume_auto(child_args)
            continue
        print(f"supervise: giving up after exit {rc} ({restarts} restart(s) used)",
              flush=True)
        sys.exit(rc)


if __name__ == "__main__":
    main()
