"""The port's stall watchdog (``utils/watchdog.py``) and the engine's
heartbeat, grace and hang hook (``train/engine.py::run_epochs``)."""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from eadgan_tpu_torch.train import chain as chain_module
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.utils import watchdog as watchdog_module
from eadgan_tpu_torch.utils.watchdog import STALL_EXIT_CODE, Watchdog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    return dict(
        os.environ,
        EADGAN_PLATFORM="cpu",
        PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])),
        **extra,
    )


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# Each case: (timeout, first_timeout, actions, step the stall reports or
# "quiet" when it must not fire).  Actions: ("beat", step), ("grace",) (of
# first_timeout seconds), ("clear",), ("sleep", s), ("quiet",) (assert no
# stall so far).
CASES = {
    "fires_without_beats": (0.15, 0.15, [], None),
    "beats_prevent_firing": (0.3, 0.3, [a for s in range(12) for a in (("beat", s), ("sleep", 0.05))],
                             "quiet"),
    # before the first beat the larger first_timeout governs
    "first_timeout_covers_the_first_window": (0.1, 0.8, [("sleep", 0.35), ("quiet",), ("beat", 1)], 1),
    # beats do not release a grace; clear_grace does
    "grace_survives_beats_until_released": (
        0.15, 5.0, [("beat", 1), ("grace",), ("beat", 2), ("sleep", 0.5), ("quiet",), ("clear",)], 2),
    # a grace never released still expires: a stall inside it is found late, not never
    "grace_expires_on_its_own": (0.1, 0.3, [("beat", 1), ("grace",)], 1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_watchdog(case):
    timeout, first, actions, want = CASES[case]
    fired = []
    wd = Watchdog(timeout, first_timeout=first, on_stall=fired.append).start()
    try:
        for action, *arg in actions:
            if action == "beat":
                wd.beat(arg[0])
            elif action == "grace":
                wd.grace()
            elif action == "clear":
                wd.clear_grace()
            elif action == "sleep":
                time.sleep(arg[0])
            else:
                assert not fired, fired
        if want == "quiet":
            assert not fired
        else:
            assert _wait_for(lambda: fired, timeout=2.0)
            assert fired[0]["event"] == "watchdog_stall"
            assert fired[0]["exit_code"] == STALL_EXIT_CODE == 87
            assert fired[0]["step"] == want
    finally:
        wd.stop()
    if want == "quiet":
        time.sleep(0.2)
        assert not fired  # stop() disarms: no late firing either


@pytest.mark.parametrize("env,timeout,first", [("", 15.0, 900.0), ("", 1200.0, 1200.0),
                                                ("40", 15.0, 40.0)])
def test_first_timeout_default(env, timeout, first, monkeypatch):
    monkeypatch.setenv("EADGAN_WATCHDOG_FIRST", env)
    assert Watchdog(timeout).first_timeout == first


def test_rejects_nonpositive_timeout():
    with pytest.raises(ValueError):
        Watchdog(0.0)


def test_stalled_process_exits_87_with_stacks(tmp_path):
    script = tmp_path / "wedge.py"
    script.write_text(textwrap.dedent("""
        import time
        from eadgan_tpu_torch.utils.watchdog import Watchdog
        wd = Watchdog(0.3, first_timeout=0.3).start()
        wd.beat(7)
        time.sleep(3600)
    """))
    proc = subprocess.run([sys.executable, str(script)], env=_env(), cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == STALL_EXIT_CODE
    assert "watchdog_stall" in proc.stderr
    assert "Current thread" in proc.stderr or "Thread 0x" in proc.stderr
    record = next(line for line in proc.stderr.splitlines() if "watchdog_stall" in line)
    assert json.loads(record)["step"] == 7
    assert 'wedge.py", line 6' in proc.stderr  # the wedged main thread's frame


# --------------------------------------------------------- through the engine

HANG_STUB = textwrap.dedent("""
    import dataclasses, sys
    import numpy as np, torch
    from eadgan_tpu_torch.train.engine import run_epochs

    @dataclasses.dataclass
    class Toy:
        w: torch.Tensor
        step: int = 0

    def step(state, batch):
        state.w += batch.mean()
        state.step += 1
        return state, {"loss": batch.mean()}

    out = run_epochs(n_epochs=2, data=np.ones((64, 4), np.float32), batch_size=8,
                     state=Toy(torch.zeros(4)), step_fn=step, on_batch=lambda *a: None,
                     device="cpu", chain=int(sys.argv[1]), watchdog=1.0)
    print(f"finished at step {out.step}", flush=True)
""")


@pytest.mark.parametrize("chain", [1, 4])
def test_hang_hook_through_run_epochs(chain, tmp_path):
    """``EADGAN_FAULT_HANG_STEP`` wedges the first beat at or past that
    step (after beats at 1-4, or at 4 in windows of 4, so the steady 1 s
    timeout governs, not the first window's); the watchdog exits 87; with
    the marker left behind, the next run does not hang and finishes."""
    script = tmp_path / "hang.py"
    script.write_text(HANG_STUB)
    marker = tmp_path / "fault_fired"
    env = _env(EADGAN_FAULT_HANG_STEP="5", EADGAN_FAULT_HANG_MARKER=str(marker))
    cmd = [sys.executable, str(script), str(chain)]
    first = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=60)
    assert first.returncode == STALL_EXIT_CODE, (first.stdout, first.stderr)
    assert "fault injection: hanging at step" in first.stdout
    assert "watchdog_stall" in first.stderr
    assert marker.exists()
    second = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=60)
    assert second.returncode == 0, second.stderr
    assert "finished at step 16" in second.stdout


class _Recorder:
    """A stand-in for ``Watchdog`` that records the engine's calls."""

    log = []

    def __init__(self, timeout):
        pass

    def start(self):
        return self

    def stop(self):
        pass

    def beat(self, step=None):
        self.log.append(("beat", step))

    def grace(self):
        self.log.append(("grace",))

    def clear_grace(self):
        self.log.append(("clear_grace",))


def test_grace_opens_before_the_capturing_window_and_closes_at_its_drain(monkeypatch):
    """The window that captures the graph (on the card: the first after
    the eager step) runs under a grace, released when that window's
    metrics are drained; beats come after each drain.  The CPU never
    captures, so ``will_capture`` is stubbed to name that window."""
    log = _Recorder.log = []
    monkeypatch.setattr(watchdog_module, "Watchdog", _Recorder)
    calls = []

    def will_capture(self, windows):
        calls.append(windows[0].shape[0])
        return len(calls) == 2

    monkeypatch.setattr(chain_module.ChainedStep, "will_capture", will_capture)

    def step(state, batch):
        log.append(("step", state.step))
        state.step += 1
        return state, {"loss": batch.mean()}

    class Toy:
        step = 0

    run_epochs(n_epochs=1, data=np.ones((16, 2), np.float32), batch_size=1, state=Toy(),
               step_fn=step, on_batch=lambda *a: None, device="cpu", chain=4,
               chain_periods=(8,), watchdog=5.0)
    # windows (0, 1) eager, (1, 4) captures, (5, 4) ends at the event, (9, 4), (13, 2), (15, 1)
    assert calls == [1, 4, 4, 4, 2, 1]
    grace = log.index(("grace",))
    assert log[grace - 1] == ("step", 0) and log[grace + 1] == ("step", 1)
    clear = log.index(("clear_grace",))
    # released at the drain of (1, 4), after (5, 4) was dispatched
    assert log[clear - 2:clear] == [("step", 7), ("step", 8)]
    assert log[clear + 1] == ("beat", 5)
    assert log.count(("grace",)) == 1 and log.count(("clear_grace",)) == 1
    beats = [e[1] for e in log if e[0] == "beat"]
    assert beats == [1, 5, 9, 13, 15, 16]
