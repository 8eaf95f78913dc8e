"""Graceful preemption in the port: ``utils/preempt.py``, the engines'
``stop_event`` / ``on_shutdown`` contract, ``cut_short`` and the trainer
CLIs' SIGTERM path, held against the JAX package where both run the same
schedule."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from eadgan_tpu_torch.cli.common import exit_if_preempted
from eadgan_tpu_torch.train.checkpoint import saved_steps
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.utils.preempt import PREEMPT_EXIT_CODE, PreemptionGuard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    return dict(
        os.environ,
        EADGAN_PLATFORM="cpu",
        PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])),
        **extra,
    )


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """The guard installs a process-wide handler: never leak it."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


# ---------------------------------------------------------------- guard


def test_guard_sets_event_on_sigterm_and_uninstalls(capfd):
    guard = PreemptionGuard().install()
    assert not guard.requested.is_set()
    os.kill(os.getpid(), signal.SIGTERM)
    deadline = time.monotonic() + 5
    while not guard.requested.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert guard.requested.is_set()
    # written with os.write(2, ...), which bypasses sys.stderr
    assert "preemption: caught signal" in capfd.readouterr().err
    guard.uninstall()
    assert not guard._armed


def test_guard_install_is_idempotent_and_restores_original():
    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard().install().install()
    assert guard._armed and signal.getsignal(signal.SIGTERM) == guard._handle
    guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_outside_main_thread_is_a_plain_flag():
    out = {}

    def arm():
        out["guard"] = PreemptionGuard().install()

    t = threading.Thread(target=arm)
    t.start()
    t.join()
    guard = out["guard"]
    assert not guard._armed
    guard.requested.set()
    assert guard.requested.is_set()


@pytest.mark.parametrize("supervised", [False, True], ids=["alone", "supervised"])
def test_second_sigterm_kills(supervised, tmp_path):
    """The first SIGTERM only sets the flag; the second restores SIG_DFL
    and re-delivers, so the process dies by the signal.  Under
    ``cli.supervise`` (``EADGAN_SUPERVISED=1``) the second is the same
    stop request and the process lives on to finish its save."""
    script = tmp_path / "hostage.py"
    script.write_text(textwrap.dedent("""
        import time
        from eadgan_tpu_torch.utils.preempt import PreemptionGuard
        g = PreemptionGuard().install()
        print("armed", flush=True)
        while True:
            time.sleep(0.05)
            if g.requested.is_set():
                print("flagged", flush=True)  # keeps looping: a slow save
    """))
    env = _env(EADGAN_SUPERVISED="1" if supervised else "")
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        assert "armed" in proc.stdout.readline()
        proc.send_signal(signal.SIGTERM)
        assert "flagged" in proc.stdout.readline()
        proc.send_signal(signal.SIGTERM)
        if supervised:
            with pytest.raises(subprocess.TimeoutExpired):
                proc.wait(timeout=1.0)
        else:
            proc.wait(timeout=30)
            assert proc.returncode == -signal.SIGTERM
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ------------------------------------------------- engine stop contract


@dataclasses.dataclass
class ToyState:
    """One parameter and the step counter: the engines' whole contract."""

    w: torch.Tensor
    step: int = 0


def _toy_step(state, batch):
    state.w += batch.mean()
    state.step += 1
    return state, {"loss": batch.mean()}


DATA = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)  # 8 batches of 8


def _toy_run(chain, stop_at=None, max_steps=0, n_epochs=4, stop=None, period=2):
    """The toy schedule on the port: on_batch sets ``stop`` at step index
    ``stop_at``; returns (final state, on_batch steps, shutdowns, stop)."""
    stop = stop if stop is not None else threading.Event()
    seen, shutdowns = [], []

    def on_batch(i, state, metrics, batch):
        seen.append(i)
        if stop_at is not None and i >= stop_at:
            stop.set()

    out = run_epochs(
        n_epochs=n_epochs, data=DATA, batch_size=8, state=ToyState(torch.zeros(4)),
        step_fn=_toy_step, on_batch=on_batch, device="cpu", max_steps=max_steps,
        chain=chain, chain_periods=(period,) if chain > 1 else (), stop_event=stop,
        on_shutdown=lambda s, st: shutdowns.append((s, st.step, st.w.clone())),
    )
    return out, seen, shutdowns, stop


@pytest.mark.parametrize("chain", [1, 4])
def test_engine_stops_at_boundary_and_fires_on_shutdown(chain, monkeypatch, capsys):
    monkeypatch.setenv("EADGAN_SYNC_EVENTS", "1")
    out, seen, shutdowns, stop = _toy_run(chain, stop_at=5)
    assert len(shutdowns) == 1
    s, step, w = shutdowns[0]
    assert s == step == out.step
    # the per-step engine stops after the step that saw the flag; the
    # chained one at the end of that window (events every 2 steps)
    assert out.step == (6 if chain == 1 else 7)
    assert max(seen) == out.step - 1
    assert torch.equal(w, out.w)
    assert stop.cut_short is True
    log = capsys.readouterr().out
    assert f"graceful shutdown: saving final train state at step {out.step}" in log
    assert "graceful shutdown: final train state saved in" in log


def test_engine_without_stop_event_runs_full_schedule():
    out, _, shutdowns, stop = _toy_run(1, n_epochs=2)
    assert out.step == 16 and not shutdowns and not hasattr(stop, "cut_short")


def test_stop_event_already_set_trains_one_window_and_saves():
    stop = threading.Event()
    stop.set()
    out, _, shutdowns, _ = _toy_run(4, stop=stop)
    assert [s for s, _, _ in shutdowns] == [out.step] and out.step >= 1


@pytest.mark.parametrize("chain", [1, 4])
@pytest.mark.parametrize("cut", [True, False], ids=["mid_schedule", "final_step"])
def test_cut_short(chain, cut, monkeypatch):
    """A stop mid-schedule is cut short; one that lands on the final step
    of a schedule that finished is not."""
    monkeypatch.setenv("EADGAN_SYNC_EVENTS", "1")
    max_steps = 6
    out, _, shutdowns, stop = _toy_run(chain, stop_at=2 if cut else max_steps - 1,
                                       max_steps=max_steps, period=1)
    assert stop.cut_short is cut
    assert (out.step < max_steps) is cut
    assert len(shutdowns) == 1


def test_exit_if_preempted_gates_on_cut_short(capsys):
    exit_if_preempted(None)
    exit_if_preempted(PreemptionGuard())  # never signalled

    guard = PreemptionGuard()
    guard.requested.set()
    guard.requested.cut_short = True
    with pytest.raises(SystemExit) as e:
        exit_if_preempted(guard)
    assert e.value.code == PREEMPT_EXIT_CODE == 86

    done = PreemptionGuard()
    done.requested.set()
    done.requested.cut_short = False
    exit_if_preempted(done)  # the schedule finished: exit 0
    assert "COMPLETE" in capsys.readouterr().out

    late = PreemptionGuard()  # signalled after run_epochs returned
    late.requested.set()
    exit_if_preempted(late)


@pytest.mark.parametrize("pipeline", ["pxy", "rp"])
def test_stopped_state_equals_a_run_to_the_same_step(pipeline):
    """``tools/stop_check.py`` on the CPU: the state ``on_shutdown`` copies
    after a stop at a window end is, bit for bit, that of a ``max_steps``
    run to the same step (on the card: ``chip_smoke.py`` and the ``cuda``
    tests)."""
    from eadgan_tpu_torch.tools.stop_check import run_stop_check

    report = run_stop_check(pipeline, batch=4, chain=2, stop_at=2, device="cpu")
    assert report["ok"], report
    assert report["stopped_at"] == 4 and report["window_ends"] == [2, 4]
    assert report["tensors_compared"] > 10


# ------------------------------------------------ parity with the JAX package


@pytest.mark.parametrize("chain", [1, 4])
@pytest.mark.parametrize("stop_at", [5, 13])
def test_stop_matches_jax_package(chain, stop_at, monkeypatch):
    """The same toy schedule with the stop set at the same step through
    ``eadgan_tpu.train.engine.run_epochs`` and the port's: the same final
    step, the same ``cut_short`` and the same ``on_batch`` steps."""
    import jax
    import jax.numpy as jnp
    from flax import struct

    from eadgan_tpu.train.engine import run_epochs as jax_run_epochs

    monkeypatch.setenv("EADGAN_SYNC_EVENTS", "1")

    class JaxToy(struct.PyTreeNode):
        w: jnp.ndarray
        step: jnp.ndarray

    def body(state, batch):
        return state.replace(w=state.w + jnp.mean(batch), step=state.step + 1), {
            "loss": jnp.mean(batch)}

    stop, seen, shutdowns = threading.Event(), [], []

    def on_batch(i, state, metrics, batch):
        seen.append(int(i))
        if i >= stop_at:
            stop.set()

    out = jax_run_epochs(
        n_epochs=4, data=DATA, labels=None, batch_size=8,
        state=JaxToy(w=jnp.zeros((4,)), step=jnp.zeros((), jnp.int32)),
        step_fn=jax.jit(body), on_batch=on_batch, chain=chain,
        chain_periods=(2,) if chain > 1 else (), step_body=body if chain > 1 else None,
        stop_event=stop, on_shutdown=lambda s, st: shutdowns.append(int(s)),
    )
    port, port_seen, port_shutdowns, port_stop = _toy_run(chain, stop_at=stop_at)
    assert port.step == int(jax.device_get(out.step))
    assert port_stop.cut_short == stop.cut_short
    assert port_seen == seen
    assert [s for s, _, _ in port_shutdowns] == shutdowns
    np.testing.assert_allclose(port.w.numpy(), np.asarray(out.w), rtol=1e-6)


# --------------------------------------------------------- the CLI drill


# the drills' CLIs run beside other test workers: two threads each keep
# them from contending for every core
DRILL_ENV = {"EADGAN_SYNTH_POS": "2", "OMP_NUM_THREADS": "2"}


def _pxy(tmp_path, *extra):
    return [sys.executable, "-m", "eadgan_tpu_torch.cli.pxy", "--batch_size", "4",
            "--n_epochs", "2", "--sample_interval", "1000", "--data_dir", str(tmp_path),
            "--out_dir", str(tmp_path / "img"), "--ckpt_dir", str(tmp_path), *extra]


def _sigterm_after_first_log(proc):
    """SIGTERM once the run logged step 0 (the first window drained)."""
    for line in proc.stdout:
        if line.startswith("[Epoch"):
            proc.send_signal(signal.SIGTERM)
            return
    raise AssertionError("the run ended before it logged a step")


def test_cli_sigterm_saves_final_state_and_resumes(tmp_path):
    """``cli.pxy`` (batch 4, 60 batches an epoch, 2 epochs): SIGTERM mid
    run gives rc 86 and the train state at the stop step; ``--resume
    auto`` continues from it to the planned step 120 with rc 0."""
    env = _env(**DRILL_ENV)
    stem = "encoder_pxy_train_state"
    proc = subprocess.Popen(_pxy(tmp_path), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        _sigterm_after_first_log(proc)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == PREEMPT_EXIT_CODE, (out, err)
    assert "preemption: caught signal" in err
    line = next(x for x in out.splitlines() if x.startswith("graceful shutdown: saving"))
    final = int(line.rsplit(" ", 1)[1])
    assert 1 <= final < 120
    assert "preemption save complete" in out
    assert final in saved_steps(str(tmp_path), stem)
    saved = torch.load(tmp_path / f"{stem}_{final}.ckpt", weights_only=True)
    assert saved["step"] == final

    jsonl = tmp_path / "resumed.jsonl"
    done = subprocess.run(_pxy(tmp_path, "--resume", "auto", "--jsonl", str(jsonl)), env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, (done.stdout, done.stderr)
    steps = [json.loads(line)["step"] for line in jsonl.read_text().splitlines()]
    assert steps == list(range(final, 120))


def test_preempt_save_off_dies_by_sigterm(tmp_path):
    proc = subprocess.Popen(_pxy(tmp_path, "--preempt_save", "off"), env=_env(**DRILL_ENV),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _sigterm_after_first_log(proc)
        proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == -signal.SIGTERM
