"""The port's supervisor (``cli/supervise.py``) on stub trainers, and the
port trainer CLIs' run flags and rank-environment refusal
(``cli/common.py``)."""

import importlib
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from eadgan_tpu_torch.cli import supervise
from eadgan_tpu_torch.utils.preempt import PREEMPT_EXIT_CODE
from eadgan_tpu_torch.utils.watchdog import STALL_EXIT_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(*paths, **extra):
    return dict(
        os.environ,
        EADGAN_PLATFORM="cpu",
        PYTHONPATH=os.pathsep.join(filter(None, [*map(str, paths), REPO,
                                                 os.environ.get("PYTHONPATH", "")])),
        **extra,
    )


@pytest.fixture(autouse=True)
def _restore_sigterm():
    """``supervise.main`` installs a process-wide SIGTERM handler."""
    before = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, before)


@pytest.mark.parametrize("argv", [
    [],
    ["--batch_size", "4"],
    ["--resume", "auto"],
    ["--resume", "x.ckpt", "--max_steps", "10"],
    ["--resume=x.ckpt", "--chain", "4"],
    ["--a", "--resume", "auto", "--b", "--resume=y", "--resume", "z"],
])
def test_with_resume_auto_matches_jax(argv):
    from eadgan_tpu.cli.supervise import with_resume_auto as jax_with_resume_auto

    out = supervise.with_resume_auto(argv)
    assert out == jax_with_resume_auto(argv)
    assert out[-2:] == ["--resume", "auto"] and out.count("--resume") == 1
    assert supervise.with_resume_auto(out) == out  # restarts do not grow the line


STUB_TRAINER = textwrap.dedent("""
    import argparse, json, os, time
    from eadgan_tpu_torch.utils.watchdog import Watchdog

    p = argparse.ArgumentParser()
    p.add_argument("--resume", default="")
    p.add_argument("--state_dir", required=True)
    opt = p.parse_args()
    ckpt = os.path.join(opt.state_dir, "ckpt.json")
    step = 0
    if opt.resume == "auto" and os.path.exists(ckpt):
        step = json.load(open(ckpt))["step"]
        print(f"resumed from step {step}", flush=True)
    wd = Watchdog(0.4, first_timeout=2.0).start()
    for s in range(step, 8):
        time.sleep(0.02)  # the train step
        json.dump({"step": s + 1}, open(ckpt, "w"))
        wd.beat(s + 1)
        if s + 1 == 4 and opt.resume != "auto":
            time.sleep(3600)  # wedged, on the first life only
    wd.stop()
    print("stub trainer finished", flush=True)
""")


def test_supervise_restarts_a_wedged_trainer(tmp_path, capsys, monkeypatch):
    """The trainer wedges -> its watchdog exits 87 -> the supervisor
    relaunches it with --resume auto -> it finishes from its checkpoint."""
    pkg = tmp_path / "wdstub"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "trainer.py").write_text(STUB_TRAINER)
    monkeypatch.setenv("PYTHONPATH", _env(tmp_path)["PYTHONPATH"])
    supervise.main(["--max_restarts", "2", "wdstub.trainer", "--state_dir", str(tmp_path)])
    assert json.loads((tmp_path / "ckpt.json").read_text())["step"] == 8
    out = capsys.readouterr().out
    assert "restart 1/2 with --resume auto" in out
    assert "finished cleanly after 1 restart(s)" in out


def test_supervise_gives_up_after_budget(tmp_path):
    script = tmp_path / "always_stalls.py"
    script.write_text(textwrap.dedent("""
        import time
        from eadgan_tpu_torch.utils.watchdog import Watchdog
        Watchdog(0.3, first_timeout=0.3).start()
        time.sleep(3600)
    """))
    proc = subprocess.run(
        [sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--max_restarts", "1",
         str(script)],
        env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == STALL_EXIT_CODE
    assert "restart 1/1" in proc.stdout and "giving up after exit 87" in proc.stdout


def test_bare_trainer_name_resolves_to_the_port(tmp_path, monkeypatch, capsys):
    launched = []

    class Done:
        def __init__(self, cmd, env=None):
            launched.append(cmd)

        def poll(self):
            return 0

    monkeypatch.setattr(supervise.subprocess, "Popen", Done)
    supervise.main(["celeba", "--", "--max_steps", "2"])
    assert launched == [[sys.executable, "-m", "eadgan_tpu_torch.cli.celeba", "--max_steps", "2"]]


# --- gangs (--ranks N) ----------------------------------------------------

GANG_STUB = textwrap.dedent("""
    import argparse, json, os, sys, time

    p = argparse.ArgumentParser()
    p.add_argument("--state_dir", required=True)
    p.add_argument("--resume", default="")
    p.add_argument("--mode", default="stall_rank1")
    opt = p.parse_args()
    rank = os.environ["EADGAN_MP_PROCESS_ID"]
    record = {"resume": opt.resume, "coord": os.environ["EADGAN_MP_COORDINATOR"],
              "nprocs": os.environ["EADGAN_MP_NUM_PROCESSES"]}
    with open(os.path.join(opt.state_dir, f"rank{rank}.jsonl"), "a") as f:
        f.write(json.dumps(record) + "\\n")
    marker = os.path.join(opt.state_dir, "stalled_once")
    first_life = not os.path.exists(marker)

    def lives(r):
        path = os.path.join(opt.state_dir, f"rank{r}.jsonl")
        return len(open(path).readlines()) if os.path.exists(path) else 0

    if opt.mode == "stall_rank1" and rank == "1" and first_life:
        # a file barrier: fail only once rank 0 has written this life's
        # record, so the supervisor's teardown cannot cut it off
        deadline = time.monotonic() + 60
        while lives(0) < lives(1) and time.monotonic() < deadline:
            time.sleep(0.01)
        open(marker, "w").close()
        sys.exit(87)
    if opt.mode == "peer_hangs" and first_life:
        if rank == "0":
            time.sleep(0.3)  # this rank's watchdog fires
            open(marker, "w").close()
            sys.exit(87)
        time.sleep(3600)  # parked in a collective: must be killed
    print(f"rank {rank} done", flush=True)
""")


def test_gang_restart_with_fresh_coordinator_port(tmp_path, capsys):
    """One rank exits 87 -> the WHOLE gang is relaunched with --resume
    auto and a fresh coordinator port."""
    script = tmp_path / "gang_stub.py"
    script.write_text(GANG_STUB)
    supervise.main(["--ranks", "2", "--max_restarts", "2", str(script), "--", "--state_dir",
                    str(tmp_path)])
    lives = {r: [json.loads(x) for x in (tmp_path / f"rank{r}.jsonl").read_text().splitlines()]
             for r in (0, 1)}
    assert len(lives[0]) == 2 and len(lives[1]) == 2  # the healthy rank restarted too
    for r in (0, 1):
        assert [life["resume"] for life in lives[r]] == ["", "auto"]
        assert lives[r][0]["nprocs"] == "2"
    assert lives[0][0]["coord"] != lives[0][1]["coord"]
    assert lives[0][1]["coord"] == lives[1][1]["coord"]
    out = capsys.readouterr().out
    assert "restart 1/2 with --resume auto" in out
    assert "finished cleanly after 1 restart(s)" in out


def test_gang_kills_wedged_survivor(tmp_path, capsys):
    script = tmp_path / "gang_stub.py"
    script.write_text(GANG_STUB)
    t0 = time.monotonic()
    supervise.main(["--ranks", "2", "--max_restarts", "1", str(script), "--", "--state_dir",
                    str(tmp_path), "--mode", "peer_hangs"])
    assert time.monotonic() - t0 < 60  # far below the parked rank's 3600 s
    assert "finished cleanly after 1 restart(s)" in capsys.readouterr().out


def test_supervisor_sigterm_fans_out_to_the_gang(tmp_path):
    """SIGTERM to the supervisor takes the gang down with it (orphans
    would double-run against the next launch); it exits 143."""
    script = tmp_path / "sleeper.py"
    script.write_text(textwrap.dedent(f"""
        import os, time
        rank = os.environ["EADGAN_MP_PROCESS_ID"]
        with open(os.path.join({str(tmp_path)!r}, f"pid{{rank}}"), "w") as f:
            f.write(str(os.getpid()))
        time.sleep(3600)
    """))
    sup = subprocess.Popen([sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--ranks",
                            "2", str(script)], env=_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 60
        pids = []
        while time.monotonic() < deadline and len(pids) < 2:
            pids = [int((tmp_path / f"pid{r}").read_text()) for r in (0, 1)
                    if (tmp_path / f"pid{r}").exists() and (tmp_path / f"pid{r}").read_text()]
            time.sleep(0.05)
        assert len(pids) == 2, "gang never launched"
        sup.send_signal(signal.SIGTERM)
        sup.wait(timeout=60)
    finally:
        if sup.poll() is None:
            sup.kill()
            sup.wait()
    assert sup.returncode == 128 + signal.SIGTERM
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_group_sigterm_lets_a_supervised_trainer_save(tmp_path):
    """SIGTERM to the supervisor's whole process group (as Slurm, systemd
    or ``kill -TERM -<pgid>`` send it) reaches the trainer twice: directly
    and from the graceful ladder a few milliseconds later.  The guard
    takes the second as the same request, so the trainer finishes its
    save and exits 86."""
    script = tmp_path / "guarded.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        from eadgan_tpu_torch.utils.preempt import PreemptionGuard
        guard = PreemptionGuard().install()
        open(os.path.join({str(tmp_path)!r}, "armed"), "w").close()
        while not guard.requested.is_set():
            time.sleep(0.01)
        time.sleep(1.0)  # the final save: the ladder's SIGTERM lands inside it
        with open(os.path.join({str(tmp_path)!r}, "saved"), "w") as f:
            f.write("86")
        sys.exit(86)
    """))
    sup = subprocess.Popen([sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", str(script)],
                           env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           start_new_session=True)
    try:
        deadline = time.monotonic() + 60
        while not (tmp_path / "armed").exists() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert (tmp_path / "armed").exists(), "the trainer never armed its guard"
        os.killpg(sup.pid, signal.SIGTERM)
        sup.wait(timeout=60)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
            sup.wait()
    assert sup.returncode == 128 + signal.SIGTERM
    assert (tmp_path / "saved").read_text() == "86"


@pytest.mark.parametrize("peer,want", [(PREEMPT_EXIT_CODE, PREEMPT_EXIT_CODE),
                                       (0, PREEMPT_EXIT_CODE),
                                       (STALL_EXIT_CODE, STALL_EXIT_CODE)])
def test_reap_after_graceful_stop(peer, want, capsys):
    """Rank 0 exits 86 first: the gang stopped gracefully and 86
    propagates, unless a peer failed otherwise in the grace window."""
    code = ("import os, sys, time; r = os.environ['EADGAN_MP_PROCESS_ID']; "
            f"time.sleep(0 if r == '0' else 0.5); sys.exit(86 if r == '0' else {peer})")
    procs = supervise._launch_gang([sys.executable, "-c", code], 2)
    assert supervise._reap_gang(procs) == want
    assert f"peers after a graceful stop exited [{peer}]" in capsys.readouterr().out


def test_launch_gang_kills_partial_gang_on_spawn_failure(monkeypatch):
    launched = []
    real_popen = subprocess.Popen

    def flaky_popen(cmd, env=None, **kw):
        if len(launched) == 2:
            raise OSError("spawn failed (injected)")
        p = real_popen([sys.executable, "-c", "import time; time.sleep(3600)"])
        launched.append(p)
        return p

    monkeypatch.setattr(supervise.subprocess, "Popen", flaky_popen)
    with pytest.raises(OSError, match="injected"):
        supervise._launch_gang(["whatever"], ranks=4)
    assert len(launched) == 2
    for p in launched:
        p.wait(timeout=15)


# --- the trainer CLIs ---------------------------------------------------------

TRAINERS = ["celeba", "pxy", "pxy_color", "rp", "rp_color", "mnist", "approximate_rpqmnxy"]


def _refusing_card(monkeypatch, name):
    """The CLI module with ``platform_device`` replaced by a trap."""
    module = importlib.import_module(f"eadgan_tpu_torch.cli.{name}")
    base = importlib.import_module(
        {"pxy_color": "eadgan_tpu_torch.cli.pxy", "rp_color": "eadgan_tpu_torch.cli.rp"}.get(
            name, module.__name__))

    def trap():
        raise AssertionError("the CLI picked the device")

    monkeypatch.setattr(base, "platform_device", trap)
    return module


@pytest.mark.parametrize("name", TRAINERS)
@pytest.mark.parametrize("env", [{"EADGAN_MP_NUM_PROCESSES": "2"},
                                 {"EADGAN_MP_COORDINATOR": "localhost:1234"},
                                 {"WORLD_SIZE": "2", "RANK": "0"}],
                         ids=["num_processes", "coordinator", "torchrun"])
def test_trainer_refuses_multiprocess_env(name, env, monkeypatch, tmp_path):
    """A rank environment naming more than one process stops every trainer
    run without ``--data_parallel`` before it touches the card, as the JAX
    CLIs refuse it: each rank would train an independent model against
    the same checkpoint paths.  The approximator has no such flag."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    module = _refusing_card(monkeypatch, name)
    with pytest.raises(SystemExit) as e:
        module.main(["--ckpt_dir", str(tmp_path)])
    want = ("has no --data_parallel" if name == "approximate_rpqmnxy"
            else "pass --data_parallel")
    assert "multi-process run requested" in str(e.value.code) and want in str(e.value.code)


def test_single_process_env_is_no_multiprocess_run(monkeypatch):
    import argparse

    import torch.distributed as dist

    from eadgan_tpu_torch.cli.common import init_multiprocess

    monkeypatch.setenv("EADGAN_MP_NUM_PROCESSES", "1")
    monkeypatch.setenv("EADGAN_MP_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("WORLD_SIZE", "1")
    opt = argparse.Namespace(data_parallel=False, zero_opt=False)
    assert init_multiprocess(opt, lambda: torch.device("cpu")) == torch.device("cpu")
    assert not dist.is_initialized()  # no group joined
