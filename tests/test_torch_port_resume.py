"""Port train state and resume: ``eadgan_tpu_torch.train.checkpoint``,
``cli.common.maybe_resume`` and the resumed epoch schedule.

* A straight run of 5 CelebA steps equals, bit for bit on the CPU, 2
  steps + save + restore (into a state built from another seed) + 3
  steps: every parameter, buffer, Adam moment and step count, the
  ``torch.Generator`` state and ``step`` (mirrors ``tests/test_resume.py``).
  Bit for bit because both runs do the same float32 operations in the
  same order on the same CPU.
* ``restore_latest`` skips a damaged newest file; ``prune_saved`` keeps
  the newest files, anchors to the step just written after a fallback,
  and sweeps temporary files of dead writers.
* The resumed schedule (rows and flips per step) equals the JAX CLI's
  default chained engine, computed from ``plan_windows`` and the same
  numpy generators, and checked against a run of that engine on every
  step of the resumed epoch; the run ends at the planned total.
  Tolerance 1e-6: both sides compute ``x * (1/127.5) - 1`` in float32,
  and the JAX engine's native batcher may fuse it into one multiply-add.
* The CLI on the CPU: a run with ``--keep_states 2`` saves the train
  state, and ``--resume auto`` continues from its step to the planned
  total.
* The crash-during-save drill (``EADGAN_FAULT_KILL_SAVE_STEP``): a save
  truncated mid-write exits 87, and under ``cli.supervise`` the relaunch
  skips the truncated file and resumes from the previous one.
"""

import json
import os
import subprocess
import sys
import textwrap
import types
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from eadgan_tpu.train.chain import plan_windows
from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.cli import celeba as cli
from eadgan_tpu_torch.cli.common import maybe_resume
from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
from eadgan_tpu_torch.train.state import GanTrainState, adam
from tests.test_torch_port_jax_files import drop_big_files

B = 2


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


def _tensors(state):
    """Every tensor of a train state, by name."""
    out = {}
    for prefix, model in (("g", state.g), ("d", state.d)):
        for k, v in model.state_dict().items():
            out[f"{prefix}.{k}"] = v
    for name in ("opt_g", "opt_d", "opt_info"):
        for idx, st in getattr(state, name).state_dict()["state"].items():
            for k, v in st.items():
                out[f"{name}.{idx}.{k}"] = v
    out["rng"] = state.rng.get_state()
    return out


def test_resume_bit_exact(tmp_path):
    config = CelebaConfig(batch_size=B)
    step = make_celeba_gan_step(config)
    imgs = torch.from_numpy(
        np.random.default_rng(0).uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    )

    straight = init_celeba_gan_state(config, device="cpu", seed=0)
    for _ in range(5):
        step(straight, imgs)

    inter = init_celeba_gan_state(config, device="cpu", seed=0)
    for _ in range(2):
        step(inter, imgs)
    path = ckpt.save_train_state(str(tmp_path), "celeba_train_state", 1, inter)
    del inter
    restored = ckpt.restore_train_state(path, init_celeba_gan_state(config, device="cpu", seed=1))
    assert restored.step == 2
    for _ in range(3):
        step(restored, imgs)

    assert restored.step == straight.step == 5
    want, got = _tensors(straight), _tensors(restored)
    assert set(want) == set(got)
    assert any(k.endswith("exp_avg_sq") for k in want) and "d.main.0.u" in want
    for k in want:
        assert torch.equal(want[k], got[k]), k


def _tiny_state(seed):
    torch.manual_seed(seed)
    g, d = nn.Linear(3, 2), nn.Sequential(nn.Linear(2, 1), nn.BatchNorm1d(1))
    state = GanTrainState(
        g=g, d=d, opt_g=adam(g.parameters(), 1e-3), opt_d=adam(d.parameters(), 1e-3),
        opt_info=adam([*g.parameters(), *d.parameters()], 1e-3),
        rng=torch.Generator().manual_seed(seed), step=seed,
    )
    loss = g(torch.ones(1, 3)).sum() + d(torch.ones(4, 2)).sum()
    loss.backward()
    for opt in (state.opt_g, state.opt_d, state.opt_info):
        opt.step()
    return state


def test_restore_latest_skips_damaged_newest(tmp_path, capsys):
    ckpt.save_train_state(str(tmp_path), "s", 100, _tiny_state(1))
    ckpt.save_train_state(str(tmp_path), "s", 200, _tiny_state(2))
    full = (tmp_path / "s_200.ckpt").read_bytes()
    (tmp_path / "s_300.ckpt").write_bytes(full[: len(full) // 2])

    state, step = ckpt.restore_latest(str(tmp_path), "s", _tiny_state(9))
    assert step == 200 and state.step == 2
    ref = _tiny_state(2)
    for k, v in _tensors(ref).items():
        assert torch.equal(_tensors(state)[k], v), k
    assert "s_300.ckpt failed to load" in capsys.readouterr().err

    # a loadable file that is no train state is skipped too
    torch.save({"w": torch.zeros(1)}, tmp_path / "s_400.ckpt")
    _, step = ckpt.restore_latest(str(tmp_path), "s", _tiny_state(9))
    assert step == 200

    # nothing loads: the state is left as it was
    for name in ("s_100.ckpt", "s_200.ckpt"):
        (tmp_path / name).write_bytes(b"\x00")
    fresh = _tiny_state(9)
    before = _tensors(fresh)
    state, step = ckpt.restore_latest(str(tmp_path), "s", fresh)
    assert step == -1 and state.step == 9
    for k, v in _tensors(state).items():
        assert torch.equal(before[k], v), k


def test_maybe_resume(tmp_path, capsys):
    ckpt.save_train_state(str(tmp_path), "s", 10, _tiny_state(3))
    (tmp_path / "s_20.ckpt").write_bytes(b"truncated")
    assert maybe_resume(_tiny_state(9), "auto", str(tmp_path), "s").step == 3
    assert maybe_resume(_tiny_state(9), str(tmp_path / "s_10.ckpt"), "", "s").step == 3
    assert maybe_resume(_tiny_state(9), "", str(tmp_path), "s").step == 9
    assert maybe_resume(_tiny_state(9), "auto", str(tmp_path / "none"), "s").step == 9
    assert "starting fresh" in capsys.readouterr().out


def test_prune_saved_retention(tmp_path):
    state = _tiny_state(1)
    ckpt.save_checkpoint(str(tmp_path / "checkpoint_100.tar"), {"w": torch.zeros(1)})
    for step in (100, 200, 300):
        ckpt.save_train_state(str(tmp_path), "s_train_state", step, state, keep=0)
    assert ckpt.saved_steps(str(tmp_path), "s_train_state") == [300, 200, 100]
    assert ckpt.latest_step(str(tmp_path), "s_train_state") == 300

    path = ckpt.save_train_state(str(tmp_path), "s_train_state", 400, state, keep=2)
    assert path.endswith("s_train_state_400.ckpt")
    assert ckpt.saved_steps(str(tmp_path), "s_train_state") == [400, 300]
    assert (tmp_path / "checkpoint_100.tar").exists()  # model files are never pruned

    (tmp_path / "s_train_state_400.ckpt").write_bytes(b"bad")
    _, step = ckpt.restore_latest(str(tmp_path), "s_train_state", _tiny_state(9))
    assert step == 300  # keep=2 left a fallback
    assert ckpt.prune_saved(str(tmp_path), "absent", keep=1) == []
    assert ckpt.latest_step(str(tmp_path), "absent") == -1


def test_prune_anchors_to_current_step_after_fallback(tmp_path):
    # one life reached step 400 and left it damaged; the next resumed at 300
    (tmp_path / "s_400.ckpt").write_bytes(b"corrupt")
    ckpt.save_train_state(str(tmp_path), "s", 300, _tiny_state(1))
    ckpt.save_train_state(str(tmp_path), "s", 310, _tiny_state(2), keep=1)
    assert ckpt.saved_steps(str(tmp_path), "s") == [310]
    _, step = ckpt.restore_latest(str(tmp_path), "s", _tiny_state(9))
    assert step == 310


def test_orphan_sweep(tmp_path):
    dead_pid = 4_000_000  # above the kernel's default pid_max: never a live process
    orphan = tmp_path / f"s_100.ckpt.tmp.{dead_pid}"
    orphan.write_bytes(b"partial")
    ckpt.save_train_state(str(tmp_path), "s", 100, _tiny_state(1))  # swept, keep=0 too
    assert not orphan.exists() and (tmp_path / "s_100.ckpt").exists()

    (tmp_path / f"s_50.ckpt.tmp.{dead_pid}").write_bytes(b"partial")
    live = tmp_path / f"s_60.ckpt.tmp.{os.getpid()}"
    live.write_bytes(b"inflight")
    removed = ckpt.prune_saved(str(tmp_path), "s", keep=5)
    assert str(tmp_path / f"s_50.ckpt.tmp.{dead_pid}") in removed
    assert live.exists()


def _planned_schedule(data, batch_size, n_epochs, seed, start, max_steps):
    """(step, rows, flip mask) of every step from ``start``: the JAX
    chained engine's windows (``plan_windows``; rows taken from the start
    of each epoch's fresh permutation, one flip draw per batch in batch
    order), with the resumed epoch cut at its end."""
    host_rng = np.random.default_rng(seed)
    flip_rng = np.random.default_rng([seed, 0x464C4950])
    n_batches = data.shape[0] // batch_size
    total = n_epochs * n_batches
    stop = min(total, start + max_steps) if max_steps else total
    out, s = [], start
    while s < stop:
        perm = host_rng.permutation(data.shape[0])
        epoch_end = (s // n_batches + 1) * n_batches
        for w0, k in plan_windows(s, epoch_end - s, 4, (), stop):
            for i in range(w0, w0 + k):
                o = (i - s) * batch_size
                out.append((i, perm[o : o + batch_size], flip_rng.random(batch_size) < 0.5))
        s = epoch_end
    return out


def _host_batch(data, rows, mask):
    x = data[rows].astype(np.float32) * (1.0 / 127.5) - 1.0
    x[mask] = x[mask, :, ::-1]
    return x


class _JaxState(typing.NamedTuple):
    step: object


def _jax_body(state, img):
    return _JaxState(state.step + 1), {"x": jnp.sum(img)}


@pytest.mark.parametrize("start,max_steps", [(4, 0), (5, 0), (4, 2), (7, 3)])
def test_resumed_schedule_matches_chained_engine(rng, start, max_steps):
    data = rng.integers(0, 256, (10, 8, 6, 3), dtype=np.uint8)
    common = dict(n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps,
                  scale=1.0 / 127.5, shift=-1.0, random_flip=True)
    plan = _planned_schedule(data, 3, 3, 7, start, max_steps)

    port = []

    def port_step(state, batch):
        port.append(batch.numpy().copy())
        state.step += 1
        return state, {}

    state = run_epochs(state=types.SimpleNamespace(step=start), step_fn=port_step,
                       on_batch=lambda *a: None, device="cpu", **common)
    assert len(port) == len(plan) > 0
    assert state.step == plan[-1][0] + 1 == (min(9, start + max_steps) if max_steps else 9)
    for got, (_, rows, mask) in zip(port, plan):
        np.testing.assert_allclose(got, _host_batch(data, rows, mask), rtol=0, atol=1e-6)

    # a run of the JAX CLI's default engine gives the same rows and flips
    # to every step of the resumed epoch
    jax_batches = {}
    jax_run_epochs(
        labels=None, state=_JaxState(jnp.int32(start)), step_fn=None,
        on_batch=lambda i, st, m, b: jax_batches.setdefault(i, np.array(b[0])),
        chain=4, chain_periods=(1,), step_body=_jax_body, **common,
    )
    epoch_end = (start // 3 + 1) * 3
    shared = [(i, got) for (i, _, _), got in zip(plan, port) if i < epoch_end]
    assert shared
    for i, got in shared:
        np.testing.assert_allclose(got, jax_batches[i], rtol=0, atol=1e-6, err_msg=str(i))


def test_cli_keeps_states_and_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_N", "16")  # 4 batches of 4: planned total 4
    common = [
        "--batch_size", "4", "--n_epochs", "1", "--sample_interval", "1000",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), "--keep_states", "2",
    ]
    first = tmp_path / "first.jsonl"
    cli.main(common + ["--max_steps", "1", "--jsonl", str(first)])
    assert [json.loads(r)["step"] for r in first.read_text().splitlines()] == [0]
    assert ckpt.saved_steps(str(tmp_path), cli.STATE_STEM) == [0]
    saved = torch.load(tmp_path / "celeba_train_state_0.ckpt", weights_only=True)
    assert saved["step"] == 1

    second = tmp_path / "second.jsonl"
    cli.main(common + ["--resume", "auto", "--compute", "bf16", "--jsonl", str(second)])
    records = [json.loads(r) for r in second.read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert all(np.isfinite(r["d_loss"]) and np.isfinite(r["g_loss"]) for r in records)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ, EADGAN_PLATFORM="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])),
               **extra)
    for name in ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
                 "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        env.pop(name, None)
    return env


# --- the crash-during-save drill ----------------------------------------------------

DRILL = textwrap.dedent(
    """
    import sys
    from eadgan_tpu_torch.train.checkpoint import save_train_state
    from eadgan_tpu_torch.train.config import PxyConfig
    from eadgan_tpu_torch.train.pretrain import init_pxy_state
    state = init_pxy_state(PxyConfig(batch_size=2), device="cpu")
    save_train_state(sys.argv[1], "train_state", 1, state)
    save_train_state(sys.argv[1], "train_state", 2, state)
    print("unreachable", flush=True)
    """
)


def test_fault_kill_mid_write_hook(tmp_path):
    """At or after the fault step a train-state save writes half its
    bytes to the final path and exits 87; restore falls back past it."""
    from eadgan_tpu_torch.train.config import PxyConfig
    from eadgan_tpu_torch.train.pretrain import init_pxy_state

    script = tmp_path / "drill.py"
    script.write_text(DRILL)
    marker = tmp_path / "fault.marker"
    proc = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                          text=True, timeout=120,
                          env=_env(EADGAN_FAULT_KILL_SAVE_STEP="2",
                                   EADGAN_FAULT_KILL_SAVE_MARKER=str(marker)))
    assert proc.returncode == 87, proc.stderr[-2000:]
    assert "unreachable" not in proc.stdout and marker.exists()
    assert "fault injection: truncated mid-write" in proc.stdout
    full, cut = (os.path.getsize(tmp_path / f"train_state_{i}.ckpt") for i in (1, 2))
    assert cut == full // 2
    _, step = ckpt.restore_latest(str(tmp_path), "train_state", init_pxy_state(PxyConfig(), device="cpu"))
    assert step == 1


def test_supervised_crash_during_save_resumes_from_the_previous_file(tmp_path):
    """``cli.supervise pxy_color`` (a train state every 10 steps at
    ``--sample_interval 1``) with the hook armed at step 10: the save at
    step 10 is truncated and the trainer exits 87; the relaunch's
    ``--resume auto`` skips that file, restores step 0's and trains on,
    rewriting step 10's file whole; exit 0 (``tests/test_resume.py``'s
    drill of the JAX package)."""
    marker = tmp_path / "fault.marker"
    proc = subprocess.run(
        [sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--max_restarts", "1",
         "pxy_color", "--", "--batch_size", "4", "--sample_interval", "1", "--chain", "4",
         "--max_steps", "12", "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "img"),
         "--ckpt_dir", str(tmp_path)],
        env=_env(EADGAN_SYNTH_POS="2", EADGAN_FAULT_KILL_SAVE_STEP="10",
                 EADGAN_FAULT_KILL_SAVE_MARKER=str(marker)),
        capture_output=True, text=True, timeout=300)
    out, err = proc.stdout, proc.stderr
    assert proc.returncode == 0, (out[-2000:], err[-3000:])
    assert "fault injection: truncated mid-write" in out and marker.exists()
    assert "child exited 87" in out and "finished cleanly after 1 restart(s)" in out
    assert "encoder_pxy_color_train_state_10.ckpt failed to load" in err
    assert "--resume auto: restored" in out and "encoder_pxy_color_train_state_0.ckpt" in out
    assert ckpt.saved_steps(str(tmp_path), "encoder_pxy_color_train_state") == [10, 0]
    torch.load(tmp_path / "encoder_pxy_color_train_state_10.ckpt", weights_only=True)  # whole now
