"""Two-rank data-parallel training of the port on the CPU: two OS
processes joined by ``parallel.initialize`` over a localhost ``tcp://``
coordinator with the gloo backend, on the pattern of
``tests/test_multiprocess.py``.  The worker processes import no JAX.

* Three gray rp steps and three CelebA steps, at a global batch of 2 (one
  image a rank, so every BatchNorm statistic needs the other rank's),
  from the numpy-seeded flax variables and draws of
  ``test_torch_port_step_dsprites.py`` / ``test_torch_port_step_celeba.py``
  (carried over by ``interop.from_jax``), against the JAX single-device
  step on the global batch (JAX data parallelism equals it,
  ``tests/test_parallel.py``) and against the port's one-rank step.
* ZeRO-1 on two ranks against replicated data parallelism on two ranks:
  bit-equal losses, parameters and gathered Adam moments (the slices see
  the same averaged gradients and the same elementwise Adam).
* ``cli.supervise --ranks 2 pxy -- --data_parallel``: SIGTERM to rank 1
  alone stops both ranks at one step (exit 86), with one train-state
  file, written by rank 0; it restores under one process and matches a
  one-rank run to the same step, and ``--resume auto`` continues it.

Tolerances, with their reasons:

* against JAX, as the single-device step files state: losses rtol 1e-4
  at step 0 (float32, only summation orders differ) and 3e-3 over the
  three steps at the low learning rates (Adam's sign steps on
  near-zero gradients compound);
* against the port's one-rank step at the same global batch: losses
  rtol 1e-5 at step 0 and 1e-3 over the steps (a mean of two one-image
  means and two gradients averaged instead of one mean over two images:
  rounding only, then Adam's sign steps), and parameters after the three
  steps within 2 * lr * 3 of each optimizer that stepped them (the
  largest move three Adam steps of opposite sign can make), most
  elements far closer;
* a gang's train state against a one-rank run of the same steps:
  parameters within 2 * lr * steps.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from eadgan_tpu_torch.train.chain import snapshot_state
from eadgan_tpu_torch.train.checkpoint import restore_train_state, saved_steps, train_state_payload

import tests.test_torch_port_step_celeba as step_celeba
import tests.test_torch_port_step_dsprites as step_dsprites
from tests.test_torch_port_jax_files import drop_big_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _env(**extra):
    env = dict(os.environ, EADGAN_PLATFORM="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])),
               **extra)
    for name in ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
                 "WORLD_SIZE", "RANK", "MASTER_ADDR", "EADGAN_DIST_BACKEND"):
        env.pop(name, None)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORKER = textwrap.dedent(
    """
    import sys
    import torch
    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.train.config import CelebaConfig, SpritesGanConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    assert parallel.initialize(f"localhost:{port}", 2, rank, device="cpu") == torch.device("cpu")
    assert "jax" not in sys.modules
    parallel.host_barrier("start")  # on the store, before any collective
    inputs = torch.load(work + "/inputs.pt", weights_only=False)

    def build(name):
        case = inputs[name]
        if name == "celeba":
            config = CelebaConfig(**case["config"])
            state = init_celeba_gan_state(config, device="cpu", seed=0)
            step = make_celeba_gan_step(config)
        else:
            config = SpritesGanConfig(**case["config"])
            pxy = pxy_encoder(False, seed=1)
            pxy.load_state_dict(case["init"]["pxy"])
            state = init_sprites_gan_state(config, pxy, device="cpu", seed=0)
            step = make_sprites_gan_step(config)
        for k in ("g", "d", "e"):
            if k in case["init"] and k != "pxy":
                getattr(state, k).load_state_dict(case["init"][k])
        return case, state, step

    results = {}
    for name, zero in (("rp", False), ("rp", True), ("celeba", False)):
        case, state, step = build(name)
        state = parallel.replicate(state)
        if zero:
            parallel.zero_place(state)
        step = parallel.data_parallel_step(step)
        rows = parallel.host_batch_slice(len(case["imgs"]))
        losses = []
        for fixed in case["draws"]:
            state, metrics = step(state, torch.from_numpy(case["imgs"][rows]), fixed)
            losses.append({k: float(v) for k, v in metrics.items()})
        tag = name + ("_zero" if zero else "")
        parallel.save_on_coordinator(f"{work}/{tag}.ckpt", state)
        results[tag] = losses
    if parallel.is_coordinator():
        torch.save(results, work + "/losses.pt")
    parallel.sync()
    print("WORKER_DONE", rank, flush=True)
    """
)


def _capture(module, maker_name, run):
    """Run ``run()`` (a one-rank port run beside JAX in ``module``) with
    the port's step wrapped, recording its config, the state's weights
    before the first step, the images and each step's ``fixed`` draws."""
    real = getattr(module, maker_name)
    seen = {"draws": []}

    def maker(config):
        seen["config"] = dataclasses.asdict(config)
        inner = real(config)

        def step(state, imgs, fixed):
            if "init" not in seen:
                seen["init"] = {k: {n: t.clone() for n, t in getattr(state, k).state_dict().items()}
                                for k in ("g", "d", "e", "pxy") if getattr(state, k, None) is not None}
                seen["imgs"] = imgs.numpy().copy()
            seen["draws"].append({k: np.asarray(v) for k, v in fixed.items()})
            return inner(state, imgs, fixed)

        return step

    setattr(module, maker_name, maker)
    try:
        out = run()
    finally:
        setattr(module, maker_name, real)
    return seen, out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """JAX and the port's one rank on the global batch (the step files'
    runs), then the same weights and draws through two gloo ranks."""
    work = tmp_path_factory.mktemp("two_ranks")
    rp_in, (rp_jax, rp_one, _, rp_state) = _capture(
        step_dsprites, "make_sprites_gan_step", lambda: step_dsprites.run_rp(False, steps=STEPS))
    cel_in, (cel_jax, cel_one, _, cel_state) = _capture(
        step_celeba, "make_celeba_gan_step",
        lambda: step_celeba.run_both(STEPS, step_celeba.LOW_LR, seed=2))
    torch.save({"rp": rp_in, "celeba": cel_in}, work / "inputs.pt")
    script = work / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(work)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs
    losses = torch.load(work / "losses.pt", weights_only=False)
    yield {
        "rp": (rp_jax, rp_one, rp_state, rp_in["config"], losses["rp"], work / "rp.ckpt"),
        "celeba": (cel_jax, cel_one, cel_state, cel_in["config"], losses["celeba"],
                   work / "celeba.ckpt"),
        "rp_zero": (losses["rp"], losses["rp_zero"], work / "rp.ckpt", work / "rp_zero.ckpt"),
    }
    drop_big_files(work)  # the ranks' train states and inputs: ~0.7 GB


def _assert_losses(ref, got, rtol0, rtol):
    assert len(ref) == len(got) == STEPS
    for s, (a, b) in enumerate(zip(ref, got)):
        assert set(a) == set(b)
        for k in a:
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=rtol0 if s == 0 else rtol,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("pipeline", ["rp", "celeba"])
def test_two_ranks_match_jax_on_the_global_batch(two_ranks, pipeline):
    jax_losses, _, _, _, two, _ = two_ranks[pipeline]
    _assert_losses(jax_losses, two, rtol0=1e-4, rtol=3e-3)


# the optimizers that step each model, by their config's learning rates
_LRS = {"rp": {"g": ("lr",), "e": ("lr",), "d": ("d_lr",)},
        "celeba": {"g": ("g_lr", "info_lr"), "d": ("d_lr", "info_lr")}}


@pytest.mark.parametrize("pipeline", ["rp", "celeba"])
def test_two_ranks_match_one_rank(two_ranks, pipeline, tmp_path):
    _, one, one_state, config, two, path = two_ranks[pipeline]
    _assert_losses(one, two, rtol0=1e-5, rtol=1e-3)
    state = snapshot_state(one_state)  # shares no storage with the one-rank state
    ref = train_state_payload(one_state)
    restore_train_state(str(path), state)  # the gang's file, under one process
    got = train_state_payload(state)
    assert got["step"] == ref["step"] == STEPS
    for model, keys in _LRS[pipeline].items():
        bound = 2 * STEPS * sum(config[k] for k in keys)
        for name, p in got[model].items():
            if p.is_floating_point():
                diff = (p - ref[model][name]).abs().max().item()
                assert diff <= bound, f"{model}.{name}: {diff} > {bound}"


def test_zero_two_ranks_bit_equal_to_replicated(two_ranks):
    dp_losses, zero_losses, dp_path, zero_path = two_ranks["rp_zero"]
    assert dp_losses == zero_losses
    dp, zero = (torch.load(p, weights_only=True) for p in (dp_path, zero_path))
    assert dp.keys() == zero.keys()
    for field in dp:
        a, b = dp[field], zero[field]
        if field.startswith("opt"):
            assert a["param_groups"] == b["param_groups"]
            assert a["state"].keys() == b["state"].keys() and a["state"]
            for i in a["state"]:
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(a["state"][i][k], b["state"][i][k]), (field, i, k)
        elif isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a), field
        else:
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


# --- the gang under cli.supervise ---------------------------------------------------

PXY_ARGS = ["--batch_size", "4", "--sample_interval", "1000", "--chain", "1", "--compute", "f32"]


def _children(pid):
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        return [int(c) for c in f.read().split()]


def _rank_of(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)
    return int(env.get(b"EADGAN_MP_PROCESS_ID", b"-1"))


def test_gang_stop_one_file_restores_under_one_process(tmp_path):
    """SIGTERM to rank 1 alone: the gang agrees on one step S at its next
    poll, both ranks save collectively and exit 86, rank 0 writes the one
    file; it restores under one process, equal (within Adam's bound) to a
    one-rank run of S steps, and ``--resume auto`` continues it."""
    from eadgan_tpu_torch.cli import pxy
    from eadgan_tpu_torch.train.config import PxyConfig
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.train.pretrain import init_pxy_state

    gang_dir, one_dir = tmp_path / "gang", tmp_path / "one"
    common = [*PXY_ARGS, "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "img")]
    sup = subprocess.Popen(
        [sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--ranks", "2", "pxy", "--",
         *common, "--ckpt_dir", str(gang_dir), "--data_parallel", "--max_steps", "5000"],
        env=_env(EADGAN_SYNTH_POS="2"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    try:
        for line in sup.stdout:
            if line.startswith("[Epoch "):
                break  # rank 0 logged step 0: both ranks are in the loop
        ranks = {_rank_of(c): c for c in _children(sup.pid)}
        assert set(ranks) == {0, 1}, ranks
        os.kill(ranks[1], signal.SIGTERM)
        out, err = sup.communicate(timeout=120)
    finally:
        if sup.poll() is None:
            os.killpg(sup.pid, signal.SIGKILL)
            sup.wait()
    assert sup.returncode == 86, (out[-2000:], err[-3000:])
    saved = [int(l.rsplit(" ", 1)[1]) for l in out.splitlines()
             if l.startswith("graceful shutdown: saving final train state at step ")]
    stopped = [int(l.rsplit(" ", 1)[1]) for l in out.splitlines()
               if l.startswith("graceful shutdown: rank 1 stopped at step ")]
    assert len(saved) == len(stopped) == 1 and saved == stopped, out[-2000:]
    s = saved[0]
    assert saved_steps(str(gang_dir), "encoder_pxy_train_state") == [s, 0]
    assert 0 < s < 5000

    env = {"EADGAN_PLATFORM": "cpu", "EADGAN_SYNTH_POS": "2"}
    ran = []
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        mp.setattr(pxy, "run_epochs", lambda **kw: ran.append(run_epochs(**kw)))
        pxy.main([*common, "--ckpt_dir", str(one_dir), "--max_steps", str(s),
                  "--preempt_save", "off"])
    config = PxyConfig(batch_size=4)
    gang, one = init_pxy_state(config, device="cpu"), ran[0]
    restore_train_state(str(gang_dir / f"encoder_pxy_train_state_{s}.ckpt"), gang)
    assert gang.step == one.step == s
    for (name, a), b in zip(gang.model.state_dict().items(), one.model.state_dict().values()):
        if a.is_floating_point() and not name.endswith(("running_mean", "running_var")):
            assert (a - b).abs().max().item() <= 2 * config.lr * s, name

    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        pxy.main([*common, "--ckpt_dir", str(gang_dir), "--max_steps", "1", "--resume", "auto",
                  "--preempt_save", "off", "--jsonl", str(tmp_path / "resumed.jsonl")])
    records = [json.loads(l) for l in (tmp_path / "resumed.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [s]
