"""The CelebA step on a (data, model) = (2, 2) grid of four gloo ranks on
the CPU, against the JAX single-device step and the port's one rank.

Four OS processes join one group (``parallel.initialize`` over a
localhost ``tcp://`` coordinator), lay themselves out with
``parallel.default_mesh(2)``, and run three CelebA steps at the low
learning rates of ``test_torch_port_step_celeba.py`` at a global batch
of 2 (one image a data rank: every BatchNorm statistic needs the other
data rank's) from the numpy-seeded flax variables and draws that file's
``run_both`` uses, once with G's transposed convs 0-2 and D's SN convs
1-3 sharded on their output channels (``shard_model_params``) and once
with ZeRO-1 on top (``zero_place(state, mesh)``).  The workers import no
JAX.

Bars, from the JAX package's own 2-D test
(``tests/test_parallel.py::test_celeba_step_2d_mesh``):

* against the port's one rank at the same global batch and draws:
  losses rtol 2e-4 / atol 1e-5 at step 0, rtol 1e-3 at step 1 and 1e-2
  at step 2 (atol 1e-4: Adam's sign steps on near-zero gradients
  compound); parameters after step 0 within 2.1 Adam steps (a flipped
  sign), fewer than 0.5% of elements beyond half a step, a step being
  the model's own optimizer's rate (``g_lr`` for G, as the JAX test
  writes it; ``d_lr`` for D, which that test leaves out): at this batch
  both meet it without counting ``opt_info``'s step, which
  ``tools/tp_check.py`` adds at the card's batches;
* against JAX's single-device step at step 0: rtol 3e-4 (the JAX 2-D
  mesh equals that step by its own test);
* ZeRO on the grid against no ZeRO, and the grid's file restored at one
  rank against what the ranks held: bit for bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from eadgan_tpu_torch.train.checkpoint import restore_train_state, train_state_payload
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

import tests.test_torch_port_step_celeba as step_celeba
from tests.test_torch_port_jax_files import drop_big_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3

WORKER = textwrap.dedent(
    """
    import sys
    import torch
    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    parallel.initialize(f"localhost:{port}", 4, rank, device="cpu")
    assert "jax" not in sys.modules
    parallel.host_barrier("start")
    mesh = parallel.default_mesh(2)
    case = torch.load(work + "/inputs.pt", weights_only=False)
    config = CelebaConfig(**case["config"])
    rows = parallel.host_batch_slice(len(case["imgs"]), mesh)
    imgs = torch.from_numpy(case["imgs"][rows])

    out = {"mesh": (mesh.data, mesh.model, mesh.data_index, mesh.model_index)}
    for tag in ("tp", "zero"):
        state = init_celeba_gan_state(config, device="cpu", seed=0)
        state.g.load_state_dict(case["init"]["g"])
        state.d.load_state_dict(case["init"]["d"])
        parallel.replicate(state)
        parallel.shard_model_params(mesh, state)
        if tag == "zero":
            parallel.zero_place(state, mesh)
        shardings = [parallel.state_shardings(state)]
        step = parallel.data_parallel_step(make_celeba_gan_step(config), mesh)
        losses = []
        for i, fixed in enumerate(case["draws"]):
            state, metrics = step(state, imgs, fixed)
            losses.append({k: float(v) for k, v in metrics.items()})
            shardings.append(parallel.state_shardings(state))
            if i == 0 and tag == "tp":
                parallel.save_on_coordinator(f"{work}/tp_step0.ckpt", state)
        parallel.save_on_coordinator(f"{work}/{tag}.ckpt", state)
        out[tag] = {"losses": losses, "shardings": shardings}
        if tag == "tp":  # what this rank holds: its shards, its moments' shards
            out["local"] = {
                "g": {k: v.clone() for k, v in state.g.state_dict().items()},
                "d": {k: v.clone() for k, v in state.d.state_dict().items()},
                **{f: getattr(state, f).state_dict() for f in ("opt_g", "opt_d", "opt_info")},
            }
    torch.save(out, f"{work}/rank{rank}.pt")
    parallel.sync()
    print("WORKER_DONE", rank, flush=True)
    """
)


def _env():
    env = dict(os.environ, EADGAN_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])))
    for name in ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "EADGAN_DIST_BACKEND"):
        env.pop(name, None)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _capture(run):
    """``run()`` (JAX and the port's one rank, ``run_both``) with the
    port's step wrapped: its config, the weights before the first step,
    the images and each step's draws."""
    real = step_celeba.make_celeba_gan_step
    seen = {"draws": []}

    def maker(config):
        seen["config"] = dataclasses.asdict(config)
        inner = real(config)

        def step(state, imgs, fixed):
            if "init" not in seen:
                seen["init"] = {k: {n: t.clone() for n, t in getattr(state, k).state_dict().items()}
                                for k in ("g", "d")}
                seen["imgs"] = imgs.numpy().copy()
            seen["draws"].append({k: np.asarray(v) for k, v in fixed.items()})
            return inner(state, imgs, fixed)

        return step

    step_celeba.make_celeba_gan_step = maker
    try:
        out = run()
    finally:
        step_celeba.make_celeba_gan_step = real
    return seen, out


def _one_rank(case, steps):
    """The port's one rank from the captured weights, ``steps`` steps."""
    config = CelebaConfig(**case["config"])
    state = init_celeba_gan_state(config, device="cpu", seed=0)
    state.g.load_state_dict(case["init"]["g"])
    state.d.load_state_dict(case["init"]["d"])
    step = make_celeba_gan_step(config)
    for fixed in case["draws"][:steps]:
        state, _ = step(state, torch.from_numpy(case["imgs"]), fixed)
    return state


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    work = tmp_path_factory.mktemp("grid")
    case, (jax_losses, one_losses, _, _) = _capture(
        lambda: step_celeba.run_both(STEPS, step_celeba.LOW_LR, seed=2))
    torch.save(case, work / "inputs.pt")
    script = work / "worker.py"
    script.write_text(WORKER)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, str(work)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=400) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 4, [o[1][-3000:] for o in outs]
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]
    yield {"case": case, "jax": jax_losses, "one": one_losses, "ranks": ranks, "work": work}
    drop_big_files(work)  # the ranks' files and train states: ~3.2 GB


def test_grid_layout(grid):
    assert [r["mesh"] for r in grid["ranks"]] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0),
                                                 (2, 2, 1, 1)]


def _losses(rank, tag):
    return rank[tag]["losses"]


def test_every_rank_logs_the_same_losses(grid):
    for tag in ("tp", "zero"):
        assert all(_losses(r, tag) == _losses(grid["ranks"][0], tag) for r in grid["ranks"])


def test_grid_matches_one_rank(grid):
    got = _losses(grid["ranks"][0], "tp")
    assert len(got) == len(grid["one"]) == STEPS
    for s, (want, have) in enumerate(zip(grid["one"], got)):
        rtol, atol = ((2e-4, 1e-5), (1e-3, 1e-4), (1e-2, 1e-4))[s]
        for k in want:
            assert np.isfinite(have[k])
            np.testing.assert_allclose(have[k], want[k], rtol=rtol, atol=atol, err_msg=f"step {s} {k}")


def test_grid_matches_jax_at_step0(grid):
    got, want = _losses(grid["ranks"][0], "tp")[0], grid["jax"][0]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=3e-4, err_msg=k)


# the Adam step that moves each model's elements first, as the JAX test
# bounds G by its own optimizer's rate
_LR = {"g": "g_lr", "d": "d_lr"}


@pytest.mark.parametrize("model", ["g", "d"])
def test_params_after_step0_within_a_flipped_adam_step(grid, model, tmp_path):
    case = grid["case"]
    lr = case["config"][_LR[model]]
    one = _one_rank(case, 1)
    state = _one_rank(case, 0)
    restore_train_state(str(grid["work"] / "tp_step0.ckpt"), state)
    flipped = total = 0
    for (name, a), b in zip(getattr(one, model).state_dict().items(),
                            getattr(state, model).state_dict().values()):
        if name.endswith(("running_mean", "running_var", "num_batches_tracked", ".u", ".sigma")):
            continue
        diff = (a - b).abs()
        assert diff.max().item() <= 2.1 * lr, (name, diff.max().item())
        flipped += int((diff > 0.5 * lr).sum())
        total += diff.numel()
    assert flipped / total < 0.005, (flipped, total)


def test_replicated_tensors_bit_equal_on_every_rank(grid):
    """Every parameter, buffer and Adam moment that no model shard cuts
    holds the same bits on all four ranks after the steps."""
    def local(rank, name):
        field, _, key = name.partition(".")
        if field.startswith("opt"):
            _, i, moment = key.split(".")
            return rank["local"][field]["state"][int(i)][moment]
        return rank["local"][field][key]

    ranks = grid["ranks"]
    placements = ranks[0]["tp"]["shardings"][-1]
    replicated = [name for name, (place, _) in placements.items() if not place]
    assert any(n.startswith("opt_info.") for n in replicated)
    for name in replicated:
        for r in ranks[1:]:
            assert torch.equal(local(r, name), local(ranks[0], name)), (r["mesh"], name)


def test_zero_on_the_grid_bit_equal_to_no_zero(grid):
    for r in grid["ranks"]:
        assert _losses(r, "zero") == _losses(r, "tp")
    tp, zero = (torch.load(grid["work"] / f"{t}.ckpt", weights_only=True) for t in ("tp", "zero"))
    assert tp.keys() == zero.keys()
    _assert_payload_equal(tp, zero)


def _assert_payload_equal(a, b, path=""):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_payload_equal(a[k], b[k], f"{path}.{k}")
    else:
        assert a == b, path


def test_steps_leave_every_placement_as_they_found_it(grid):
    """Before the first step Adam has no moments yet (torch makes them at
    the first step, placed as their parameters); every later step leaves
    each tensor's placement and local shape as it found them."""
    for r in grid["ranks"]:
        for tag in ("tp", "zero"):
            first, *after = r[tag]["shardings"]
            assert first.items() <= after[0].items()
            assert all(a == after[0] for a in after)
        tp, zero = r["tp"]["shardings"][-1], r["zero"]["shardings"][-1]
        # weights over `model` only; under ZeRO some moments over both axes
        assert {p for p, _ in tp.values()} == {(), (("model", 0),), (("model", 1),)}
        both = [k for k, (p, _) in zero.items() if {a for a, _ in p} == {"model", "data"}]
        assert len(both) == 2 * 2 * (3 + 3)  # two moments of G's 3 and D's 3, twice each


def test_grid_file_restores_at_one_rank_bit_equal(grid):
    """The (2, 2) file loads into a one-rank state; each rank's shards
    and moment shards are exactly its rows of the restored tensors."""
    case = grid["case"]
    path = grid["work"] / "tp.ckpt"
    state = _one_rank(case, 0)
    restore_train_state(str(path), state)
    restored = train_state_payload(state)
    _assert_payload_equal(restored, torch.load(path, weights_only=True))
    assert restored["step"] == STEPS
    for r in grid["ranks"]:
        places = r["tp"]["shardings"][-1]
        m = r["mesh"][3]
        for field in ("g", "d"):
            for key, local in r["local"][field].items():
                (place, shape) = places[f"{field}.{key}"]
                want = restored[field][key]
                if place:
                    dim = place[0][1]
                    k = want.shape[dim] // 2
                    want = want.narrow(dim, m * k, k)
                assert torch.equal(local, want), (field, key)
        for field in ("opt_g", "opt_d", "opt_info"):
            for i, st in r["local"][field]["state"].items():
                for key in ("exp_avg", "exp_avg_sq"):
                    place, _ = places[f"{field}.state.{i}.{key}"]
                    want = restored[field]["state"][i][key]
                    if place:
                        dim = place[0][1]
                        k = want.shape[dim] // 2
                        want = want.narrow(dim, m * k, k)
                    assert torch.equal(st[key], want), (field, i, key)
