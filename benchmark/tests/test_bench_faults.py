"""The comparison catches what it is there to catch.  A whole run of a
cell on the CPU at test sizes (the look for a card skipped) with the
timed path broken underneath reads ``correct`` false, once for each
fault the cell can have; a sound run reads true; the control, the
reference computed one precision lower, fails the cell's limits; and the
replayed steps' gradients worked out from Adam's first moments are the
gradients an Adam was given."""

import pytest
import torch

from conftest import run_cell

from harness import compare, faults, spec


def test_sound_runs_are_correct(small_root):
    line = run_cell(small_root, "dsprites_rp.train.b128")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and "setup_s" in line["metrics"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_timed_path_is_not_correct(small_root, fault):
    line = run_cell(small_root, "dsprites_rp.train.b128", fault=faults.TRAIN[fault])
    assert not line["correct"], line["checks"]


def test_the_training_control_fails_the_limits(small_root):
    import run

    cell = spec.cell("dsprites_rp.train.b128", small_root)
    ctx = run.Context(cell=cell, seed=77, seconds=1.0, trace=False, device=torch.device("cpu"),
                      bench_dir=small_root / "benchmark", t_start=0.0)
    f = spec.driver("train", ctx.bench_dir).first_steps(ctx)
    args = (f.ref, cell.config, f.weights)
    expect = compare.reference_first_steps(*args, f.batches, f.rng_seed, "cpu")
    lower = compare.reference_first_steps(*args, f.batches, f.rng_seed, "cpu", quant="fp8", keep_states=True)
    followed = compare.followed_grads(*args, lower["states"], f.batches, f.rng_seed, "cpu")
    limits = spec.limits(cell.name, ctx.bench_dir)
    gaps = compare.train_gaps(lower, expect, followed)
    assert any(gaps[k] > limits[k] for k in limits), gaps


def test_the_followed_reference_retraces_its_own_run(small_root):
    """Taken from a run's own states, the reference gives that run's later
    gradients again: the state it loads (models, buffers, Adam) is whole."""
    cell = spec.cell("dsprites_rp.train.b128", small_root)
    cfg = cell.config
    ref = spec.reference(cell.config_name, small_root / "benchmark")
    from harness import datasets, schedule, weights

    w = weights.make(ref.init_spec(cfg), seed=5, device="cpu")
    data = datasets.make(cfg["data"], 1, "cpu", cfg["model"]["img_size"])
    batches = [(data[rows], mask) for rows, mask in schedule.first_batches(data.shape[0], 4, 3, 9, False)]
    own = compare.reference_first_steps(ref, cfg, w, batches, 13, "cpu", keep_states=True)
    followed = compare.followed_grads(ref, cfg, w, own["states"], batches, 13, "cpu")
    assert compare.train_gaps(own, own, followed)["replay_grad_gap"] < 1e-5


def test_step_gradients_from_adam_moments():
    torch.manual_seed(3)
    b1, steps = 0.5, 3
    w = torch.nn.Parameter(torch.zeros(6, 5))
    opt = torch.optim.Adam([w], lr=1e-3, betas=(b1, 0.999))
    grads = [torch.randn(6, 5) for _ in range(steps)]
    states = []
    for g in grads:
        w.grad = g.clone()
        opt.step()
        states.append(compare.host_state({"m": torch.nn.ParameterDict({"w": w})}, {"opt": opt}))
    got = [s["opt"]["m.w"] for s in compare.step_grads(states, b1)]
    assert got == pytest.approx([float(g.norm()) for g in grads], rel=1e-5)
