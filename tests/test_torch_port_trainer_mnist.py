"""Port MNIST pipeline: its three CLIs end to end on the CPU, the data and
the epoch loop's batches against the JAX package.

* ``cli.approximate_rpqmnxy`` then ``cli.mnist`` on its file then
  ``cli.generate_image`` on the generator file, at batch 8 on the
  synthetic stand-in: metrics finite, the model files and train state
  written at step 0 and loading strictly into the reference layouts of
  ``tests/test_torch_import.py``, the training grids at each sample
  step and the inference grids varying_c1..7.
* ``--resume auto`` continues from the saved step to the planned total
  (``n_epochs * n_batches``).
* ``--chain 4`` writes the JSONL steps of ``--chain 1`` and its losses
  within the tolerance of ``test_torch_port_chain.py`` (rtol 2e-3,
  atol 1e-5: both run the step eagerly on the CPU, on bit-equal
  batches).
* ``cli.mnist`` exits without an approximator file unless
  ``--allow_fresh_approximator``; the later-slice flags are refused.
* The synthetic MNIST, and a small idx archive written here (plain and
  gzipped), equal the JAX package's ``load_mnist`` bit for bit.
* A float32 dataset gives the per-step engine, the chained engine's
  gather and the JAX engine the same batches bit for bit.
* The configurations equal the JAX package's.
"""

import dataclasses
import gzip
import json
import math
import struct
import types

import numpy as np
import pytest
import torch

from eadgan_tpu.data import mnist as jax_mnist
from eadgan_tpu.train import config as jax_config
from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.cli import approximate_rpqmnxy, generate_image, mnist
from eadgan_tpu_torch.data import mnist as port_mnist
from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train import config as port_config
from eadgan_tpu_torch.train.chain import make_chained_step, normalize_prepare
from eadgan_tpu_torch.train.engine import epoch_batches, run_epochs
from eadgan_tpu_torch.train.gan_mnist import METRIC_KEYS
from eadgan_tpu_torch.utils.profiler import build_step

from tests.test_torch_import import TorchApprox, TorchMnistG
from tests.test_torch_port_jax_files import drop_big_files

TRAIN_GRIDS = ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 8)]


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_N", "64")


def _mnist_args(tmp_path, *extra):
    return [
        "--batch_size", "8", "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), *extra,
    ]


def _records(path):
    records = [json.loads(line) for line in path.read_text().splitlines()]
    for r in records:
        assert all(math.isfinite(r[k]) for k in METRIC_KEYS), r
    return records


def test_approximator_then_mnist_then_generate_image(tmp_path, env):
    approximate_rpqmnxy.main(["--iterations", "3", "--batch_size", "16", "--ckpt_dir",
                              str(tmp_path), "--jsonl", str(tmp_path / "approx.jsonl")])
    approx_file = tmp_path / "rpqmnxy_approximator.pt"
    TorchApprox().load_state_dict(torch.load(approx_file, weights_only=True), strict=True)
    steps = [json.loads(line)["step"] for line in (tmp_path / "approx.jsonl").read_text().splitlines()]
    assert steps == [0, 1, 2]

    mnist.main(_mnist_args(tmp_path, "--max_steps", "3", "--sample_interval", "2",
                           "--approximator", str(approx_file), "--jsonl", str(tmp_path / "m.jsonl")))
    assert [r["step"] for r in _records(tmp_path / "m.jsonl")] == [0, 1, 2]
    for name in TRAIN_GRIDS:
        for step in (0, 2):
            assert (tmp_path / "images" / name / f"{step}.png").is_file(), (name, step)
        assert not (tmp_path / "images" / name / "1.png").exists()
    gen = torch.load(tmp_path / "generator_0.pt", weights_only=True)
    TorchMnistG().load_state_dict(gen, strict=True)
    enc = torch.load(tmp_path / "encoder_0.pt", weights_only=True)
    assert {"conv_blocks.0.u", "conv_blocks.4.running_var", "aux_layer.0.sigma",
            "latent_layer.0.weight", "noise_layer.0.u"} <= set(enc)
    assert ckpt.saved_steps(str(tmp_path), mnist.STATE_STEM) == [0]
    state = torch.load(tmp_path / "mnist_train_state_0.ckpt", weights_only=True)
    assert set(state) == {"g", "d", "e", "approx", "opt_g", "opt_d", "opt_info", "rng", "step"}
    assert state["step"] == 1
    for k, v in torch.load(approx_file, weights_only=True).items():
        assert torch.equal(state["approx"][k], v), k
    assert not list(tmp_path.glob("*.tmp.*"))

    generate_image.main(["--checkpoint", str(tmp_path / "generator_0.pt"), "--out_dir",
                         str(tmp_path / "test"), "--batches_done", "5"])
    for k in range(1, 8):
        assert (tmp_path / "test" / f"varying_c{k}" / "5.png").is_file(), k
    assert not (tmp_path / "test" / "varying_c8").exists()


def test_mnist_needs_an_approximator(tmp_path, env):
    with pytest.raises(SystemExit, match="missing .*rpqmnxy_approximator.pt"):
        mnist.main(_mnist_args(tmp_path, "--max_steps", "1", "--jsonl", str(tmp_path / "m.jsonl")))
    assert not (tmp_path / "m.jsonl").exists()
    mnist.main(_mnist_args(tmp_path, "--max_steps", "1", "--sample_interval", "1000",
                           "--allow_fresh_approximator", "--compute", "bf16",
                           "--jsonl", str(tmp_path / "m.jsonl")))
    assert [r["step"] for r in _records(tmp_path / "m.jsonl")] == [0]


def test_mnist_resume_auto_continues_to_planned_total(tmp_path, env):
    """64 images at batch 16: 4 batches an epoch, one epoch.  The first run
    stops after 2 steps with the state saved at step 0 (step 1 next); the
    resumed run takes steps 1-3 and ends at the planned total."""
    common = [
        "--batch_size", "16", "--n_epochs", "1", "--sample_interval", "1000",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), "--allow_fresh_approximator", "--keep_states", "2",
    ]
    mnist.main(common + ["--max_steps", "2", "--jsonl", str(tmp_path / "a.jsonl")])
    mnist.main(common + ["--resume", "auto", "--jsonl", str(tmp_path / "b.jsonl")])
    assert [r["step"] for r in _records(tmp_path / "b.jsonl")] == [1, 2, 3]


def test_mnist_chain_4_writes_the_jsonl_of_chain_1(tmp_path, env):
    records = {}
    for chain in (1, 4):
        out = tmp_path / f"chain{chain}"
        mnist.main([
            "--batch_size", "4", "--max_steps", "9", "--sample_interval", "3", "--chain", str(chain),
            "--allow_fresh_approximator", "--data_dir", str(tmp_path),
            "--out_dir", str(out / "images"), "--ckpt_dir", str(out), "--jsonl", str(out / "m.jsonl"),
        ])
        records[chain] = _records(out / "m.jsonl")
        for name in ("static", "scaled", "varying_c7"):
            assert sorted(p.name for p in (out / "images" / name).iterdir()) == [
                "0.png", "3.png", "6.png"]
        assert ckpt.saved_steps(str(out), mnist.STATE_STEM) == [0]
    assert [r["step"] for r in records[1]] == [r["step"] for r in records[4]] == list(range(9))
    for a, b in zip(records[1], records[4]):
        for k in METRIC_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=1e-5, err_msg=f"{a['step']} {k}")


# the run flags ported since these tests were written, with valid values
PORTED_FLAGS = {"--profile_dir": ["trace"], "--preempt_save": ["off"], "--watchdog": ["1"],
                "--no_download": [], "--data_parallel": [], "--zero_opt": []}


@pytest.mark.parametrize("flag", ["--profile_dir", "--data_parallel", "--zero_opt", "--preempt_save",
                                  "--watchdog", "--no_download"])
def test_mnist_rejects_later_slice_flags(flag, monkeypatch):
    """The run flags of the later slices of the port (``--profile_dir``,
    ``--preempt_save``, ``--watchdog``, ``--no_download``, and scale-out's
    ``--data_parallel`` and ``--zero_opt``) are all accepted by argparse
    now: with a rank environment that names a gang without its
    coordinator, the CLI stops at its refusal of it, before the card."""
    monkeypatch.setenv("EADGAN_MP_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit) as e:
        mnist.main([flag, *PORTED_FLAGS.get(flag, ["1"])])
    if flag in PORTED_FLAGS:
        assert "multi-process" in str(e.value.code)
    else:
        assert e.value.code == 2


def _write_idx(directory, imgs, labels, gz):
    directory.mkdir(parents=True, exist_ok=True)
    opener, suffix = (gzip.open, ".gz") if gz else (open, "")
    with opener(directory / f"train-images-idx3-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">IIII", 2051, *imgs.shape) + imgs.tobytes())
    with opener(directory / f"train-labels-idx1-ubyte{suffix}", "wb") as f:
        f.write(struct.pack(">II", 2049, len(labels)) + labels.tobytes())


@pytest.mark.parametrize("source", ["synthetic", "idx", "idx_gz"])
def test_load_mnist_equals_jax(tmp_path, monkeypatch, source):
    monkeypatch.setenv("EADGAN_SYNTH_N", "40")
    if source != "synthetic":
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (12, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, 12).astype(np.uint8)
        _write_idx(tmp_path, imgs, labels, gz=source == "idx_gz")
    ours = port_mnist.load_mnist(str(tmp_path))
    theirs = jax_mnist.load_mnist(str(tmp_path), download=False)
    assert port_mnist.mnist_archive_present(str(tmp_path)) == (source != "synthetic")
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert ours[0].shape == ((40 if source == "synthetic" else 12), 32, 32, 1)
    assert ours[0].flags.c_contiguous and -1.0 <= ours[0].min() and ours[0].max() <= 1.0
    if source == "synthetic":
        with pytest.raises(FileNotFoundError):
            port_mnist.load_mnist(str(tmp_path), allow_synthetic=False)


@pytest.mark.parametrize("max_steps,start", [(0, 0), (4, 3)])
def test_float32_batches_match_jax_engine_and_chained_gather(max_steps, start):
    """MNIST's float32 images go through both port engines and the JAX
    engine unchanged (scale 1, shift 0), bit for bit."""
    data, labels = port_mnist.load_mnist("/nonexistent")
    data = data[:10]
    common = dict(n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps)

    jax_batches = []

    def jax_step(state, batch, batch_labels):
        jax_batches.append(np.array(batch))
        return state, {}

    jax_run_epochs(labels=labels[:10], state=types.SimpleNamespace(step=np.int32(start)),
                   step_fn=jax_step, on_batch=lambda *a: None, **common)

    port_batches = []

    def port_step(state, batch):
        assert batch.dtype == torch.float32 and batch.is_contiguous()
        port_batches.append(batch.numpy().copy())
        return state, {"x": batch.sum()}

    run_epochs(state=types.SimpleNamespace(step=start), step_fn=port_step,
               on_batch=lambda *a: None, device="cpu", **common)
    assert len(port_batches) == len(jax_batches) > 0
    for a, b in zip(port_batches, jax_batches):
        assert a.shape == b.shape == (3, 32, 32, 1)
        np.testing.assert_array_equal(a, b)

    port_batches.clear()
    run_epochs(state=types.SimpleNamespace(step=start), step_fn=port_step,
               on_batch=lambda *a: None, device="cpu", chain=4, **common)
    assert len(port_batches) == len(jax_batches)
    for a, b in zip(port_batches, jax_batches):
        np.testing.assert_array_equal(a, b)

    prep = normalize_prepare(1.0, 0.0)
    rows = torch.arange(3, dtype=torch.int32)
    (gathered,) = prep((torch.from_numpy(data),), rows)
    _, host = next(epoch_batches(data, 3, 1, seed=7))
    assert np.array_equal(gathered.numpy(), data[:3])
    assert np.array_equal(host, jax_batches[0])


def test_approximator_runs_chained_without_a_dataset():
    """The approximator's step through the chained engine on the CPU, with
    a window that carries only its length (``utils/profiler.py``)."""
    state, step, data, prep = build_step("approximator", batch_size=4, device="cpu")
    assert data is None and prep is None
    chained = make_chained_step(step, lambda consts, _row: ())
    state, packed = chained(state, (), torch.zeros((3, 1), dtype=torch.int32))
    assert state.step == 3 and packed.shape == (3, 1)
    assert bool(torch.isfinite(packed).all())


def test_configs_match_jax():
    for name in ("MnistConfig", "ApproximatorConfig"):
        ours, theirs = getattr(port_config, name)(), getattr(jax_config, name)()
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), name
    assert port_config.MnistConfig(lr=3e-4).d_lr == jax_config.MnistConfig(lr=3e-4).d_lr == 6e-4
    with pytest.raises(ValueError):
        port_config.MnistConfig(code_dim=5)
