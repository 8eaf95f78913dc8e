"""Port CelebA trainer: the CLI end to end on the CPU, and the epoch
loop's batch sequence against ``eadgan_tpu.train.engine.run_epochs``.

The batch sequence (permutation, per-batch flip mask, normalization)
must equal the JAX engine's to 1e-6: both compute ``x * (1/127.5) - 1``
in float32 from the same uint8 pixels, and the JAX engine's native
batcher may contract that into one fused multiply-add.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.cli import celeba as cli
from eadgan_tpu_torch.train.engine import run_epochs
from tests.test_torch_port_jax_files import drop_big_files


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


def test_cli_trains_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_N", "16")
    jsonl = tmp_path / "metrics.jsonl"
    cli.main([
        "--batch_size", "4", "--max_steps", "2", "--sample_interval", "1",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), "--jsonl", str(jsonl),
    ])
    records = [json.loads(line) for line in jsonl.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    for r in records:
        assert math.isfinite(r["d_loss"]) and math.isfinite(r["g_loss"])

    ckpt = torch.load(tmp_path / "checkpoint_0.tar", weights_only=True)
    assert set(ckpt) == {
        "discriminator_state_dict", "generator_state_dict", "epoch", "batches_done"
    }
    assert ckpt["batches_done"] == 0 and ckpt["epoch"] == 0
    assert "conv_blocks.0.weight" in ckpt["generator_state_dict"]
    assert "main.0.u" in ckpt["discriminator_state_dict"]
    assert not list(tmp_path.glob("*.tmp.*"))

    grids = ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 9)]
    for name in grids:
        for step in (0, 1):
            assert (tmp_path / "images" / name / f"{step}.png").is_file(), (name, step)


# the run flags ported since these tests were written, with valid values
PORTED_FLAGS = {"--profile_dir": ["trace"], "--preempt_save": ["off"], "--watchdog": ["1"],
                "--no_download": [], "--data_parallel": [], "--zero_opt": []}


@pytest.mark.parametrize("flag", ["--profile_dir", "--zero_opt", "--preempt_save", "--watchdog"])
def test_cli_rejects_later_slice_flags(flag, capsys, monkeypatch):
    """The run flags of the later slices of the port (``--profile_dir``,
    ``--preempt_save``, ``--watchdog``, ``--no_download``, and scale-out's
    ``--data_parallel`` and ``--zero_opt``) are all accepted by argparse
    now: with a rank environment that names a gang without its
    coordinator, the CLI stops at its refusal of it, before the card."""
    monkeypatch.setenv("EADGAN_MP_NUM_PROCESSES", "2")
    with pytest.raises(SystemExit) as e:
        cli.main([flag, *PORTED_FLAGS.get(flag, ["1"])])
    if flag in PORTED_FLAGS:
        assert "multi-process" in str(e.value.code)
    else:
        assert e.value.code == 2


@pytest.mark.parametrize("max_steps,start", [(0, 0), (5, 0), (4, 3)])
def test_batch_sequence_matches_jax_engine(rng, max_steps, start):
    data = rng.integers(0, 256, (10, 8, 6, 3), dtype=np.uint8)
    common = dict(
        n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps,
        scale=1.0 / 127.5, shift=-1.0, random_flip=True,
    )

    jax_batches = []

    def jax_step(state, batch):
        jax_batches.append(np.array(batch))
        return state, {}

    jax_run_epochs(
        labels=None, state=types.SimpleNamespace(step=np.int32(start)),
        step_fn=jax_step, on_batch=lambda *a: None, **common,
    )

    port_batches, seen = [], []

    def port_step(state, batch):
        assert batch.dtype == torch.float32 and batch.is_contiguous()
        port_batches.append(batch.numpy().copy())
        return state, {}

    run_epochs(
        state=types.SimpleNamespace(step=start), step_fn=port_step,
        on_batch=lambda step, *a: seen.append(step), device="cpu", **common,
    )
    assert len(port_batches) == len(jax_batches) > 0
    assert seen == list(range(start, start + len(port_batches)))
    for a, b in zip(port_batches, jax_batches):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
