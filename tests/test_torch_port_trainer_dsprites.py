"""Port dSprites trainers: the four CLIs end to end on the CPU, the
synthetic data and the epoch loop's batch sequence against the JAX
package.

* ``cli.pxy`` then ``cli.rp --encoder_pxy <its file>`` (and the colored
  pair), two steps each at batch 4: metrics finite, the reference-named
  model files, train states and grids written at step 0, the model files
  loading strictly into the reference layouts of
  ``tests/test_torch_import.py``, and the rp train state carrying the
  aligner from stage 1's file.
* ``cli.rp`` without an aligner file exits unless ``--allow_fresh_pxy``.
* ``--resume auto`` continues an rp run from its saved step to the
  planned total (``n_epochs * n_batches``).
* The synthetic stand-in equals the JAX package's bit for bit.
* The batch sequence of (N, 64, 64) uint8 data, (B, 64, 64, 1) float32
  ``x * 1 + 0``, equals the JAX engine's ``run_epochs`` exactly.
"""

import json
import math
import types

import numpy as np
import pytest
import torch

from eadgan_tpu.data import dsprites as jax_dsprites
from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.cli import pxy, pxy_color, rp, rp_color
from eadgan_tpu_torch.data import dsprites
from eadgan_tpu_torch.train.engine import run_epochs

from tests.test_torch_import import TorchSpritesG, TorchSpritesPxy
from tests.test_torch_port_jax_files import drop_big_files

RP_GRIDS = ["original", "trans"] + [f"varying_c{k}" for k in range(1, 8)]


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.fixture
def env(monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")  # 240 images


def _common(tmp_path, jsonl, *extra):
    return [
        "--batch_size", "4", "--max_steps", "2", "--sample_interval", "1",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), "--jsonl", str(tmp_path / jsonl), *extra,
    ]


def _records(path, keys):
    records = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["step"] for r in records] == [0, 1]
    for r in records:
        assert all(math.isfinite(r[k]) for k in keys), r
    return records


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_pxy_then_rp_on_cpu(tmp_path, env, colored):
    stage1, stage2 = (pxy_color, rp_color) if colored else (pxy, rp)
    stem = "encoder_pxy_color" if colored else "encoder_pxy"
    channels, out_dim, code_dim = (3, 6, 7) if colored else (1, 3, 4)

    stage1.main(_common(tmp_path / "s1", "pxy.jsonl"))
    s1 = tmp_path / "s1"
    _records(s1 / "pxy.jsonl", ["affine_loss"])
    aligner = torch.load(s1 / f"{stem}_0.pt", weights_only=True)
    TorchSpritesPxy(channels=channels, out_dim=out_dim).load_state_dict(aligner, strict=True)
    assert sorted(p.name for p in s1.glob("*.ckpt")) == [f"{stem}_train_state_0.ckpt"]
    assert not list(s1.glob(f"{stem}_1.pt"))
    for name in ("original", "align"):
        for step in (0, 1):
            assert (s1 / "images" / name / f"{step}.png").is_file(), (name, step)

    s2 = tmp_path / "s2"
    stage2.main(_common(s2, "rp.jsonl", "--encoder_pxy", str(s1 / f"{stem}_0.pt")))
    _records(s2 / "rp.jsonl", list(rp.METRIC_KEYS))
    gen = torch.load(s2 / "generator_0.pt", weights_only=True)
    TorchSpritesG(in_dim=3 + code_dim, channels=channels).load_state_dict(gen, strict=True)
    enc = torch.load(s2 / "encoder_0.pt", weights_only=True)
    assert {"conv_block.0.u", "fc1.0.sigma", "cat_layer.0.weight", "cont_layer.0.u"} <= set(enc)
    state = torch.load(s2 / "rp_train_state_0.ckpt", weights_only=True)
    assert set(state) == {"g", "d", "e", "pxy", "opt_d", "opt_info", "rng", "step"}
    assert state["step"] == 1
    for k, v in aligner.items():
        assert torch.equal(state["pxy"][k], v), k
    for name in RP_GRIDS:
        assert (s2 / "images" / name / "0.png").is_file(), name
        assert not (s2 / "images" / name / "1.png").exists()
    assert not list(s2.glob("*.tmp.*"))


def test_rp_needs_an_aligner(tmp_path, env, capsys):
    with pytest.raises(SystemExit, match="missing frozen aligner"):
        rp.main(_common(tmp_path, "rp.jsonl"))
    assert not (tmp_path / "rp.jsonl").exists()
    rp.main(_common(tmp_path, "rp.jsonl", "--allow_fresh_pxy", "--compute", "bf16"))
    _records(tmp_path / "rp.jsonl", list(rp.METRIC_KEYS))


def test_rp_resume_auto_continues_to_planned_total(tmp_path, env):
    """240 images at batch 60: 4 batches an epoch, one epoch.  The first
    run stops after 2 steps with the state saved at step 0 (step 1 next);
    the resumed run takes steps 1-3 and ends at the planned total."""
    common = [
        "--batch_size", "60", "--n_epochs", "1", "--sample_interval", "1000",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path), "--allow_fresh_pxy", "--keep_states", "2",
    ]
    rp.main(common + ["--max_steps", "2", "--jsonl", str(tmp_path / "a.jsonl")])
    rp.main(common + ["--resume", "auto", "--jsonl", str(tmp_path / "b.jsonl")])
    steps = [json.loads(line)["step"] for line in (tmp_path / "b.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]


@pytest.mark.parametrize("n_pos", [None, "3"])
def test_synthetic_dsprites_equals_jax(monkeypatch, n_pos):
    if n_pos is None:
        monkeypatch.delenv("EADGAN_SYNTH_POS", raising=False)
    else:
        monkeypatch.setenv("EADGAN_SYNTH_POS", n_pos)
    ours = dsprites.load_dsprites("/nonexistent")
    theirs = jax_dsprites.load_dsprites("/nonexistent")
    assert ours.synthetic and theirs.synthetic
    assert ours.imgs.dtype == np.uint8 and ours.imgs.ndim == 3
    for field in ("imgs", "latents_values", "latents_sizes"):
        a, b = getattr(ours, field), getattr(theirs, field)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), field
    with pytest.raises(FileNotFoundError):
        dsprites.load_dsprites("/nonexistent", allow_synthetic=False)


@pytest.mark.parametrize("max_steps,start", [(0, 0), (5, 0), (4, 3)])
def test_batch_sequence_of_3d_data_matches_jax_engine(max_steps, start):
    data = np.random.default_rng(0).integers(0, 2, (10, 8, 6), dtype=np.uint8)
    common = dict(n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps)

    jax_batches = []

    def jax_step(state, batch):
        jax_batches.append(np.array(batch))
        return state, {}

    jax_run_epochs(
        labels=None, state=types.SimpleNamespace(step=np.int32(start)),
        step_fn=jax_step, on_batch=lambda *a: None, **common,
    )

    port_batches = []

    def port_step(state, batch):
        assert batch.dtype == torch.float32 and batch.is_contiguous()
        port_batches.append(batch.numpy().copy())
        return state, {}

    run_epochs(
        state=types.SimpleNamespace(step=start), step_fn=port_step,
        on_batch=lambda *a: None, device="cpu", **common,
    )
    assert len(port_batches) == len(jax_batches) > 0
    for a, b in zip(port_batches, jax_batches):
        assert a.shape == b.shape == (3, 8, 6, 1)
        np.testing.assert_array_equal(a, b)


# the run flags ported since these tests were written, with valid values
PORTED_FLAGS = {"--profile_dir": ["trace"], "--preempt_save": ["off"], "--watchdog": ["1"],
                "--no_download": [], "--data_parallel": [], "--zero_opt": []}


@pytest.mark.parametrize("cli", [pxy, pxy_color, rp, rp_color], ids=lambda m: m.__name__.rsplit(".", 1)[-1])
@pytest.mark.parametrize("flag", ["--profile_dir", "--data_parallel", "--zero_opt", "--preempt_save", "--watchdog"])
def test_cli_rejects_later_slice_flags(cli, flag, monkeypatch):
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


@pytest.mark.parametrize("lr", [None, 3e-4], ids=["default_lr", "lr_3e-4"])
@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_cli_configs_match_jax(colored, lr):
    """The port's CLIs build the JAX CLIs' configs: defaults that follow
    ``colored`` (code_dim, channels, lr) and D's rate (gray 2e-4, colored
    ``--lr``)."""
    from eadgan_tpu.cli import pxy as jax_pxy
    from eadgan_tpu.cli import rp as jax_rp
    from eadgan_tpu.train.config import SpritesGanConfig as JaxGanConfig
    from eadgan_tpu_torch.train.config import PxyConfig, SpritesGanConfig

    argv = [] if lr is None else ["--lr", str(lr)]
    for ours, theirs, keys in ((rp, jax_rp, ("lr", "code_dim", "channels")), (pxy, jax_pxy, ("lr", "code_dim"))):
        mine, ref = ours.build_parser(colored).parse_args(argv), theirs.build_parser(colored).parse_args(argv)
        assert {k: getattr(mine, k) for k in keys} == {k: getattr(ref, k) for k in keys}
    opt = jax_rp.build_parser(colored).parse_args(argv)
    want = JaxGanConfig(lr=opt.lr, d_lr=opt.lr if colored else 2e-4, code_dim=opt.code_dim,
                        channels=opt.channels, colored=colored)
    got = SpritesGanConfig.for_dataset(colored, **({} if lr is None else {"lr": lr}))
    assert {f: getattr(got, f) for f in ("lr", "d_lr", "code_dim", "channels", "colored")} == {
        f: getattr(want, f) for f in ("lr", "d_lr", "code_dim", "channels", "colored")}
    assert PxyConfig.for_dataset(colored).code_dim == jax_pxy.build_parser(colored).parse_args([]).code_dim
