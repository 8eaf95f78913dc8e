"""Port chained engine (``eadgan_tpu_torch.train.chain`` and the chained
path of ``train/engine.py``) against the JAX package, on the CPU.

* ``plan_windows`` gives the JAX package's windows over a seeded sweep.
* ``normalize_prepare`` equals JAX ``normalize_prepare`` and the
  per-step engine's host batches bit for bit: both compute one float32
  multiply then one add, and a flip permutes pixels.
* The chained engine, driving a probe body whose metrics are checksums of
  its batch, gives every step the JAX chained engine's rows and flips,
  fresh and resumed mid-epoch; a resumed run ends at the planned total
  (where the JAX engine runs on, ROADMAP §3).  Checksum tolerance 1e-5
  relative and 1e-4 absolute (432 values in [-1, 1], summed in float32
  in other orders, cancel to sums near 0); a wrong row or flip moves a
  checksum by ~1.
* The chained engine against the per-step engine on the pxy step: the
  same event steps, event batches and losses, within the tolerance of
  ``tests/test_chain.py::test_run_epochs_chained_matches_per_step_engine``
  (rtol 2e-3, atol 1e-5).  On the CPU both run the step eagerly on
  bit-equal batches; they still differ by an ulp where the CPU's matrix
  library takes another path for a differently aligned buffer, and
  Adam's early steps magnify that.
* ``LazyLastMetrics`` and ``LazyHostBatch`` hold the JAX classes'
  contracts; a train state written by a card optimizer (capturable Adam)
  loads into a CPU one and keeps the CPU's setting.
* The rp CLI on the CPU at ``--chain 4`` writes the JSONL steps of
  ``--chain 1`` and its losses within the same tolerance.
"""

import json
import types
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.train.chain import normalize_prepare as jax_normalize_prepare
from eadgan_tpu.train.chain import plan_windows as jax_plan_windows
from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.cli import rp
from eadgan_tpu_torch.cli.common import add_run_args
from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train.chain import (
    LazyHostBatch,
    LazyLastMetrics,
    gather_prepare,
    make_chained_step,
    normalize_prepare,
    plan_windows,
)
from eadgan_tpu_torch.train.config import PxyConfig
from eadgan_tpu_torch.train.engine import epoch_batches, run_epochs
from eadgan_tpu_torch.train.pretrain import init_pxy_state, make_pxy_step
from eadgan_tpu_torch.train.state import adam
from eadgan_tpu_torch.utils.profiler import PIPELINES, build_step, first_batch
from tests.test_torch_port_jax_files import drop_big_files


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.mark.parametrize("seed", range(4))
def test_plan_windows_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(100):
        start = int(rng.integers(0, 200))
        count = int(rng.integers(0, 120))
        chain = int(rng.choice([1, 2, 3, 5, 8, 32]))
        periods = tuple(int(p) for p in rng.choice([0, 1, 2, 4, 7, 10, 64], rng.integers(0, 3)))
        stop = None if rng.random() < 0.3 else int(start + rng.integers(0, 150))
        args = (start, count, chain, periods, stop)
        assert list(plan_windows(*args)) == list(jax_plan_windows(*args)), args
    with pytest.raises(ValueError):
        list(plan_windows(0, 4, 0))


@pytest.mark.parametrize("scale,shift", [(1.0 / 127.5, -1.0), (1.0, 0.0)], ids=["celeba", "sprites"])
@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
@pytest.mark.parametrize("shape", [(40, 8, 6), (40, 8, 6, 3)], ids=["3d", "4d"])
def test_prepare_equals_jax_and_host_batches(shape, flip, scale, shift):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, shape, np.uint8)
    idx = rng.permutation(40)[:10].astype(np.int32)
    mask = rng.random(10) < 0.5
    add_channel = len(shape) == 3
    extra = (mask,) if flip else ()

    (ours,) = normalize_prepare(scale, shift, flip, add_channel)(
        (torch.from_numpy(data),), torch.from_numpy(idx), *map(torch.from_numpy, extra)
    )
    (theirs,) = jax_normalize_prepare(scale, shift, flip, add_channel, gather=True)(
        (jnp.asarray(data),), jnp.asarray(idx), *map(jnp.asarray, extra)
    )
    assert ours.dtype == torch.float32 and ours.is_contiguous()
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))

    # against the per-step engine's host batches: its first epoch's rows
    # and flips, from the same generators
    host_rng = np.random.default_rng(3)
    flip_rng = np.random.default_rng([3, 0x464C4950])
    perm = host_rng.permutation(40)
    prep = normalize_prepare(scale, shift, flip, add_channel)
    for i, (_, host) in enumerate(epoch_batches(data, 10, 1, seed=3, scale=scale, shift=shift,
                                                random_flip=flip)):
        rows = [torch.from_numpy(perm[i * 10 : (i + 1) * 10].astype(np.int32))]
        if flip:
            rows.append(torch.from_numpy(flip_rng.random(10) < 0.5))
        (dev,) = prep((torch.from_numpy(data),), *rows)
        np.testing.assert_array_equal(dev.numpy(), host)
        # the same layout too: cuDNN picks its algorithm by the strides
        assert torch.from_numpy(host).stride() == dev.stride()


def test_gather_prepare():
    rng = np.random.default_rng(5)
    imgs = rng.random((30, 4, 4, 1)).astype(np.float32)
    labels = rng.integers(0, 10, 30)
    idx = torch.tensor([3, 17, 29, 0], dtype=torch.int32)
    img_b, lab_b = gather_prepare()((torch.from_numpy(imgs), torch.from_numpy(labels)), idx)
    np.testing.assert_array_equal(img_b.numpy(), imgs[idx.numpy()])
    np.testing.assert_array_equal(lab_b.numpy(), labels[idx.numpy()])


def _weights(img):
    """Per-pixel weights that tell rows, their order and flips apart."""
    b, h, w = img.shape[:3]
    return np.arange(1, b * h * w + 1, dtype=np.float32).reshape(b, h, w, 1) / (b * h * w)


class _Log:
    """A logger that keeps every record."""

    def __init__(self):
        self.records = {}

    def log(self, step, metrics, **kw):
        self.records[int(step)] = {k: float(v) for k, v in metrics.items()}

    def close(self):
        pass


def _port_probe(state, img):
    state.step += 1
    return state, {"sum": img.sum(), "wsum": (img * torch.from_numpy(_weights(img))).sum()}


class _JaxState(typing.NamedTuple):
    step: object


def _jax_probe(state, img):
    return _JaxState(state.step + 1), {"sum": jnp.sum(img), "wsum": jnp.sum(img * _weights(img))}


@pytest.mark.parametrize("start,max_steps", [(0, 0), (0, 13), (6, 0), (9, 7)])
def test_chained_engine_rows_match_jax(start, max_steps):
    """10 batches of 3 an epoch, 3 epochs, chain 5, events every 4 steps."""
    data = np.random.default_rng(0).integers(0, 256, (31, 8, 6, 3), np.uint8)
    common = dict(n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps,
                  scale=1.0 / 127.5, shift=-1.0, random_flip=True, chain=5, chain_periods=(4,))
    ours, ours_events = _Log(), []
    state = run_epochs(
        state=types.SimpleNamespace(step=start), step_fn=_port_probe, device="cpu", logger=ours,
        on_batch=lambda i, st, m, b: ours_events.append((i, st.step, float(m["sum"]))), **common,
    )
    planned = min(30, start + max_steps) if max_steps else 30
    assert state.step == planned
    assert sorted(ours.records) == list(range(start, planned))
    assert [e[0] for e in ours_events] == [i for i in range(start, planned) if i % 4 == 0]
    assert all(after == i + 1 for i, after, _ in ours_events)
    assert all(v == ours.records[i]["sum"] for i, _, v in ours_events)

    theirs = _Log()
    jax_run_epochs(labels=None, state=_JaxState(jnp.int32(start)), step_fn=None,
                   on_batch=lambda *a: None, step_body=_jax_probe, logger=theirs, **common)
    # fresh: every step; resumed: the resumed epoch (the JAX engine plans a
    # whole epoch from the resume point, and runs past the planned total)
    shared = range(start, min(planned, (start // 10 + 1) * 10) if start else planned)
    assert len(shared) > 0
    for i in shared:
        for k in ("sum", "wsum"):
            np.testing.assert_allclose(ours.records[i][k], theirs.records[i][k], rtol=1e-5,
                                       atol=1e-4, err_msg=f"step {i} {k}")
    if start and not max_steps:
        assert max(theirs.records) > planned  # the JAX overrun the port leaves out


def _pxy_run(chain, data, events):
    config = PxyConfig(batch_size=4)
    state = init_pxy_state(config, device="cpu", seed=7)
    log = _Log()

    def on_batch(i, st, metrics, batch):
        if i % 4 == 0:
            events.append((i, batch[0][:2].numpy().copy(), float(metrics["affine_loss"])))

    final = run_epochs(n_epochs=50, data=data, batch_size=4, state=state, step_fn=make_pxy_step(config),
                       on_batch=on_batch, device="cpu", seed=0, max_steps=10, logger=log,
                       metric_keys=["affine_loss"], chain=chain, chain_periods=(4,))
    return final, log.records


def test_chained_engine_matches_per_step_engine_on_pxy():
    data = np.random.default_rng(3).integers(0, 2, (24, 64, 64), np.uint8)
    ev1, ev5 = [], []
    s1, log1 = _pxy_run(1, data, ev1)
    s5, log5 = _pxy_run(5, data, ev5)
    assert [e[0] for e in ev1] == [e[0] for e in ev5] == [0, 4, 8]
    for (_, b1, l1), (_, b5, l5) in zip(ev1, ev5):
        np.testing.assert_allclose(b1, b5, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(l1, l5, rtol=2e-3, atol=1e-5)
    assert sorted(log1) == sorted(log5) == list(range(10))
    for i in log1:
        np.testing.assert_allclose(log1[i]["affine_loss"], log5[i]["affine_loss"], rtol=2e-3, atol=1e-5)
    assert s1.step == s5.step == 10
    for a, b in zip(s1.model.state_dict().values(), s5.model.state_dict().values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-2, atol=1e-3)
    assert torch.equal(s1.rng.get_state(), s5.rng.get_state())


def test_chained_step_packs_metrics():
    def body(state, x):
        state.step += 1
        return state, {"b": x.sum(), "a": x.mean()}

    state = types.SimpleNamespace(step=0)
    window = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    auto = make_chained_step(body)
    assert auto.resolved_pack_keys == []
    state, packed = auto(state, (), window)
    assert auto.resolved_pack_keys == ["a", "b"] and state.step == 3
    assert packed.shape == (3, 2) and packed.dtype == torch.float32
    np.testing.assert_allclose(packed[:, 1].numpy(), window.sum(dim=(1, 2)).numpy())
    fixed = make_chained_step(body, pack_keys=("b",))
    _, packed = fixed(state, (), window)
    assert fixed.resolved_pack_keys == ["b"] and packed.shape == (3, 1)


def test_lazy_host_batch_materializes_once():
    calls = []

    def fn():
        calls.append(1)
        return torch.arange(12).reshape(3, 4)

    lazy = LazyHostBatch(fn)
    assert calls == []
    assert lazy[1:].shape == (2, 4)
    assert lazy.shape == (3, 4) and lazy.dtype == torch.int64
    np.testing.assert_array_equal(np.asarray(lazy), np.arange(12).reshape(3, 4))
    assert np.asarray(lazy, dtype=np.float32).dtype == np.float32
    assert len(calls) == 1


def test_lazy_last_metrics_fetches_once_and_maps_keys():
    packed = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    lazy = LazyLastMetrics(("a", "b", "c"), packed)
    assert lazy._row is None  # nothing fetched until a key is read
    assert float(lazy["b"]) == 10.0
    assert float(lazy["a"]) == 9.0
    assert list(lazy.keys()) == ["a", "b", "c"] and list(lazy) == ["a", "b", "c"]
    assert len(lazy) == 3
    assert dict(lazy.items()) == {"a": 9.0, "b": 10.0, "c": 11.0}
    assert "b" in lazy and "zzz" not in lazy
    assert float(lazy.get("c")) == 11.0
    assert lazy.get("zzz", -1.0) == -1.0
    assert [float(v) for v in lazy.values()] == [9.0, 10.0, 11.0]
    with pytest.raises(KeyError):
        lazy["zzz"]


def test_chain_trace_records_every_window(tmp_path, monkeypatch):
    trace = tmp_path / "trace.json"
    monkeypatch.setenv("EADGAN_TRACE", str(trace))
    data = np.zeros((12, 4, 4), np.uint8)
    run_epochs(n_epochs=2, data=data, batch_size=2, state=types.SimpleNamespace(step=0),
               step_fn=_port_probe, on_batch=lambda *a: None, device="cpu", chain=4,
               chain_periods=(5,))
    spans = json.loads(trace.read_text())["spans"]
    windows = sorted((s for s in spans if s["name"] == "engine.window"), key=lambda s: s["start_ns"])
    # 6 batches an epoch: events at 0, 5 and 10 end windows; the last
    # window span, without s and k, drains the last window
    assert [(w["s"], w["k"]) for w in windows[:-1]] == [(0, 1), (1, 4), (5, 1), (6, 4), (10, 1),
                                                       (11, 1)]
    assert "s" not in windows[-1]
    assert all(w["end_ns"] >= w["start_ns"] for w in windows)
    by_id = {s["id"]: s for s in spans}
    for name in ("engine.feed", "engine.dispatch", "engine.drain.log"):
        assert all(by_id[s["parent"]]["name"] == "engine.window" for s in spans if s["name"] == name)


def test_restore_keeps_the_optimizers_capturable_setting(tmp_path):
    """A file written by a card optimizer (capturable, as every card state
    is) loads into a CPU one: the step count comes back on the CPU and the
    group stays non-capturable, so the CPU optimizer still steps."""
    config = PxyConfig(batch_size=2)
    state = init_pxy_state(config, device="cpu", seed=0)
    step = make_pxy_step(config)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (2, 64, 64, 1)).astype(np.float32))
    step(state, img)
    path = ckpt.save_train_state(str(tmp_path), "s", 0, state)
    payload = torch.load(path, weights_only=True)
    for group in payload["opt"]["param_groups"]:
        group["capturable"] = True  # as a card optimizer writes it
    torch.save(payload, path)

    restored = ckpt.restore_train_state(path, init_pxy_state(config, device="cpu", seed=1))
    assert not any(g["capturable"] for g in restored.opt.param_groups)
    steps = [st["step"] for st in restored.opt.state.values()]
    assert steps and all(s.device.type == "cpu" and float(s) == 1.0 for s in steps)
    step(restored, img)  # a capturable CPU optimizer would refuse this
    assert adam([torch.zeros(1, requires_grad=True)], 1e-3).param_groups[0]["capturable"] is False


def test_chain_flag():
    import argparse

    parser = argparse.ArgumentParser()
    add_run_args(parser)
    assert parser.parse_args([]).chain == 32
    assert parser.parse_args(["--chain", "1"]).chain == 1
    with pytest.raises(SystemExit):
        parser.parse_args(["--chain", "0"])


def test_rp_cli_chain_4_matches_chain_1(tmp_path, monkeypatch):
    """240 sprites at batch 4: 9 steps with grids at 0 and 6 (sample
    interval 3) and a save at 0; --chain 4 runs windows [0] [1,2,3,4]
    [5,6] [7,8]."""
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")
    records = {}
    for chain in (1, 4):
        out = tmp_path / f"chain{chain}"
        rp.main([
            "--batch_size", "4", "--max_steps", "9", "--sample_interval", "3", "--chain", str(chain),
            "--allow_fresh_pxy", "--data_dir", str(tmp_path), "--out_dir", str(out / "images"),
            "--ckpt_dir", str(out), "--jsonl", str(out / "m.jsonl"),
        ])
        records[chain] = [json.loads(line) for line in (out / "m.jsonl").read_text().splitlines()]
        for name in ("original", "trans", "varying_c1"):
            assert sorted(p.name for p in (out / "images" / name).iterdir()) == ["0.png", "6.png"]
        assert ckpt.saved_steps(str(out), rp.STATE_STEM) == [0]
    assert [r["step"] for r in records[1]] == [r["step"] for r in records[4]] == list(range(9))
    for a, b in zip(records[1], records[4]):
        for k in rp.METRIC_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=1e-5, err_msg=f"{a['step']} {k}")


@pytest.mark.parametrize("pipeline", PIPELINES)
def test_build_step_pipelines(pipeline):
    """The builder the card's chain check, profiler and step timing share:
    each pipeline's dataset (uint8; MNIST's float32 in [-1, 1]), batch
    arguments and step, one step on the CPU at batch 2."""
    state, step, data, prep = build_step(pipeline, batch_size=2, device="cpu")
    assert data.dtype == (np.float32 if pipeline == "mnist" else np.uint8) and len(data) >= 16
    assert prep["random_flip"] == (pipeline == "celeba")
    batch = first_batch(data, prep, 2, device="cpu")
    channels = 3 if pipeline == "celeba" else 1
    size = 32 if pipeline == "mnist" else 64
    assert batch.shape == (2, size, size, channels) and batch.dtype == torch.float32
    assert -1.0 <= float(batch.min()) and float(batch.max()) <= 1.0
    state, metrics = step(state, batch)
    assert state.step == 1 and all(np.isfinite(float(v)) for v in metrics.values())
