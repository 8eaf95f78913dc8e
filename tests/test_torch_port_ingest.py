"""The port's host-fed data path against the JAX package, on the CPU.

* The three native gathers (``eadgan_tpu_torch/data/native.py`` on the
  port's own ``csrc/batcher.cpp``) equal the JAX package's bindings and
  their own plain numpy versions bit for bit: 2-D and 3-channel rows,
  flips on all, none and some rows, both scalings, into a caller's
  buffer; a build that fails raises.
* ``Prefetcher`` keeps the JAX contract: order, an error raised on the
  consumer's side, ``close()`` mid-iteration leaving no live thread, the
  depth bound.  ``epoch_batches`` equals the JAX loader's.
* The per-step engine on the Prefetcher: a probe step whose metrics are
  checksums of its batch sees the JAX per-step engine's rows and flips
  (uint8 with flips, float32), fresh and resumed, within 1e-5 relative and
  1e-4 absolute (sums in float32 in other orders; a wrong row or flip
  moves a checksum by ~1); on the pxy step it logs the losses and hands
  the event batches of the plain loop over ``epoch_batches`` bit for
  bit; uint8 batches never go through numpy.
* The chained engine's raw windows (``EADGAN_DEVICE_DATA_MAX=0``): the
  probe sees the JAX ``hostwin`` engine's rows and flips; on gray pxy at
  batch 8 with flips it is bit-equal to the resident run and to the
  per-step run; float32 images (MNIST) travel as they are, equal to the
  resident run; a dataset within the limit stays resident.
"""

import itertools
import threading
import time
import types
import typing

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.data import loader as jax_loader
from eadgan_tpu.data import native as jax_native
from eadgan_tpu.train.engine import run_epochs as jax_run_epochs
from eadgan_tpu_torch.data import Prefetcher, epoch_batches, native
from eadgan_tpu_torch.data.loader import PinnedStager
from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.train import engine
from eadgan_tpu_torch.train.config import PxyConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.pretrain import init_pxy_state, make_pxy_step

SCALINGS = [(1.0 / 127.5, -1.0), (1.0, 0.0)]


def _flips(kind, n, rng):
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "mixed": rng.random(n) < 0.5}[kind]


@pytest.mark.parametrize("scale,shift", SCALINGS, ids=["celeba", "sprites"])
@pytest.mark.parametrize("flip", ["off", "all", "none", "mixed"])
@pytest.mark.parametrize("shape", [(50, 9, 7), (50, 9, 7, 3)], ids=["2d", "3ch"])
def test_gathers_equal_jax_and_plain(shape, flip, scale, shift):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, shape, np.uint8)
    idx = rng.permutation(50)[:17]
    if flip == "off":
        ours = native.gather_normalize(data, idx, scale, shift)
        theirs = jax_native.gather_normalize(data, idx, scale, shift)
        plain = native.gather_normalize_plain(data, idx, scale, shift)
    else:
        mask = _flips(flip, 17, rng)
        ours = native.gather_normalize_flip(data, idx, mask, scale, shift)
        theirs = jax_native.gather_normalize_flip(data, idx, mask, scale, shift)
        plain = native.gather_normalize_flip_plain(data, idx, mask, scale, shift)
    want_shape = (17, 9, 7, 3 if len(shape) == 4 else 1)
    assert ours.shape == plain.shape == theirs.shape == want_shape
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, plain)
    # one thread and a caller's buffer give the same bits
    out = np.full(want_shape, np.nan, np.float32)
    if flip == "off":
        again = native.gather_normalize(data, idx, scale, shift, n_threads=1, out=out)
    else:
        again = native.gather_normalize_flip(data, idx, mask, scale, shift, n_threads=1, out=out)
    assert again is out
    np.testing.assert_array_equal(out, ours)


@pytest.mark.parametrize("scale,shift", SCALINGS, ids=["celeba", "sprites"])
def test_colorize_equals_jax_and_plain(scale, shift):
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (40, 8, 6), np.uint8)
    idx = rng.permutation(40)[:19]
    gains = rng.random((19, 3)).astype(np.float32) * 2
    ours = native.gather_colorize(data, idx, gains, scale, shift)
    np.testing.assert_array_equal(ours, jax_native.gather_colorize(data, idx, gains, scale, shift))
    np.testing.assert_array_equal(ours, native.gather_colorize_plain(data, idx, gains, scale, shift))
    assert ours.shape == (19, 8, 6, 3)


def test_gathers_check_their_inputs():
    data = np.zeros((10, 4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.gather_normalize(data[:, :, ::-1], [0, 1])
    with pytest.raises(ValueError, match="C-contiguous uint8"):
        native.gather_normalize(data.astype(np.float32), [0, 1])
    with pytest.raises(IndexError):
        native.gather_normalize(data, [0, 10])
    with pytest.raises(ValueError, match="out must be"):
        native.gather_normalize(data, [0, 1], out=np.empty((2, 4, 4, 1), np.float32))
    with pytest.raises(ValueError, match="flip mask"):
        native.gather_normalize_flip(data, [0, 1], [True])


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no compiler, raises
    with the compiler's output, and leaves no library behind."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_host(bad, "libbad")
    assert not list((tmp_path / "build").glob("*"))
    with pytest.raises(RuntimeError, match="not found"):
        _build.build_host(bad, "libbad", compiler=str(tmp_path / "no-such-compiler"))


# --- Prefetcher -----------------------------------------------------------------------------


def test_prefetcher_keeps_order():
    assert list(Prefetcher(range(50), place=lambda x: 2 * x, depth=3)) == list(range(0, 100, 2))
    assert list(Prefetcher(iter([]))) == []


@pytest.mark.parametrize("where", ["batches", "place"])
def test_prefetcher_raises_on_the_consumer_side(where):
    def batches():
        for i in range(10):
            if where == "batches" and i == 3:
                raise KeyError("from the batches")
            yield i

    def place(i):
        if where == "place" and i == 3:
            raise KeyError("from place")
        return i

    got = []
    with pytest.raises(KeyError, match=f"from {'the batches' if where == 'batches' else 'place'}"):
        for item in Prefetcher(batches(), place=place):
            got.append(item)
    assert got == [0, 1, 2]


def test_prefetcher_close_mid_iteration_releases_the_thread():
    made = []

    def endless():
        i = 0
        while True:
            made.append(i)
            yield i
            i += 1

    feed = Prefetcher(endless(), depth=2)
    seen = []
    for item in feed:
        seen.append(item)
        if len(seen) == 5:
            break
    feed.close()
    assert seen == list(range(5))
    assert not feed._thread.is_alive()
    n = len(made)
    time.sleep(0.3)
    assert len(made) == n  # nothing more is drawn once closed


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetcher_depth_bound(depth):
    made = []

    def batches():
        for i in range(20):
            made.append(i)
            yield i

    feed = Prefetcher(batches(), depth=depth)
    deadline = time.monotonic() + 5
    while len(made) < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)
    # ``depth`` staged in the queue and one more in the worker's hands
    assert len(made) == depth + 1
    assert list(feed) == list(range(20))
    feed._thread.join(timeout=5)
    assert not feed._thread.is_alive()


def test_prefetcher_stress_with_a_short_switch_interval():
    """Many consumers' worth of threads against a fast switch: every item
    arrives once, in order, and every worker ends."""
    import sys

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        feeds = [Prefetcher(range(300), place=lambda x, k=k: (k, x), depth=2) for k in range(12)]
        results = {}

        def consume(k, feed):
            results[k] = list(feed)

        threads = [threading.Thread(target=consume, args=(k, f)) for k, f in enumerate(feeds)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert all(not t.is_alive() for t in threads)
        for k in range(12):
            assert results[k] == [(k, x) for x in range(300)]
    finally:
        sys.setswitchinterval(saved)


def test_epoch_batches_equal_jax_loader():
    rng_data = np.random.default_rng(4)
    data = rng_data.integers(0, 256, (23, 3, 2), np.uint8)
    labels = np.arange(23)
    for drop_last in (True, False):
        ours = list(epoch_batches(data, 5, np.random.default_rng(9), labels=labels,
                                  drop_last=drop_last))
        theirs = list(jax_loader.epoch_batches(data, 5, np.random.default_rng(9), labels=labels,
                                               drop_last=drop_last))
        assert len(ours) == len(theirs) == (4 if drop_last else 5)
        for (x, y), (u, v) in zip(ours, theirs):
            np.testing.assert_array_equal(x, u)
            np.testing.assert_array_equal(y, v)


def test_pinned_stager_on_the_cpu_stages_fresh_host_tensors():
    stager = PinnedStager("cpu")
    a = stager.stage([((2, 3), np.float32, lambda out: out.fill(1.0)),
                      ((4,), np.bool_, lambda out: out.fill(True))])
    b = stager.stage([((2, 3), np.float32, lambda out: out.fill(2.0)),
                      ((4,), np.bool_, lambda out: out.fill(False))])
    x, m = a.get()
    assert x.dtype == torch.float32 and m.dtype == torch.bool and x.device.type == "cpu"
    assert torch.equal(x, torch.ones(2, 3)) and bool(m.all())  # not overwritten by b
    assert torch.equal(b.get()[0], torch.full((2, 3), 2.0))


# --- the engines ----------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.records = {}

    def log(self, step, metrics, **kw):
        self.records[int(step)] = {k: float(v) for k, v in metrics.items()}

    def close(self):
        pass


def _weights(shape):
    b, h, w = shape[:3]
    return np.arange(1, b * h * w + 1, dtype=np.float32).reshape(b, h, w, 1) / (b * h * w)


def _port_probe(state, img):
    state.step += 1
    return state, {"sum": img.sum(), "wsum": (img * torch.from_numpy(_weights(img.shape))).sum()}


class _JaxState(typing.NamedTuple):
    step: object


def _jax_probe(state, img):
    return _JaxState(state.step + 1), {"sum": jnp.sum(img),
                                       "wsum": jnp.sum(img * _weights(img.shape))}


def _probe_runs(data, chain, start, max_steps, flip, monkeypatch, raw=False):
    scale, shift = (1.0 / 127.5, -1.0) if data.dtype == np.uint8 else (1.0, 0.0)
    common = dict(n_epochs=3, data=data, batch_size=3, seed=7, max_steps=max_steps, scale=scale,
                  shift=shift, random_flip=flip, chain=chain, chain_periods=(4,) if chain > 1 else ())
    if raw:
        monkeypatch.setenv("EADGAN_DEVICE_DATA_MAX", "0")
    ours = _Log()
    state = run_epochs(state=types.SimpleNamespace(step=start), step_fn=_port_probe, device="cpu",
                       logger=ours, on_batch=lambda *a: None, **common)
    theirs = _Log()
    jax_run_epochs(labels=None, state=_JaxState(jnp.int32(start)), step_fn=_jax_probe,
                   on_batch=lambda *a: None, step_body=_jax_probe, logger=theirs, **common)
    return state, ours.records, theirs.records


@pytest.mark.parametrize("start,max_steps", [(0, 0), (0, 13), (6, 0)])
@pytest.mark.parametrize("kind", ["uint8-flip", "float32"])
def test_per_step_engine_rows_match_jax(kind, start, max_steps, monkeypatch):
    """10 batches of 3 an epoch, 3 epochs."""
    rng = np.random.default_rng(0)
    if kind == "float32":
        data = (rng.random((31, 8, 6, 1)) * 2 - 1).astype(np.float32)
    else:
        data = rng.integers(0, 256, (31, 8, 6, 3), np.uint8)
    state, ours, theirs = _probe_runs(data, 1, start, max_steps, kind != "float32", monkeypatch)
    planned = min(30, start + max_steps) if max_steps else 30
    assert state.step == planned and sorted(ours) == list(range(start, planned))
    # resumed: the JAX per-step engine runs its resumed epoch whole
    shared = range(start, min(planned, (start // 10 + 1) * 10) if start else planned)
    for i in shared:
        for k in ("sum", "wsum"):
            np.testing.assert_allclose(ours[i][k], theirs[i][k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"step {i} {k}")


def test_raw_windows_rows_match_jax_hostwin(monkeypatch):
    data = np.random.default_rng(1).integers(0, 256, (31, 8, 6), np.uint8)
    state, ours, theirs = _probe_runs(data, 5, 0, 0, True, monkeypatch, raw=True)
    assert state.step == 30 and sorted(ours) == sorted(theirs) == list(range(30))
    for i in range(30):
        for k in ("sum", "wsum"):
            np.testing.assert_allclose(ours[i][k], theirs[i][k], rtol=1e-5, atol=1e-4,
                                       err_msg=f"step {i} {k}")


def _pxy_run(data, chain, monkeypatch, device_data_max=None, events=None):
    if device_data_max is not None:
        monkeypatch.setenv("EADGAN_DEVICE_DATA_MAX", str(device_data_max))
    else:
        monkeypatch.delenv("EADGAN_DEVICE_DATA_MAX", raising=False)
    config = PxyConfig(batch_size=8)
    state = init_pxy_state(config, device="cpu", seed=7)
    log = _Log()

    def on_batch(i, st, metrics, batch):
        if i % 4 == 0:
            events.append((i, batch[0].numpy().copy(), float(metrics["affine_loss"])))

    final = run_epochs(n_epochs=50, data=data, batch_size=8, state=state,
                       step_fn=make_pxy_step(config), on_batch=on_batch, device="cpu", seed=0,
                       max_steps=10, logger=log, scale=1.0 / 127.5, shift=-1.0, random_flip=True,
                       metric_keys=["affine_loss"], chain=chain, chain_periods=(4,))
    return final, log.records


def _assert_same_run(a, b):
    (sa, la, ea), (sb, lb, eb) = a, b
    assert la == lb
    assert [e[0] for e in ea] == [e[0] for e in eb] == [0, 4, 8]
    for (_, x, lx), (_, y, ly) in zip(ea, eb):
        np.testing.assert_array_equal(x, y)
        assert lx == ly
    assert sa.step == sb.step == 10
    for u, v in zip(sa.model.state_dict().values(), sb.model.state_dict().values()):
        assert torch.equal(u, v)


def test_per_step_engine_matches_the_plain_loop_on_pxy(monkeypatch):
    """The Prefetcher path against the plain loop over ``epoch_batches``
    (the numpy gather on the main thread), the same step and state."""
    data = np.random.default_rng(3).integers(0, 256, (24, 64, 64), np.uint8)
    ev = []
    run = _pxy_run(data, 1, monkeypatch, events=ev)

    config = PxyConfig(batch_size=8)
    state = init_pxy_state(config, device="cpu", seed=7)
    step = make_pxy_step(config)
    log, plain_ev = {}, []
    plain = engine.epoch_batches(data, 8, 50, seed=0, scale=1.0 / 127.5, shift=-1.0,
                                 random_flip=True)
    for i, (_, host) in enumerate(itertools.islice(plain, 10)):
        batch = torch.from_numpy(host)
        state, metrics = step(state, batch)
        log[i] = {"affine_loss": float(metrics["affine_loss"])}
        if i % 4 == 0:
            plain_ev.append((i, host.copy(), float(metrics["affine_loss"])))
    _assert_same_run(run + (ev,), (state, log, plain_ev))


def test_raw_windows_equal_resident_and_per_step_on_pxy(monkeypatch):
    data = np.random.default_rng(3).integers(0, 256, (24, 64, 64), np.uint8)
    runs = {}
    for name, chain, limit in (("raw", 5, 0), ("resident", 5, None), ("per_step", 1, None)):
        events = []
        runs[name] = _pxy_run(data, chain, monkeypatch, limit, events) + (events,)
    _assert_same_run(runs["raw"], runs["resident"])
    _assert_same_run(runs["raw"], runs["per_step"])


@pytest.mark.parametrize("limit,raw", [(None, False), (0, True), ("nbytes", False)])
def test_device_data_max_selects_the_path(limit, raw, monkeypatch):
    """Above the limit the windows stream through the stager; at or below
    it nothing is staged, the dataset is resident."""
    data = np.random.default_rng(2).integers(0, 256, (12, 8, 6, 3), np.uint8)
    if limit is not None:
        monkeypatch.setenv("EADGAN_DEVICE_DATA_MAX", str(data.nbytes if limit == "nbytes" else limit))
    staged = []
    stage = PinnedStager.stage
    monkeypatch.setattr(PinnedStager, "stage", lambda self, specs: staged.append(1) or stage(self, specs))
    run_epochs(n_epochs=1, data=data, batch_size=3, state=types.SimpleNamespace(step=0),
               step_fn=_port_probe, on_batch=lambda *a: None, device="cpu", chain=4)
    assert bool(staged) == raw


def test_uint8_batches_never_go_through_numpy(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a uint8 batch went through the numpy gather")

    monkeypatch.setattr(native, "gather_normalize_plain", refuse)
    monkeypatch.setattr(native, "gather_normalize_flip_plain", refuse)
    data = np.random.default_rng(2).integers(0, 256, (12, 8, 6, 3), np.uint8)
    for flip in (False, True):
        state = run_epochs(n_epochs=2, data=data[:, :, ::-1] if flip else data, batch_size=3,
                           state=types.SimpleNamespace(step=0), step_fn=_port_probe,
                           on_batch=lambda *a: None, device="cpu", random_flip=flip)
        assert state.step == 8


def test_raw_windows_of_float_images_equal_resident(monkeypatch):
    """MNIST's float32 images above the limit: the windows carry the
    images themselves, no prepare; the same steps see the same batches."""
    data = (np.random.default_rng(5).random((31, 8, 6, 1)) * 2 - 1).astype(np.float32)
    logs = {}
    for name, limit in (("resident", None), ("raw", "0")):
        if limit is None:
            monkeypatch.delenv("EADGAN_DEVICE_DATA_MAX", raising=False)
        else:
            monkeypatch.setenv("EADGAN_DEVICE_DATA_MAX", limit)
        logs[name], events = _Log(), []
        state = run_epochs(n_epochs=2, data=data, batch_size=3, state=types.SimpleNamespace(step=0),
                           step_fn=_port_probe, device="cpu", logger=logs[name], chain=5,
                           chain_periods=(4,), on_batch=lambda i, st, m, b: events.append(
                               (i, np.asarray(b[0]).copy())))
        assert state.step == 20
        logs[name] = (logs[name].records, events)
    assert logs["raw"][0] == logs["resident"][0]
    assert [e[0] for e in logs["raw"][1]] == [e[0] for e in logs["resident"][1]] == [0, 4, 8, 12, 16]
    for (_, x), (_, y) in zip(logs["raw"][1], logs["resident"][1]):
        np.testing.assert_array_equal(x, y)
