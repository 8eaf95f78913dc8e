"""The chained engine's asynchronous event windows on the CPU:
``EventWorker`` and ``snapshot_state`` (``eadgan_tpu_torch/train/
chain.py``) and their use in ``train/engine.py::_run_epochs_chained``.

* The worker runs callbacks in order and re-raises a callback's error at
  the next ``submit``, ``flush`` or ``close``, as the JAX package's
  ``EventWorker`` (``tests/test_chain.py``).
* A snapshot shares no storage with the live state, and a later in-place
  update of the live state leaves it as it was.
* A callback that sleeps (while the engine runs the next windows, which
  update the live state in place) and then reads a parameter sees the
  value the per-step engine's callback sees at that step: rtol 2e-3,
  atol 1e-5, the tolerance of ``tests/test_torch_port_chain.py``'s
  chained-vs-per-step comparison on the CPU, where the two engines'
  batches sit in differently aligned buffers and the CPU's matrix
  library rounds them an ulp apart; and bit for bit what the chained
  engine's inline callback (``EADGAN_SYNC_EVENTS=1``) sees.
* A train-state checkpoint written through the worker equals, tensor for
  tensor, the one written inline, and exists when ``run_epochs`` returns.
* An exception in ``on_batch`` makes ``run_epochs`` raise it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train.chain import EventWorker, snapshot_state
from eadgan_tpu_torch.train.config import PxyConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.pretrain import init_pxy_state, make_pxy_step


def test_event_worker_orders_and_propagates():
    seen = []
    worker = EventWorker()
    for i in range(5):
        worker.submit(lambda i=i: seen.append(i))
    worker.close()
    assert seen == [0, 1, 2, 3, 4]

    worker = EventWorker()
    worker.submit(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        worker.close()


def test_event_worker_raises_at_the_next_submit_and_flush():
    worker = EventWorker()
    worker.submit(lambda: 1 / 0)
    worker._q.join()  # the failing callback has run
    with pytest.raises(ZeroDivisionError):
        worker.submit(lambda: None)
    worker.submit(lambda: [][0])
    with pytest.raises(IndexError):
        worker.flush()
    worker.close()  # the errors were raised once each


def test_event_worker_queue_is_bounded_and_flush_waits():
    gate, ran = threading.Event(), []
    worker = EventWorker(maxsize=1)
    worker.submit(gate.wait)  # the worker takes it and blocks
    time.sleep(0.05)
    worker.submit(lambda: ran.append(1))  # fills the queue
    blocked = threading.Thread(target=worker.submit, args=(lambda: ran.append(2),))
    blocked.start()
    blocked.join(0.2)
    assert blocked.is_alive()  # a third submit waits for room
    gate.set()
    blocked.join(5)
    worker.flush()
    assert ran == [1, 2]
    worker.close()


def test_snapshot_shares_no_storage_and_keeps_its_values():
    config = PxyConfig(batch_size=2)
    state = init_pxy_state(config, device="cpu", seed=0)
    step = make_pxy_step(config)
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (2, 64, 64, 1)).astype(np.float32))
    step(state, img)  # Adam has moments and a step count
    snap = snapshot_state(state)
    live = [t for t in state.model.state_dict().values()]
    live += [t for s in state.opt.state.values() for t in s.values() if torch.is_tensor(t)]
    copied = [t for t in snap.model.state_dict().values()]
    copied += [t for s in snap.opt.state.values() for t in s.values() if torch.is_tensor(t)]
    assert len(live) == len(copied) > 0
    pointers = {t.untyped_storage().data_ptr() for t in live}
    assert not pointers & {t.untyped_storage().data_ptr() for t in copied}
    before = [t.clone() for t in copied]
    assert snap.step == state.step and snap.rng is not state.rng
    assert torch.equal(snap.rng.get_state(), state.rng.get_state())
    assert state.rng is not None  # the live state keeps its generator
    # the snapshot's optimizer holds the snapshot's parameters
    assert {id(p) for g in snap.opt.param_groups for p in g["params"]} == {
        id(p) for p in snap.model.parameters()}
    step(state, img)  # updates the live state in place
    assert all(torch.equal(a, b) for a, b in zip(before, copied))
    assert any(not torch.equal(a, b) for a, b in zip(live, copied))


def _pxy_events(chain, data, read, monkeypatch, sync=False, on_event=None):
    """10 pxy steps at batch 4, events every 4 steps; ``read(step, state)``
    is called at each event after a sleep, long enough for the engine to
    run the next windows."""
    monkeypatch.setenv("EADGAN_SYNC_EVENTS", "1" if sync else "0")
    config = PxyConfig(batch_size=4)
    state = init_pxy_state(config, device="cpu", seed=7)

    def on_batch(i, st, metrics, batch):
        if i % 4 == 0:
            if on_event is not None:
                on_event(i, st)
            time.sleep(0.1)
            read(i, st, metrics)

    return run_epochs(n_epochs=50, data=data, batch_size=4, state=state,
                      step_fn=make_pxy_step(config), on_batch=on_batch, device="cpu", seed=0,
                      max_steps=10, chain=chain, chain_periods=(4,))


def test_callback_reads_the_state_of_its_step(monkeypatch):
    data = np.random.default_rng(3).integers(0, 2, (24, 64, 64), np.uint8)
    runs = {}
    for name, chain, sync in (("per_step", 1, False), ("sync", 4, True), ("worker", 4, False)):
        reads, threads = [], []

        def read(i, st, metrics, reads=reads, threads=threads):
            threads.append(threading.current_thread().name)
            params = torch.cat([p.detach().flatten() for p in st.model.parameters()])
            reads.append((i, params, float(metrics["affine_loss"])))

        final = _pxy_events(chain, data, read, monkeypatch, sync=sync)
        runs[name] = reads
        assert final.step == 10
        assert [r[0] for r in reads] == [0, 4, 8]
        assert set(threads) == {"eadgan-event-worker" if name == "worker" else "MainThread"}
    for (_, a, la), (_, b, lb) in zip(runs["sync"], runs["worker"]):
        assert torch.equal(a, b) and la == lb
    for (_, a, la), (_, b, lb) in zip(runs["per_step"], runs["worker"]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-3, atol=1e-5)
        np.testing.assert_allclose(lb, la, rtol=2e-3, atol=1e-5)


def test_checkpoint_through_the_worker_equals_the_inline_one(tmp_path, monkeypatch):
    data = np.random.default_rng(4).integers(0, 2, (24, 64, 64), np.uint8)
    for name, sync in (("inline", True), ("worker", False)):
        out = tmp_path / name
        out.mkdir()

        def save(i, st, out=out):
            ckpt.save_train_state(str(out), "pxy_state", i, st)

        _pxy_events(4, data, lambda *a: None, monkeypatch, sync=sync, on_event=save)
        # every queued write is on disk when run_epochs returns
        assert ckpt.saved_steps(str(out), "pxy_state") == [8, 4, 0]
    for step in (0, 4, 8):
        a, b = (torch.load(tmp_path / n / f"pxy_state_{step}.ckpt", weights_only=True)
                for n in ("inline", "worker"))
        assert a.keys() == b.keys() and a["step"] == b["step"] == step + 1

        def flat(obj, prefix=""):
            if torch.is_tensor(obj):
                return {prefix: obj}
            if isinstance(obj, dict):
                return {k: v for key, val in obj.items() for k, v in flat(val, f"{prefix}/{key}").items()}
            if isinstance(obj, (list, tuple)):
                return {k: v for j, val in enumerate(obj) for k, v in flat(val, f"{prefix}/{j}").items()}
            return {prefix: obj}

        fa, fb = flat(a), flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            if torch.is_tensor(fa[k]):
                assert torch.equal(fa[k], fb[k]), (step, k)
            else:
                assert fa[k] == fb[k], (step, k)


@pytest.mark.parametrize("sync", [False, True], ids=["worker", "inline"])
def test_an_error_in_on_batch_makes_run_epochs_raise(monkeypatch, sync):
    data = np.random.default_rng(5).integers(0, 2, (24, 64, 64), np.uint8)

    def fail(i, st):
        if i == 4:
            raise OSError("disk full")

    with pytest.raises(OSError, match="disk full"):
        _pxy_events(4, data, lambda *a: None, monkeypatch, sync=sync, on_event=fail)
