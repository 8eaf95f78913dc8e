"""The port's spans and counters (``utils/trace.py``) and where the
engines, the event worker, the grids and the saves record them.

Off, tracing records nothing and registers nothing; on, spans nest by
thread and land in ``torch.profiler``'s trace as user annotations.  The
card tests (marker ``cuda``; they skip without a card, decided inside
the fixture) hold the replayed step's device stamps: they increase
within a step, a graph captured with tracing on runs exactly one stamp
kernel more per stamp, and a span's host interval under the profiler
contains the device work it waited for.  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_port_trace.py``.
"""

import collections
import contextlib
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.optim import optimizer as optim_hooks

from eadgan_tpu_torch.sample.figures import sprites_training_grids
from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train.chain import ChainedStep, EventWorker, _Stamps
from eadgan_tpu_torch.train.config import PxyConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.pretrain import init_pxy_state
from eadgan_tpu_torch.utils import trace
from eadgan_tpu_torch.utils.profiler import busy_union_us


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


def _probe(state, img):
    state.step += 1
    return state, {"loss": img.float().mean()}


def _names(spans, name):
    return [s for s in spans if s["name"] == name]


class _HostStamps(_Stamps):
    """Stamps that note their slots on the host: the CPU has no device clock."""

    def __init__(self):
        self.kinds = []
        self.written = []

    def _write(self, index):
        self.written.append(index)


def _adam_body():
    model = torch.nn.Linear(3, 2)
    opts = [torch.optim.Adam([model.weight], lr=1e-3),
            torch.optim.Adam([model.bias], lr=1e-3)]
    seen = []

    def body(state, x):
        seen.append(len(optim_hooks._global_optimizer_pre_hooks)
                    + len(optim_hooks._global_optimizer_post_hooks))
        loss = model(x.float()).square().mean()
        loss.backward()
        for opt in opts:
            opt.step()
            opt.zero_grad()
        state.step += 1
        return state, {"loss": loss.detach()}

    return body, seen


def test_off_records_nothing_and_shares_one_null_span():
    trace.disable()
    trace.reset()
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b")
    with trace.span("a") as s:
        s.set(s=1)
        trace.count("c", 5)
    assert trace.collect() == {"spans": [], "counters": {}}


def test_off_registers_no_optimizer_hook():
    trace.disable()
    body, seen = _adam_body()
    chained = ChainedStep(body)
    chained(types.SimpleNamespace(step=0), (), torch.zeros((2, 4, 3)))
    assert seen == [0, 0] and chained.stamps is None and chained.window_stamps is None


def test_stamps_mark_each_phase_and_hook_the_optimizers_only_while_stepping():
    body, seen = _adam_body()
    chained = ChainedStep(body)
    stamps = _HostStamps()
    chained._step(types.SimpleNamespace(step=0), (), [torch.zeros((4, 3))], stamps)
    assert stamps.kinds == ["start", "prepare", "opt_pre", "opt_post", "opt_pre", "opt_post", "end"]
    assert stamps.written == list(range(7))
    assert seen == [2]  # the pre and post hooks, while the body ran
    assert not optim_hooks._global_optimizer_pre_hooks
    assert not optim_hooks._global_optimizer_post_hooks


def test_count_phases_splits_each_stamped_step(traced):
    chained = ChainedStep(_probe)
    chained.stamps = types.SimpleNamespace(
        kinds=["start", "prepare", "opt_pre", "opt_post", "opt_pre", "opt_post", "end"])
    stamps = np.array([[0] * 7,  # an eager step: no stamps
                       [100, 110, 150, 170, 180, 185, 200],
                       [300, 305, 350, 360, 370, 390, 400]], np.int64)
    chained.count_phases(stamps)
    c = trace.collect()["counters"]
    assert c == {"step.stamped": 2, "step.prepare_ns": 15, "step.optimizer_ns": 55,
                 "step.fwd_bwd_ns": 200 - 15 - 55}


def test_spans_nest_by_thread_and_counters_add(traced):
    with trace.span("outer") as outer:
        outer.set(s=3, k=4)
        with trace.span("inner"):
            trace.count("n")
            trace.count("n", 2)

    def other():
        with trace.span("elsewhere"):
            pass

    t = threading.Thread(target=other, name="side")
    t.start()
    t.join()
    got = trace.collect()
    spans = {s["name"]: s for s in got["spans"]}
    assert spans["inner"]["parent"] == spans["outer"]["id"] and spans["outer"]["parent"] is None
    assert spans["elsewhere"]["parent"] is None and spans["elsewhere"]["thread"] == "side"
    assert spans["outer"]["thread"] == threading.current_thread().name
    assert (spans["outer"]["s"], spans["outer"]["k"]) == (3, 4)
    assert spans["outer"]["start_ns"] <= spans["inner"]["start_ns"] <= spans["inner"]["end_ns"] \
        <= spans["outer"]["end_ns"]
    assert got["counters"] == {"n": 3}
    got["counters"]["n"] = 0  # a copy
    assert trace.collect()["counters"] == {"n": 3}
    trace.reset()
    assert trace.collect() == {"spans": [], "counters": {}}


def test_counters_and_spans_lose_nothing_across_threads(traced):
    n_threads, n = (os.cpu_count() or 4) + 2, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with trace.span("work"):
                    trace.count("n")
                    trace.count("bytes", 3)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    got = trace.collect()
    assert got["counters"] == {"n": n_threads * n, "bytes": 3 * n_threads * n}
    spans = got["spans"]
    assert len(spans) == n_threads * n and len({s["id"] for s in spans}) == len(spans)
    assert all(s["parent"] is None for s in spans)


def test_spans_are_user_annotations_under_the_profiler(traced):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("engine.window"):
            with trace.span("engine.feed"):
                torch.zeros(3).add_(1)
            with trace.span("engine.dispatch"):
                torch.ones(3).mul_(2)
    marks = {e.name(): e for e in prof.profiler.kineto_results.events() if e.is_user_annotation()}
    window, feed, dispatch = (marks[n] for n in ("engine.window", "engine.feed", "engine.dispatch"))
    assert window.start_ns() <= feed.start_ns() <= feed.end_ns() <= dispatch.start_ns() \
        <= dispatch.end_ns() <= window.end_ns()


def test_eadgan_trace_writes_the_per_step_engine_spans(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("EADGAN_TRACE", str(path))
    data = np.zeros((12, 4, 4), np.uint8)
    calls = []
    run_epochs(n_epochs=1, data=data, batch_size=2, state=types.SimpleNamespace(step=0),
               step_fn=_probe, on_batch=lambda *a: calls.append(a[0]), device="cpu", chain=1)
    assert not trace.enabled()  # on for the run only
    got = json.loads(path.read_text())
    spans = got["spans"]
    feeds = [s for s in _names(spans, "engine.feed") if "s" in s]
    assert [s["s"] for s in feeds] == list(range(6)) == calls
    assert len(_names(spans, "engine.step")) == len(_names(spans, "engine.callback")) == 6
    assert got["counters"] == {"engine.steps": 6}


def test_chained_engine_counts_windows_and_its_worker_events(tmp_path, monkeypatch):
    path = tmp_path / "trace.json"
    monkeypatch.setenv("EADGAN_TRACE", str(path))
    data = np.zeros((12, 4, 4), np.uint8)
    events = []
    run_epochs(n_epochs=2, data=data, batch_size=2, state=types.SimpleNamespace(step=0),
               step_fn=_probe, on_batch=lambda i, *a: events.append(i), device="cpu", chain=4,
               chain_periods=(5,))
    got = json.loads(path.read_text())
    spans, c = got["spans"], got["counters"]
    assert events == [0, 5, 10]
    assert c["engine.windows"] == 6 and c["engine.steps"] == 12 and c["worker.events"] == 3
    assert "engine.captures" not in c  # the CPU runs its steps eagerly
    by_id = {s["id"]: s for s in spans}
    worker = [s for s in spans if s["thread"] == "eadgan-event-worker"]
    assert {s["name"] for s in worker} == {"worker.event", "worker.callback"}
    assert all(by_id[s["parent"]]["name"] == "worker.event" for s in _names(worker, "worker.callback"))
    submits = _names(spans, "engine.event.submit")
    assert len(submits) == 3 and all(by_id[s["parent"]]["name"] == "engine.event" for s in submits)


def test_worker_counts_a_submit_that_waits_for_room(traced):
    started, release = threading.Event(), threading.Event()
    ran = []

    def hold():
        started.set()
        release.wait()
        ran.append("hold")

    worker = EventWorker(maxsize=1)
    worker.submit(hold)
    started.wait()
    worker.submit(lambda: ran.append("queued"))  # fills the queue
    threading.Timer(0.2, release.set).start()
    t0 = time.perf_counter()
    worker.submit(lambda: ran.append("blocked"))  # waits until the worker takes the next
    waited = time.perf_counter() - t0
    worker.close()
    got = trace.collect()
    assert ran == ["hold", "queued", "blocked"] and waited >= 0.1
    assert got["counters"] == {"worker.events": 3, "worker.submit_blocked": 1}
    assert len(_names(got["spans"], "engine.event.submit")) == 3
    assert len(_names(got["spans"], "worker.event")) == 3


def test_saves_and_grids_are_counted(tmp_path, traced):
    model = torch.nn.Linear(3, 2)
    ckpt.save_checkpoint(str(tmp_path / "a.tar"), {"w": model.weight.detach()})
    state = init_pxy_state(PxyConfig(batch_size=2), device="cpu", seed=0)
    path = ckpt.save_train_state(str(tmp_path), "s", 3, state)
    sprites_training_grids(lambda z: np.zeros((len(z), 8, 8, 1), np.float32),
                           np.zeros((10, 8, 8, 1)), np.zeros((10, 8, 8, 1)), str(tmp_path / "img"),
                           0, n_cols=10)
    got = trace.collect()
    sizes = (tmp_path / "a.tar").stat().st_size + (tmp_path / "s_3.ckpt").stat().st_size
    assert path.endswith("s_3.ckpt")
    assert got["counters"] == {"checkpoint.saves": 2, "checkpoint.bytes": sizes, "sample.grids": 1}
    assert len(_names(got["spans"], "checkpoint.save")) == 2
    assert len(_names(got["spans"], "sample.grid")) == 1


def test_busy_union_counts_overlapping_streams_once():
    assert busy_union_us([]) == 0
    # two streams overlapping on [2, 3], a gap [5, 6]
    assert busy_union_us([(0.0, 3.0), (2.0, 5.0), (6.0, 7.0), (6.5, 6.8)]) == 6.0


# ---- on the card --------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from eadgan_tpu_torch.ops import _build

    _build.load_library()
    return torch.device("cuda", 0)


def _card_step(device):
    model = torch.nn.Linear(64, 64).to(device)
    opts = [torch.optim.Adam([model.weight], lr=1e-3, capturable=True),
            torch.optim.Adam([model.bias], lr=1e-3, capturable=True)]

    def body(state, x):
        loss = model(x).square().mean()
        loss.backward()
        for opt in opts:
            opt.step()
            opt.zero_grad(set_to_none=False)
        state.step += 1
        return state, {"loss": loss.detach()}

    return body


@contextlib.contextmanager
def _tracing(on):
    (trace.enable if on else trace.disable)()
    try:
        yield
    finally:
        trace.disable()


def _chained(device, on):
    with _tracing(on):
        chained = ChainedStep(_card_step(device))
        window = torch.randn((4, 32, 64), device=device)
        chained(types.SimpleNamespace(step=0), (), window)  # the eager step and the capture
        torch.cuda.synchronize()
    return chained, window


def _window_ops(chained, window, on):
    """The device operations, kernels and copies, of a window of replays
    with tracing ``on`` or off at the call."""
    with _tracing(on), torch.profiler.profile(**_PROFILE) as prof:
        chained(types.SimpleNamespace(step=4), (), window)
        torch.cuda.synchronize()
    return len(_device_ops(prof)) + len(_device_ops(prof, copies=True))


def _device_ops(prof, copies=False):
    """The names of the kernels (or, with ``copies``, the memory copies)
    the trace holds on the device, the host's annotations mirrored there
    left out."""
    events = list(prof.profiler.kineto_results.events())
    cuda = torch.autograd.DeviceType.CUDA
    marks = {e.name() for e in events if e.device_type() != cuda and e.is_user_annotation()}
    names = [e.name() for e in events if e.device_type() == cuda and e.name() not in marks]
    return [n for n in names if n.startswith("Memcpy") == copies and not n.startswith("Memset")]


_PROFILE = dict(activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])


@pytest.mark.cuda
def test_stamps_increase_within_a_replayed_step(card):
    chained, window = _chained(card, True)
    assert chained.stamps.kinds == ["start", "prepare", "opt_pre", "opt_post", "opt_pre",
                                    "opt_post", "end"]
    with _tracing(True):
        chained(types.SimpleNamespace(step=4), (), window)
    rows = chained.window_stamps.cpu().numpy()
    assert rows.shape == (4, 7)
    for row in rows:
        assert np.all(np.diff(row) >= 0) and row[-1] > row[0], row


@pytest.mark.cuda
def test_a_traced_graph_runs_one_more_kernel_per_stamp(card):
    replays = 3
    kernels, copies = {}, {}
    for on in (False, True):
        chained, window = _chained(card, on)
        chained.graph.replay()
        torch.cuda.synchronize()
        with torch.profiler.profile(**_PROFILE) as prof:
            for _ in range(replays):
                chained.graph.replay()
                torch.cuda.synchronize()
        kernels[on] = collections.Counter(_device_ops(prof) + _device_ops(prof, copies=True))
        copies[on] = _window_ops(chained, window, on)
    # captured with tracing on, called with it off: the graph's stamps
    # only, no window buffer and no copy into it
    untraced_call = _window_ops(chained, window, False)
    assert chained.window_stamps is None
    stamps = sum(n for name, n in kernels[True].items() if "stamp_kernel" in name)
    assert stamps == 7 * replays
    # CUDA may run a memory copy of the graph as a copy or as a
    # kernel (memcpy32_post) depending on its neighbours: count both
    assert sum(kernels[True].values()) - sum(kernels[False].values()) == 7 * replays, kernels
    # a window of 4 replays: the graphs' stamps and one copy of them a
    # replay into the window's buffer
    assert copies[True] - copies[False] == 4 * 7 + 4
    assert untraced_call - copies[False] == 4 * 7


@pytest.mark.cuda
def test_a_span_holds_the_device_work_it_waited_for(card, traced):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        with trace.span("probe.sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    mark = next(e for e in events if e.name() == "probe.sleep" and e.is_user_annotation()
                and e.device_type() != torch.autograd.DeviceType.CUDA)
    sleep = next(e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                 and "spin" in e.name())
    assert mark.start_ns() <= sleep.start_ns() < sleep.end_ns() <= mark.end_ns()
