"""The readers of the program's spans and counters, on synthetic records,
and the traced stretch's new keys: every existing key and reader reads
the same with the program's spans present or absent."""

import importlib.util
import types

import pytest
import torch

from conftest import BENCH

from harness import tracing
from harness.spans import intersect, merge, subtract

MS = 1_000_000  # ns


def _reader(name):
    spec = importlib.util.spec_from_file_location(name, BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


NEW = ("host_idle_ms.train", "engine_host_ms.train", "optimizer_ms.train", "event_stall_ms.train")
OLD = ("step_device_ms.train", "mfu.train", "warp_roofline.train", "device_idle.train")


def _stretch():
    """Two steps over 20 ms: the engine's window spans tile it, a 6 ms
    device wait, a 2 ms queue stall inside dispatch, idle 3-5 and 12-15."""
    spans = [
        ["engine.window", -1 * MS, 10 * MS, 7], ["engine.window", 10 * MS, 21 * MS, 7],
        ["engine.dispatch", 1 * MS, 4 * MS, 7], ["Command Buffer Full", 2 * MS, 4 * MS, 7],
        ["engine.drain.wait", 4 * MS, 10 * MS, 7], ["engine.dispatch", 11 * MS, 12 * MS, 7],
        ["Optimizer.step#Adam.step", 0, 20 * MS, 9],
    ]
    return {"stretch_s": 0.02, "busy_s": 0.015, "steps": 2, "kernel_s": {"warp_affine_kernel": 0.001},
            "kernel_count": {"warp_affine_kernel": 2}, "host_spans": spans,
            "idle": [[3 * MS, 5 * MS], [12 * MS, 15 * MS]]}


def _records():
    return {
        "stretch": _stretch(),
        "window": {"seconds": 1.0, "steps": 40, "batch": 128},
        "flops_per_step": 1e12, "compute": "bf16", "warp": {"bytes_per_launch": 1e6},
        "program": {
            "spans": [
                {"name": "engine.event", "start_ns": 100, "end_ns": 100 + 30 * MS},
                {"name": "engine.flush", "start_ns": 0, "end_ns": 50},  # before the window
                {"name": "worker.event", "start_ns": 200, "end_ns": 500 * MS},
                {"name": "worker.event", "start_ns": 10 ** 12, "end_ns": 10 ** 12 + 5},  # after
            ],
            "counters": {"step.stamped": 30, "step.optimizer_ns": 90 * MS},
            "counters_open": {"step.stamped": 10, "step.optimizer_ns": 30 * MS},
            "t_open_ns": 100, "t_close_ns": 10 ** 10,
        },
    }


def test_interval_arithmetic():
    assert merge([(5, 9), (0, 3), (2, 4), (8, 12)], 1, 11) == [(1, 4), (5, 11)]
    assert intersect([(0, 4), (6, 10)], [(3, 7), (9, 20)]) == [(3, 4), (6, 7), (9, 10)]
    assert subtract([(0, 10), (12, 14)], [(2, 3), (5, 13)]) == [(0, 2), (3, 5), (13, 14)]


def test_new_readers_on_synthetic_records():
    rec = _records()
    # own work: windows [0, 20] less the wait [4, 10] less the stall [2, 4]
    # = [0, 2] + [10, 20]: 12 ms over 2 steps
    assert _reader("engine_host_ms.train").read(rec) == pytest.approx(6.0)
    # of which idle: [12, 15]
    assert _reader("host_idle_ms.train").read(rec) == pytest.approx(1.5)
    assert _reader("optimizer_ms.train").read(rec) == pytest.approx(3.0)
    # 30 ms of event work over the one worker event inside the window
    assert _reader("event_stall_ms.train").read(rec) == pytest.approx(30.0, rel=1e-6)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_none_without_their_records(name):
    reader = _reader(name)
    rec = _records()
    assert reader.read({}) is None
    for key in ("program", "host_spans", "idle"):
        rec["stretch"].pop(key, None)
        rec.pop(key, None)
    assert reader.read(rec) is None


def test_no_event_and_no_window_span_read_none():
    rec = _records()
    rec["program"]["spans"] = [s for s in rec["program"]["spans"] if s["name"] != "worker.event"]
    rec["stretch"]["host_spans"] = [s for s in rec["stretch"]["host_spans"] if s[0] != "engine.window"]
    assert _reader("event_stall_ms.train").read(rec) is None
    assert _reader("engine_host_ms.train").read(rec) is None
    assert _reader("host_idle_ms.train").read(rec) is None


@pytest.mark.parametrize("name", OLD)
def test_existing_readers_ignore_the_new_keys(name):
    rec = _records()
    bare = _records()
    del bare["program"], bare["stretch"]["host_spans"], bare["stretch"]["idle"]
    reader = _reader(name)
    assert reader.read(rec) is not None and reader.read(rec) == reader.read(bare)


class _Event:
    def __init__(self, name, start, end, cuda=False, kind=None, annotation=False, tid=7):
        self._v = (name, start, end, cuda, kind, annotation, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._v[3] else torch.autograd.DeviceType.CPU

    def activity_type(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def device_resource_id(self):
        return self._v[6]


def _reduce(events):
    stretch = tracing.Stretch()
    stretch._prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: events)))
    stretch.steps = 2
    return stretch.reduce()


def test_reduce_keeps_its_keys_and_adds_the_spans_and_idle():
    base = [
        _Event(tracing.MARK, 100, 1100, annotation=True, kind="user_annotation"),
        _Event(tracing.MARK, 100, 1100, cuda=True, kind="gpu_user_annotation"),
        _Event("k1", 150, 400, cuda=True, kind="kernel"),
        _Event("k2", 350, 600, cuda=True, kind="kernel"),
        _Event("Memcpy DtoH", 800, 900, cuda=True, kind="gpu_memcpy"),
        _Event("cudaGraphLaunch", 590, 700, kind="cuda_runtime"),
        _Event("Command Buffer Full", 620, 690, kind="cuda_runtime"),
    ]
    spans = [
        _Event("engine.window", 50, 1200, annotation=True, kind="user_annotation"),
        _Event("engine.window", 50, 1200, cuda=True, kind="gpu_user_annotation"),
        _Event("engine.dispatch", 580, 720, annotation=True, kind="user_annotation"),
        _Event("engine.drain.wait", 720, 1000, annotation=True, kind="user_annotation"),
    ]
    bare, traced = _reduce(base), _reduce(base + spans)
    new = {"host_spans", "idle"}
    assert {k: v for k, v in traced.items() if k not in new} == \
        {k: v for k, v in bare.items() if k not in new}
    assert bare["idle"] == traced["idle"] == [[0, 50], [500, 700], [800, 1000]]
    assert bare["host_spans"] == [["Command Buffer Full", 520, 590, 7]]
    assert sorted(s[0] for s in traced["host_spans"]) == [
        "Command Buffer Full", "engine.dispatch", "engine.drain.wait", "engine.window"]
    assert bare["busy_s"] == pytest.approx(550e-9)
