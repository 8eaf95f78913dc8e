"""Fixtures of the benchmark's CPU tests: the import path, and a copy of
the benchmark cut to sizes a test can hold (a few rows, batch 4), run on
the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_copy(dest: Path) -> Path:
    """A checkout-like directory with ``BENCHMARK.json`` and a copy of
    ``benchmark/`` at test sizes; returns its root."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for f in (dest / "benchmark/configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["data"]["rows"] = 64
        c["compute"] = "f32"
        f.write_text(json.dumps(c))
    for f in (dest / "benchmark/traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update(batch_size=4, chain=4, profile_windows=1)
        f.write_text(json.dumps(t))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    import torch

    torch.set_num_threads(4)
    return small_copy(tmp_path_factory.mktemp("bench"))


def run_cell(root: Path, cell: str, seed: int = 2 ** 31 + 12345, seconds: float = 1.0, trace: int = 0,
             fault=None) -> dict:
    import run

    return run.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                    "--trace", str(trace)], root=root, device="cpu", fault=fault)
