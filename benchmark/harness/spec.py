"""The benchmark's parts, found by name.

``BENCHMARK.json`` at the checkout's root names the cells; each cell names
a configuration and a traffic mix.  Everything else is found from those
names, so a later change adds a part by adding files:

- ``configs/<config>.json``: the configuration's sizes;
- ``reference/<config>.py``: its plain PyTorch reference;
- ``traffic/<traffic>.json``: the traffic mix, whose ``driver`` names
  ``drivers/<driver>.py``;
- ``metrics/<metric>.py``: one per-layer metric's reader.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_module(path: Path, name: str) -> ModuleType:
    """Import the Python file ``path`` as a module called ``name`` (file
    names may hold dots, which ``import`` cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "configs" / f"{name}.json"


def traffic_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "traffic" / f"{name}.json"


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "metrics" / f"{name}.py"


def reference_file(config_name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "reference" / f"{config_name}.py"


def program_file(config_name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "programs" / f"{config_name}.py"


def limits_file(cell_name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "limits" / f"{cell_name}.json"


def driver_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "drivers" / f"{name}.py"


def metrics_of_cell(entries: List[dict], cell: str) -> List[dict]:
    """The metrics of ``entries`` that ``cell`` reports: those that list
    it under ``workloads``, and those that list no cells."""
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def cell(name: str, root: Path = ROOT, bench_dir: Optional[Path] = None) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its
    configuration, its traffic and the metrics it reports."""
    bench_dir = bench_dir or root / "benchmark"
    spec = benchmark(root)
    found = [w for w in spec["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[w['name'] for w in spec['workloads']]}")
    w = found[0]
    return Cell(
        name=name,
        config_name=w["config"],
        traffic_name=w["traffic"],
        chips=int(w["chips"]),
        config=read_json(config_file(w["config"], bench_dir)),
        traffic=read_json(traffic_file(w["traffic"], bench_dir)),
        end_to_end=metrics_of_cell(spec["end_to_end"], name),
        per_layer=metrics_of_cell(spec["per_layer"], name),
    )


def readers(metrics: List[dict], bench_dir: Path = BENCH_DIR) -> Dict[str, ModuleType]:
    """Each per-layer metric's reader module, by metric name."""
    return {m["name"]: load_module(metric_file(m["name"], bench_dir), f"bench_metric_{i}")
            for i, m in enumerate(metrics)}


def reference(config_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(reference_file(config_name, bench_dir), f"bench_reference_{config_name}")


def driver(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(driver_file(name, bench_dir), f"bench_driver_{name}")


def program(config_name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    return load_module(program_file(config_name, bench_dir), f"bench_program_{config_name}")


def limits(cell_name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The limit of each number the cell compares."""
    return read_json(limits_file(cell_name, bench_dir))["limits"]
