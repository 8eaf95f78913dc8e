"""The benchmark's files: every configuration, traffic mix, cell and
metric loads by name, names and units keep to the allowed characters,
nothing the runs load belongs to the JAX stack or package, and a part
added as a file is found without editing code."""

import json
import re
import shutil
import subprocess
import sys

from conftest import BENCH, ROOT, run_cell

from harness import output, spec

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE_RE = re.compile(r"^[^\t\n]{1,200}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def test_benchmark_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and all(PATH_RE.match(p) for p in SPEC["paths"])
    assert 1 <= SPEC["run_seconds"] <= 51 and len(SPEC["command"]) <= 32
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in SPEC[group]]
        assert len(group_names) == len(set(group_names)), group
    for n in names:
        assert spec.NAME_RE.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert spec.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE_RE.match(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in SPEC["workloads"]:
        assert LINE_RE.match(w["why"]) and w["chips"] in (1, 4)
        assert spec.NAME_RE.match(w["traffic"]) and spec.NAME_RE.match(w["config"])
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_part_loads_by_name(small_root):
    for w in json.loads((small_root / "BENCHMARK.json").read_text())["workloads"]:
        cell = spec.cell(w["name"], small_root)
        assert cell.driver == "train"
        assert spec.driver_file(cell.driver).exists()
        assert spec.reference_file(cell.config_name).exists()
        assert spec.program_file(cell.config_name).exists()
        assert spec.limits(cell.name)
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert len(cell.end_to_end) >= 2
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert all(spec.NAME_RE.match(k) for k in c["reduced"])
    readers = spec.readers(SPEC["per_layer"])
    for name, module in readers.items():
        assert module.read({}) is None, name  # nothing to read: no number


def test_forbidden_modules_compare_whole_top_level_names():
    assert output.forbidden_modules(["eadgan_tpu_torch", "eadgan_tpu_torch.ops", "jaxtyping"]) == []
    assert output.forbidden_modules(["jax.numpy", "eadgan_tpu.ops", "flax", "optax"]) == [
        "eadgan_tpu.ops", "flax", "jax.numpy", "optax"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]; from harness import spec; "
            "[spec.reference(c) for c in ('celeba', 'dsprites_rp')]; "
            "bad = sorted({n.split('.')[0] for n in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'optax', 'eadgan_tpu', 'eadgan_tpu_torch'}); print(bad)"
            % str(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax(small_root):
    code = ("import sys; sys.path[:0] = [%r, %r]; import conftest, torch; "
            "from pathlib import Path; "
            "conftest.run_cell(Path(%r), 'dsprites_rp.train.b128', seconds=0.5); "
            "from harness import output; print(output.forbidden_modules())"
            % (str(BENCH / "tests"), str(BENCH), str(small_root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_metric_and_a_cell_added_as_files_are_found(small_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(small_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    (root / "benchmark/metrics/window_steps.train.py").write_text(
        "def read(rec):\n    w = rec.get('window')\n    return w['steps'] if w else None\n")
    bench["per_layer"].append({"name": "window_steps.train", "unit": "steps", "better": "higher",
                               "source": "host_clock", "layer": "chained engine",
                               "moves": "train_img_per_s", "workloads": ["dsprites_rp.train.b8"]})
    traffic = json.loads((root / "benchmark/traffic/train.b128.json").read_text())
    traffic["batch_size"] = 8
    (root / "benchmark/traffic/train.b8.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/dsprites_rp.train.b128.json",
                root / "benchmark/limits/dsprites_rp.train.b8.json")
    bench["workloads"].append({"name": "dsprites_rp.train.b8", "config": "dsprites_rp",
                               "traffic": "train.b8", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "dsprites_rp.train.b128" in m.get("workloads", []):
            m["workloads"].append("dsprites_rp.train.b8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run_cell(root, "dsprites_rp.train.b8", seconds=1.0, trace=1)
    assert line["correct"] and line["metrics"]["window_steps.train"][0] > 0
