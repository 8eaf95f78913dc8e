"""Room for a configuration at its own image size, added as files only:
the stand-in data at the configuration's ``model.img_size``, each
kernel's work by name (``records["work"]``), the Adam's bound against the
hand count, and each optimizer's own ``b1``."""

import hashlib
import json
import shutil
import types

import numpy as np
import pytest
import torch

from conftest import BENCH, run_cell

from counts.adam import BYTES_PER_ELEMENT, adam_elements, adam_work
from harness import compare, datasets, peaks, spec
from harness.rooflines import kernel_roofline
from harness.seeds import derive

SEED = 2 ** 31 + 777
# sha256 of the makers' output at 64 on the CPU before a maker took a size
PINNED = {
    "faces": "a9f6b903549a128c0ffa45950a207761250ec34071a65bed39ee6edd1edb3653",
    "sprites": "5b74f2144af048bfc522d5f4d4c0102d5fc5c03ab6e1e2d9258b5c63e7189294",
}


@pytest.mark.parametrize("maker", sorted(PINNED))
def test_makers_at_64_are_byte_equal_to_before(maker):
    rows = datasets.make({"maker": maker, "rows": 300}, SEED, "cpu", 64)
    assert hashlib.sha256(rows.tobytes()).hexdigest() == PINNED[maker]


def test_faces_at_128_come_from_the_same_draws():
    small = datasets.faces(300, SEED, "cpu", 64)
    large = datasets.faces(300, SEED, "cpu", 128)
    assert large.shape == (300, 128, 128, 3) and large.dtype == np.uint8
    # every draw is in units of the size: the even pixels at 128 sit where
    # the pixels at 64 do, and read the same
    assert np.array_equal(large[:, ::2, ::2], small)


def test_sprites_refuse_another_size():
    with pytest.raises(ValueError, match="64x64"):
        datasets.make({"maker": "sprites", "rows": 4}, SEED, "cpu", 128)


def _add_config(root, name, base, model=None, optimizer=None):
    """A configuration ``name`` in the copy ``root`` as new files only:
    ``base``'s configuration (with ``model`` and ``optimizer`` updated),
    reference, program and limits under the new name, a cell
    ``<name>.train.b128`` and that cell in the lists of the metrics that
    list ``base``'s cell."""
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / f"{base}.json").read_text())
    cfg["name"] = name
    cfg["model"].update(model or {})
    cfg["optimizer"].update(optimizer or {})
    (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for part in ("reference", "programs"):
        shutil.copy(bench / part / f"{base}.py", bench / part / f"{name}.py")
    cell, base_cell = f"{name}.train.b128", f"{base}.train.b128"
    shutil.copy(bench / "limits" / f"{base_cell}.json", bench / "limits" / f"{cell}.json")
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": name, "source": cfg["source"],
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "a test configuration"})
    spec_json["workloads"].append({"name": cell, "config": name, "traffic": "train.b128", "chips": 1,
                                   "why": "a test cell"})
    for m in spec_json["end_to_end"] + spec_json["per_layer"]:
        if base_cell in m.get("workloads", []):
            m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    return cell


class _Reached(Exception):
    """Raised in place of the engine's first call, carrying its arguments."""

    def __init__(self, kwargs):
        super().__init__("the driver reached the engine")
        self.kwargs = kwargs


def test_a_128_configuration_gets_its_data_from_the_driver(small_root, tmp_path, monkeypatch):
    root = tmp_path / "copy"
    shutil.copytree(small_root, root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cell = _add_config(root, "faces128", "celeba", model={"img_size": 128})
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing there was edited

    from eadgan_tpu_torch.train import engine

    def reached(**kwargs):
        raise _Reached(kwargs)

    monkeypatch.setattr(engine, "run_epochs", reached)
    seed = 2 ** 31 + 4321
    with pytest.raises(_Reached) as got:
        run_cell(root, cell, seed=seed)
    data = got.value.kwargs["data"]
    rows = spec.cell(cell, root).config["data"]["rows"]
    assert data.shape == (rows, 128, 128, 3)
    assert np.array_equal(data, datasets.faces(rows, derive(seed, "data"), "cpu", 128))


# a configuration's own kernels' work, its spans' readers and its Adams'
# b1s by name, each a new file: the reference and the program read the
# b1 map through compare.b1_of (the port's rp trainer takes one b1)
_REFERENCE = '''
from pathlib import Path

from harness import compare, spec
from reference import plain

_base = spec.load_module(Path(__file__).with_name("dsprites_rp.py"), "sprites_b1_reference")
globals().update({k: v for k, v in vars(_base).items() if not k.startswith("__")})


def optimizers(models, cfg):
    o = cfg["optimizer"]
    return {
        "opt_d": plain.adam(models["d"].parameters(), o["d_lr"], compare.b1_of(o["b1"], "opt_d"), o["b2"]),
        "opt_info": plain.adam([*models["g"].parameters(), *models["e"].parameters()], o["lr"],
                               compare.b1_of(o["b1"], "opt_info"), o["b2"]),
    }
'''
_PROGRAM = '''
from pathlib import Path

from harness import compare, spec

_base = spec.load_module(Path(__file__).with_name("dsprites_rp.py"), "sprites_b1_program")


class TrainProgram(_base.TrainProgram):
    def __init__(self, cfg, batch, weights, rng_seed, device):
        o = cfg["optimizer"]
        (b1,) = {compare.b1_of(o["b1"], n) for n in ("opt_d", "opt_info")}
        super().__init__(dict(cfg, optimizer=dict(o, b1=b1)), batch, weights, rng_seed, device)
'''
_COUNTS = '''
def kernel_work(ref, cfg, batch):
    return {"toy_kernel": {"ops": 3 * batch, "bytes": 5 * batch, "compute": "bf16"}}
'''
_READERS = {
    "toy_work.train": "def read(rec):\n    return rec['work']['toy_kernel']['bytes']\n",
    "adam_bytes.train": "def read(rec):\n    return rec['work']['adam_fused_kernel']['bytes']\n",
    "traced_windows.train": ("def read(rec):\n    p = rec.get('program')\n"
                             "    return p['counters'].get('engine.windows') if p else None\n"),
}


def test_work_spans_and_b1s_of_a_configuration_added_as_files(small_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(small_root, root)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    cell = _add_config(root, "sprites_b1", "dsprites_rp", optimizer={"b1": {"opt_d": 0.5, "opt_info": 0.5}})
    bench = root / "benchmark"
    (bench / "reference/sprites_b1.py").write_text(_REFERENCE)
    (bench / "programs/sprites_b1.py").write_text(_PROGRAM)
    (bench / "counts/sprites_b1.py").write_text(_COUNTS)
    spec_json = json.loads((root / "BENCHMARK.json").read_text())
    for name, code in _READERS.items():
        (bench / "metrics" / f"{name}.py").write_text(code)
        spec_json["per_layer"].append({"name": name, "unit": "n", "better": "higher",
                                       "source": "program_counter", "layer": "train step",
                                       "moves": "train_img_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec_json))
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing there was edited

    line = run_cell(root, cell, seconds=1.0, trace=1)
    assert line["correct"], line["checks"]
    got = {k: v[0] for k, v in line["metrics"].items()}
    batch = spec.cell(cell, root).traffic["batch_size"]
    assert got["toy_work.train"] == 5 * batch
    assert got["adam_bytes.train"] == BYTES_PER_ELEMENT * 842_057
    assert got["traced_windows.train"] > 0


def _params(*layers):
    """Parameters of weight-and-bias layers given as (fan_in, fan_out) or
    (cin, cout, k) for a k x k convolution, and ("bn", c)."""
    n = 0
    for layer in layers:
        if layer[0] == "bn":
            n += 2 * layer[1]
        elif len(layer) == 3:
            n += layer[0] * layer[1] * layer[2] ** 2 + layer[1]
        else:
            n += layer[0] * layer[1] + layer[1]
    return n


_TRUNK = [(1, 32, 4), (32, 32, 4), (32, 64, 4), (64, 64, 4)]
HAND = {
    # opt_g: G; opt_d: D; opt_info: G and D again
    "celeba": 2 * (14_591_619 + 11_329_427),
    # opt_d: D; opt_info: G and E
    "dsprites_rp": (_params(*_TRUNK, (1024, 128), (128, 1))
                    + _params((7, 128), (128, 1024), *[(64, 64, 4), ("bn", 64)] * 3, (64, 1, 4))
                    + _params(*_TRUNK, (1024, 128), (128, 128), (128, 3), (128, 4))),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_adam_work_is_the_hand_count(name):
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    ref = spec.reference(name)
    assert adam_elements(ref, cfg) == HAND[name]
    work = adam_work(ref, cfg)
    assert work["bytes"] == 28 * HAND[name] and work["compute"] == "f32"
    if name == "celeba":
        # 51.84 M elements, 1.4515 GB a step: 0.4333 ms at 3.35e12 B/s
        assert work["bytes"] == 1_451_578_576
        bound = peaks.bound_s(work["bytes"], work["ops"], peaks.F32_FLOPS_PER_S)
        assert bound * 1e3 == pytest.approx(0.4333, abs=5e-5)


def test_adam_roofline_reads_the_bound_over_the_kernels_time():
    work = {"adam_fused_kernel": {"ops": 13 * 1000, "bytes": 28 * 1000, "compute": "f32"}}
    stretch = {"steps": 4, "stretch_s": 1.0, "busy_s": 0.5,
               "kernel_s": {"(anonymous namespace)::adam_fused_kernel(AdamLaunch)": 2e-7, "other": 1.0},
               "kernel_count": {}}
    bound = 28 * 1000 / peaks.HBM_BYTES_PER_S
    assert kernel_roofline({"stretch": stretch, "work": work}, "adam_fused_kernel") == pytest.approx(
        100 * bound * 4 / 2e-7)
    assert kernel_roofline({"stretch": stretch}, "adam_fused_kernel") is None
    stretch["kernel_s"] = {"other": 1.0}
    assert kernel_roofline({"stretch": stretch, "work": work}, "adam_fused_kernel") is None


def _adam_states(b1s, steps=3, seed=5):
    """Host states after each of ``steps`` steps of one Adam a b1 in ``b1s``,
    each on a parameter of its own, and the gradients each took."""
    torch.manual_seed(seed)
    params = {o: torch.nn.Parameter(torch.zeros(6, 5)) for o in b1s}
    opts = {o: torch.optim.Adam([params[o]], lr=1e-3, betas=(b1, 0.999)) for o, b1 in b1s.items()}
    model = torch.nn.ParameterDict(params)
    grads = {o: [torch.randn(6, 5) for _ in range(steps)] for o in b1s}
    states = []
    for k in range(steps):
        for o, opt in opts.items():
            params[o].grad = grads[o][k].clone()
            opt.step()
        states.append(compare.host_state({"m": model}, opts))
    return states, grads


def test_step_grads_with_one_b1_in_a_map_reads_as_the_number():
    states, _ = _adam_states({"opt_a": 0.5, "opt_b": 0.5})
    assert compare.step_grads(states, {"opt_a": 0.5, "opt_b": 0.5}) == compare.step_grads(states, 0.5)


def test_step_grads_take_each_optimizers_own_b1():
    b1s = {"opt_a": 0.0, "opt_b": 0.5}
    states, grads = _adam_states(b1s)
    got = compare.step_grads(states, b1s)
    for o, b1 in b1s.items():
        leaf = f"m.{o}"
        for k, st in enumerate(states):
            m = st["adam"][o][leaf]["exp_avg"].double()
            prev = states[k - 1]["adam"][o][leaf]["exp_avg"].double() if k else torch.zeros_like(m)
            hand = float(((m - b1 * prev) / (1 - b1)).norm())
            assert got[k][o][leaf] == pytest.approx(hand, rel=1e-12)
            assert got[k][o][leaf] == pytest.approx(float(grads[o][k].norm()), rel=1e-5)
    # one b1 for both would read opt_a's gradients wrong
    wrong = compare.step_grads(states, 0.5)
    assert wrong[1]["opt_a"]["m.opt_a"] != pytest.approx(got[1]["opt_a"]["m.opt_a"], rel=1e-3)
    with pytest.raises(KeyError, match="opt_b"):
        compare.step_grads(states, {"opt_a": 0.0})


def test_the_reference_adams_are_held_to_the_configured_b1():
    cfg = json.loads((BENCH / "configs" / "dsprites_rp.json").read_text())
    ref = spec.reference("dsprites_rp")
    assert set(compare._optimizers(ref, ref.build(cfg, "meta"), cfg)) == {"opt_d", "opt_info"}
    w = torch.nn.Parameter(torch.zeros(3))
    stepped_at_0 = types.SimpleNamespace(
        optimizers=lambda models, cfg: {"opt_d": torch.optim.Adam([w], betas=(0.0, 0.999))})
    with pytest.raises(ValueError, match="opt_d"):
        compare._optimizers(stepped_at_0, {}, cfg)
    assert compare._optimizers(stepped_at_0, {}, dict(cfg, optimizer=dict(cfg["optimizer"], b1={"opt_d": 0})))
