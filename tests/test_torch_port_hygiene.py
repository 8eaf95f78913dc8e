"""The port stands alone: no JAX, no JAX package, no msgpack (the card's
machine has none: the port reads and writes flax msgpack with its own
codec, ``interop/flax_msgpack.py``), no quiet CPU fallback, and no build
when a module is imported."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state
from eadgan_tpu_torch.utils import platform_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "eadgan_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "eadgan_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PKG.rglob("*.py"))
    ]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _source_files():
    """Every source of the port, Python and C++, and chip_smoke.py."""
    return _port_files() + sorted(
        p for ext in ("*.cu", "*.cuh", "*.cpp") for p in (PKG / "csrc").rglob(ext)
    )


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_sklearn_import_in_source(path):
    """The card's machine has no scikit-learn: DCI's regressors are the
    port's own heads (``eval/heads.py``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module]
        else:
            continue
        assert not [n for n in names if n == "sklearn" or n.startswith("sklearn.")], (
            f"{path}:{node.lineno} imports scikit-learn"
        )


@pytest.mark.parametrize("path", _source_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_under_the_jax_native_dir(path):
    """The port builds its own batcher (``csrc/batcher.cpp``): no source
    names a path under the JAX package's ``native/`` directory."""
    text = path.read_text()
    assert not re.search(r"(^|[^\w])native/", text), f"{path} names a path under native/"
    if path.suffix == ".py":
        literals = [n.value for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Constant)]
        assert "native" not in literals, f"{path} joins a path through native/"


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter imports every port module and chip_smoke.py;
    none of them may pull in a forbidden module."""
    code = f"""
import importlib, importlib.util, sys
before = set(sys.modules)
for name in {_modules()!r}:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", {str(ROOT / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
new = set(sys.modules) - before
bad = sorted(m for m in new if any(m == f or m.startswith(f + ".") for f in {FORBIDDEN!r}))
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_card_raises_instead_of_falling_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_celeba_gan_state(CelebaConfig())
    monkeypatch.delenv("EADGAN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform_device()
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    assert platform_device() == torch.device("cpu")
    monkeypatch.setenv("EADGAN_PLATFORM", "tpu")
    with pytest.raises(ValueError):
        platform_device()


@pytest.mark.parametrize("module", ["dp_check", "tp_check"])
def test_parallel_checks_refuse_without_a_card(module):
    """The data- and model-axis checks run on the card unless asked for
    the CPU: without one they stop before any rank starts."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot show")
    main = importlib.import_module(f"eadgan_tpu_torch.tools.{module}").main
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Building happens at first launch, so the kernel modules import on
    a machine with no nvcc; asking for the library there raises."""
    code = """
import eadgan_tpu_torch.ops.stn_cuda as m
from eadgan_tpu_torch.ops import _build
try:
    _build.load_library()
except RuntimeError as e:
    print("RAISED", "nvcc not found" in str(e))
"""
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert "RAISED True" in out.stdout, out.stdout


def test_find_nvcc_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
