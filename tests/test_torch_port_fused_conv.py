"""Port fused conv k4 s2 p1 + bias + LeakyReLU against the JAX tool's
Pallas kernel.

The same numpy arrays (drawn as ``tools/fused_conv_probe.py`` draws them,
rounded to bf16) go into ``tools/fused_conv_probe.py::fused_conv_lrelu_pallas``,
which runs in Pallas interpret mode on the CPU exactly as that tool runs
it there, and into the port's ``ops.fused_conv_lrelu``, which on a CPU
tensor runs the plain version.

Tolerance: the largest difference below 2e-2 of max(1, max |ref|), the
JAX tool's own bar, and per element two bf16 steps of |ref| plus 1e-3 of
max |ref| (``ops.fused_conv.mismatch``).  Both sides take bf16 taps,
accumulate in float32 and round once to bf16, so they differ only where
the float32 sums, taken in other orders, round to neighbouring bf16
values: one bf16 step (measured at full width: 3.1e-2 at max |ref| 9.75,
rel 3.2e-3, 0.42 of the per-element bar; the Pallas and XLA versions
differ by 1.6e-2 between themselves; the two small shapes agree exactly).
A bias left out or taken from another channel puts the per-element ratio
at 3.4 to 9.6 with the probe's small bias, and both measures far over
their bars with a bias as large as the conv output.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu_torch.ops import fused_conv_cuda, fused_conv_lrelu, fused_conv_lrelu_plain
from eadgan_tpu_torch.ops.fused_conv import mismatch
from tools.fused_conv_probe import fused_conv_lrelu_pallas, xla_conv_lrelu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(batch, hw, cin, cout, seed=0, bias=0.01):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, hw, hw, cin))
    w = 0.05 * rng.standard_normal((4, 4, cin, cout))
    b = bias * rng.standard_normal((cout,))
    # one rounding to bf16, then the same values to both packages
    return [np.asarray(jnp.asarray(a, jnp.bfloat16)) for a in (x, w, b)]


def _torch(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize(
    "batch,hw,cin,cout",
    [(2, 8, 16, 32), (2, 8, 16, 40), (2, 32, 128, 256)],
    ids=["small", "cout40", "full_width"],
)
def test_matches_pallas_interpret(batch, hw, cin, cout, monkeypatch):
    def no_card(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA wrapper")

    monkeypatch.setattr(fused_conv_cuda, "fused_conv_lrelu_cuda", no_card)
    before = fused_conv_cuda.launch_count
    x, w, b = _inputs(batch, hw, cin, cout)
    ref = np.asarray(fused_conv_lrelu_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = fused_conv_lrelu(_torch(x), _torch(w), _torch(b))
    assert fused_conv_cuda.launch_count == before
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == ref.shape == (batch, hw // 2, hw // 2, cout)
    diff = mismatch(got, torch.from_numpy(ref.astype(np.float32)))
    assert diff["rel"] < 2e-2 and diff["elem"] <= 1.0, diff

    # the JAX tool's XLA yardstick agrees with the port's plain version too
    xla = np.asarray(xla_conv_lrelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), np.float32)
    diff = mismatch(got, torch.from_numpy(xla))
    assert diff["rel"] < 2e-2 and diff["elem"] <= 1.0, diff


def test_matches_pallas_interpret_large_bias():
    """A bias as large as the conv output, per channel: the bias's channel
    order and its place before the LeakyReLU show in every element."""
    x, w, b = _inputs(2, 8, 16, 40, bias=1.0)
    ref = np.asarray(fused_conv_lrelu_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = fused_conv_lrelu(_torch(x), _torch(w), _torch(b))
    diff = mismatch(got, torch.from_numpy(ref.astype(np.float32)))
    assert diff["rel"] < 2e-2 and diff["elem"] <= 1.0, diff


@pytest.mark.parametrize("bias", [0.01, 1.0])
def test_bar_rejects_a_wrong_bias(bias):
    """The bar the kernel is held to on the card fails a result that left
    the bias out or read the next 8-channel group's, at the probe's small
    bias too; the right result passes it."""
    x, w, b = (_torch(a) for a in _inputs(2, 32, 128, 256, bias=bias))
    ref = fused_conv_lrelu_plain(x, w, b)
    assert mismatch(fused_conv_lrelu_plain(x, w, b), ref)["elem"] == 0.0
    for wrong in (torch.zeros_like(b), b.roll(8)):
        diff = mismatch(fused_conv_lrelu_plain(x, w, wrong), ref)
        assert diff["elem"] > 2.0, diff
        if bias == 1.0:
            assert diff["rel"] > 0.1, diff


def test_plain_version_computes_in_float32():
    """float32 inputs stay float32 (one rounding at the end), and a slope
    other than 0.1 is honoured."""
    x, w, b = (torch.from_numpy(a.astype(np.float32)) for a in _inputs(1, 6, 8, 8, seed=3))
    out = fused_conv_lrelu_plain(x, w, b, slope=0.2)
    conv = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, stride=2, padding=1
    ).permute(0, 2, 3, 1)
    torch.testing.assert_close(out, torch.nn.functional.leaky_relu(conv, 0.2), rtol=1e-6, atol=1e-6)
    assert out.dtype == torch.float32


def test_cuda_wrapper_rejects_cpu_tensors():
    x, w, b = (_torch(a) for a in _inputs(1, 8, 8, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_conv_cuda.fused_conv_lrelu_cuda(x, w, b)


def test_probe_runs_on_cpu(tmp_path):
    out = tmp_path / "probe.json"
    env = dict(os.environ, EADGAN_PLATFORM="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "eadgan_tpu_torch.tools.fused_conv_probe", "--batch", "2",
         "--hw", "8", "--cin", "16", "--cout", "32", "--steps", "2", "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    record = json.loads(proc.stdout.strip().splitlines()[-1])
    assert record == json.loads(out.read_text())
    assert set(record) == {
        "shape", "device", "timing", "max_abs_err", "rel", "plain_max_abs_err", "plain_elem",
        "library_conv_only",
        "library_conv_bias_lrelu", "plain_fused", "elementwise_fusion_delta_ms",
        "bytes_gb", "gflop",
    }
    assert record["device"] == "cpu" and record["timing"] == "host_clock"
    assert record["shape"] == [2, 8, 8, 16, 32] and record["rel"] < 2e-2
    # on the CPU the fused call is the plain version itself
    assert record["plain_max_abs_err"] == 0.0 and record["plain_elem"] == 0.0
    # 2 * M * N * K and each tensor once, in bf16
    assert record["gflop"] == pytest.approx(2 * 2 * 16 * 32 * 256 / 1e9)
    assert record["bytes_gb"] == pytest.approx(2 * (2 * 64 * 16 + 16 * 16 * 32 + 32 + 2 * 16 * 32) / 1e9)
