"""Port generator inference vs the JAX package: the BatchNorm fold, the
eval-mode and folded bf16 CelebA forwards, the inference grids and the
``gen_imgs`` CLI (``--quant none|bf16|int8``; the int8 forward itself is
held to the JAX package in ``tests/test_torch_port_quant.py``).

The CelebA generator's flax variables (numpy-seeded, BatchNorm scales,
biases and running statistics perturbed away from their defaults) go
into both packages through ``interop/from_jax.py``.  Tolerances:

* the fold: rtol 1e-6 (the same float32 products and one square root
  on both sides);
* the float32 eval-mode forward against ``CelebaGenerator.apply(
  train=False)`` at batch 4: rtol 1e-4, atol 1e-5 (sums of up to 16,384
  terms in other orders);
* the folded bf16 forward against JAX's ``make_celeba_infer(
  quant="none")``: 2e-2 absolute on tanh outputs in [-1, 1], the bar of
  the existing bf16 comparisons.  Both round every layer's input and
  weight to bf16 and accumulate in float32; torch also rounds each
  convolution's output to bf16 before the float32 bias, where JAX keeps
  it in float32 (measured 2.0e-4 at these weights);
* the grids: the same PNG bytes for the same ``apply``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.models import CelebaGenerator as JaxG
from eadgan_tpu.ops.quant import fold_celeba_generator_bn as jax_fold
from eadgan_tpu.ops.quant import make_celeba_infer as jax_make_infer
from eadgan_tpu.sample import figures as jax_figures
from eadgan_tpu_torch.cli import celeba, gen_imgs
from eadgan_tpu_torch.interop.from_jax import celeba_generator_from_flax, conv_transpose_kernel
from eadgan_tpu_torch.models import CelebaGenerator
from eadgan_tpu_torch.ops import quant
from eadgan_tpu_torch.ops.quant import fold_celeba_generator_bn, make_celeba_infer
from eadgan_tpu_torch.sample import figures

from tests.test_torch_port_models_celeba import celeba_flax_variables
from tests.test_torch_port_jax_files import drop_big_files

B = 4


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.fixture(scope="module")
def g_variables():
    return celeba_flax_variables(3)[0]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((B, 200)).astype(np.float32),
        np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)],
        rng.uniform(-1, 1, (B, 8)).astype(np.float32),
    )


def test_fold_matches_jax(g_variables):
    ref = jax_fold(g_variables)
    got = fold_celeba_generator_bn(celeba_generator_from_flax(g_variables))
    assert len(got) == len(ref) == 5
    for i, ((w, b), layer) in enumerate(zip(got, ref)):
        np.testing.assert_allclose(
            w.numpy(), conv_transpose_kernel(np.asarray(layer["kernel"])).numpy(), rtol=1e-6,
            atol=1e-9, err_msg=f"layer {i} weight")
        np.testing.assert_allclose(b.numpy(), np.asarray(layer["bias"]), rtol=1e-6, atol=1e-9,
                                   err_msg=f"layer {i} bias")


def test_eval_forward_matches_jax(g_variables):
    z, label, code = _inputs()
    ref = np.asarray(JaxG().apply(g_variables, jnp.asarray(z), jnp.asarray(label),
                                  jnp.asarray(code), train=False))
    model = CelebaGenerator()
    model.load_state_dict(celeba_generator_from_flax(g_variables))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, (z, label, code))).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_folded_f32_equals_eval_forward(g_variables):
    """In float32 the fold is the eval-mode forward."""
    sd = celeba_generator_from_flax(g_variables)
    model = CelebaGenerator()
    model.load_state_dict(sd)
    x = tuple(map(torch.from_numpy, _inputs(1)))
    with torch.no_grad():
        ref = model.eval()(*x)
    got = make_celeba_infer(sd, quant="none", compute_dtype=torch.float32)(*x)
    assert got.dtype == torch.float32 and got.shape == (B, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_folded_bf16_matches_jax(g_variables):
    z, label, code = _inputs(2)
    ref = np.asarray(jax_make_infer(g_variables, quant="none")(z, label, code))
    fwd = make_celeba_infer(celeba_generator_from_flax(g_variables), quant="none",
                            compute_dtype=torch.bfloat16)
    got = fwd(*map(torch.from_numpy, (z, label, code)))
    assert got.dtype == torch.float32
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2)


def _apply(z, label, code):
    """A deterministic stand-in generator: NHWC images from the inputs."""
    s = z.sum(-1) * 0.01 + label.argmax(-1) * 0.1 + code.sum(-1)
    h = np.linspace(-1, 1, 32, dtype=np.float32)
    img = np.tanh(s[:, None, None] + h[None, :, None] * h[None, None, :])
    return img[..., None].astype(np.float32)


@pytest.mark.parametrize("name,grids", [("mnist_inference_grids", 7),
                                        ("celeba_inference_grids", 8)])
def test_inference_grids_equal_jax_png_bytes(tmp_path, name, grids):
    getattr(figures, name)(_apply, str(tmp_path / "port"), 3)
    getattr(jax_figures, name)(_apply, str(tmp_path / "jax"), 3)
    for k in range(1, grids + 1):
        a = (tmp_path / "port" / f"varying_c{k}" / "3.png").read_bytes()
        assert a == (tmp_path / "jax" / f"varying_c{k}" / "3.png").read_bytes(), k
    assert not (tmp_path / "port" / f"varying_c{grids + 1}").exists()


def test_mnist_training_grids_equal_jax_png_bytes(tmp_path):
    rng = np.random.default_rng(0)
    real, scaled = (rng.uniform(-1, 1, (100, 32, 32, 1)).astype(np.float32) for _ in range(2))
    figures.mnist_training_grids(_apply, real, scaled, str(tmp_path / "port"), 4)
    jax_figures.mnist_training_grids(_apply, real, scaled, str(tmp_path / "jax"), 4)
    names = ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 8)]
    for n in names:
        assert (tmp_path / "port" / n / "4.png").read_bytes() == (
            tmp_path / "jax" / n / "4.png").read_bytes(), n


def test_gen_imgs_reads_a_celeba_run(tmp_path, monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_N", "8")
    celeba.main([
        "--batch_size", "4", "--max_steps", "1", "--sample_interval", "1000",
        "--data_dir", str(tmp_path), "--out_dir", str(tmp_path / "images"),
        "--ckpt_dir", str(tmp_path),
    ])
    ckpt = tmp_path / "checkpoint_0.tar"
    assert ckpt.is_file()
    launches = []
    monkeypatch.setattr(quant, "int8_convt_relu_plain",
                        _counting(quant.int8_convt_relu_plain, launches, "int8_convt"))
    monkeypatch.setattr(quant, "quantize_activation_plain",
                        _counting(quant.quantize_activation_plain, launches, "quantize_int8"))
    for mode in ("none", "bf16", "int8"):
        out = tmp_path / mode
        gen_imgs.main(["--checkpoint", str(ckpt), "--out_dir", str(out), "--quant", mode])
        for k in range(1, 9):
            assert (out / f"varying_c{k}" / "0.png").is_file(), (mode, k)
        assert not (out / "varying_c9").exists()
    # 8 forwards of batch 100, each through the three int8 layers
    assert launches.count("int8_convt") == launches.count("quantize_int8") == 24


def _counting(fn, calls, name):
    def wrapped(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    return wrapped
