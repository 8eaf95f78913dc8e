"""Port bf16 compute against the JAX package's bf16 compute.

The same numpy-seeded flax variables go into the JAX models built with
``dtype=jnp.bfloat16`` and, through ``eadgan_tpu_torch.interop.from_jax``
(parameters are float32 in both packages), into the port's models built
with ``dtype=torch.bfloat16``.  Batch 2 on the CPU.

``tests/test_bf16.py`` holds the JAX bf16 path against its own float32
path at 0.05-0.08.  Port against JAX, both in bf16, agree far closer,
and the bars below are tight enough that the port's float32 path fails
them (measured values in brackets, float32 path in braces):

* G output: max |diff| 1.6e-2, two bf16 steps at |x| <= 1 [7.8e-3
  {8.2e-3}]; mean |diff| 1e-3 [3.4e-4 {1.2e-3}]; at least 30% of the
  pixels equal bit for bit [59% {0%}]; every value on the bf16 grid.
* G BatchNorm running statistics after the apply: 1e-5 [2.4e-6
  {3.5e-5}]; they are float32 sums of the same bf16 activations.
* D outputs: 1e-3 [2.4e-4]; ``cont`` on the bf16 grid and at least 30%
  of it equal bit for bit [62% {0%}].  Spectral-norm ``u``/``sigma``:
  1e-5 [3e-7]; the power step runs in float32 on both sides.
* Step losses with the same ``fixed=`` draws: rtol 2e-3 at step 0 [8.5e-5]
  and 1e-2 over 3 steps at the low-lr config [7.5e-4]; each Adam step
  moves parameters by about lr * sign(g), and gradients near zero can
  take opposite signs in the two frameworks' bf16 backward passes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.models import CelebaDiscriminator as JaxD
from eadgan_tpu.models import CelebaGenerator as JaxG
from eadgan_tpu.train.config import CelebaConfig as JaxConfig
from eadgan_tpu.train.gan_celeba import make_celeba_gan_step as jax_make_step
from eadgan_tpu_torch.interop import celeba_discriminator_from_flax, celeba_generator_from_flax
from eadgan_tpu_torch.models import CelebaDiscriminator, CelebaGenerator
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

from tests.test_torch_port_models_celeba import celeba_flax_variables
from tests.test_torch_port_step_celeba import LOW_LR, _jax_state

B = 2
F32 = np.dtype("float32")


@pytest.fixture(scope="module")
def variables():
    return celeba_flax_variables(0)


def _leaf_dtypes(tree):
    return {np.dtype(np.asarray(leaf).dtype) for leaf in jax.tree_util.tree_leaves(tree)}


def _on_bf16_grid(x: np.ndarray) -> bool:
    return np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)


def _all_f32(module):
    return {t.dtype for t in [*module.parameters(), *module.buffers()] if t.is_floating_point()}


def test_generator_bf16_matches_jax_bf16(variables):
    g_vars, _ = variables
    rng = np.random.default_rng(1)
    z = rng.standard_normal((B, 200)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
    code = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    ref, upd = JaxG(dtype=jnp.bfloat16).apply(g_vars, z, labels, code, mutable=["batch_stats"])
    ref = np.asarray(ref)
    assert ref.dtype == F32 and _leaf_dtypes(upd["batch_stats"]) == {F32}

    g = CelebaGenerator(dtype=torch.bfloat16)
    g.load_state_dict(celeba_generator_from_flax(g_vars))
    g.train()
    with torch.no_grad():
        got = g(*map(torch.from_numpy, (z, labels, code)))
    assert got.dtype == torch.float32 and _all_f32(g) == {torch.float32}
    got = got.permute(0, 2, 3, 1).numpy()
    diff = np.abs(got - ref)
    assert diff.max() <= 1.6e-2 and diff.mean() <= 1e-3, (diff.max(), diff.mean())
    assert np.mean(diff == 0) >= 0.3
    assert _on_bf16_grid(got)
    for i, seq in enumerate((2, 5, 8)):
        bn = upd["batch_stats"][f"TorchBatchNorm_{i}"]["BatchNorm_0"]
        layer = g.conv_blocks[seq]
        np.testing.assert_allclose(layer.running_mean.numpy(), np.asarray(bn["mean"]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(layer.running_var.numpy(), np.asarray(bn["var"]), rtol=0, atol=1e-5)


def test_discriminator_bf16_matches_jax_bf16(variables):
    _, d_vars = variables
    img = np.random.default_rng(2).uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    ref, upd = JaxD(dtype=jnp.bfloat16).apply(d_vars, img, mutable=["batch_stats"])
    assert _leaf_dtypes(upd["batch_stats"]) == {F32}

    d = CelebaDiscriminator(dtype=torch.bfloat16)
    d.load_state_dict(celeba_discriminator_from_flax(d_vars))
    d.train()
    with torch.no_grad():
        got = d(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
    assert _all_f32(d) == {torch.float32}
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-3)
    cont = got[1].numpy()
    assert _on_bf16_grid(cont)
    assert np.mean(cont == np.asarray(ref[1])) >= 0.3
    for i, seq in enumerate((0, 2, 4, 6)):
        sn = upd["batch_stats"][f"SNConv_{i}"]["SpectralNorm_0"]
        layer = d.main[seq]
        np.testing.assert_allclose(
            layer.u.numpy(), np.asarray(sn["Conv_0/kernel/u"])[0], rtol=0, atol=1e-5
        )
        np.testing.assert_allclose(
            layer.sigma.numpy(), np.asarray(sn["Conv_0/kernel/sigma"]), rtol=0, atol=1e-5
        )


def test_bf16_step_matches_jax_bf16():
    seed, steps = 1, 3
    g_vars, d_vars = celeba_flax_variables(seed)
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    draws = [
        {
            "z": rng.standard_normal((B, 200)).astype(np.float32),
            "sampled_labels": rng.integers(0, 10, B).astype(np.int32),
            "code": rng.uniform(-1, 1, (B, 8)).astype(np.float32),
        }
        for _ in range(steps)
    ]

    jax_config = JaxConfig(batch_size=B, **LOW_LR)
    jstep = jax_make_step(JaxG(dtype=jnp.bfloat16), JaxD(dtype=jnp.bfloat16), jax_config)
    jstate = _jax_state(jax_config, g_vars, d_vars)
    jax_losses = []
    for fixed in draws:
        jstate, m = jstep(jstate, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in fixed.items()})
        jax_losses.append({k: float(v) for k, v in m.items()})

    config = CelebaConfig(batch_size=B, **LOW_LR)
    state = init_celeba_gan_state(config, device="cpu", seed=0, dtype=torch.bfloat16)
    state.g.load_state_dict(celeba_generator_from_flax(g_vars))
    state.d.load_state_dict(celeba_discriminator_from_flax(d_vars))
    step = make_celeba_gan_step(config)
    for s, fixed in enumerate(draws):
        state, m = step(state, torch.from_numpy(imgs), fixed)
        rtol = 2e-3 if s == 0 else 1e-2
        for k, ref in jax_losses[s].items():
            got = float(m[k])
            assert m[k].dtype == torch.float32 and np.isfinite(got)
            np.testing.assert_allclose(got, ref, rtol=rtol, err_msg=f"step {s} {k}")
    assert state.step == steps
    assert _all_f32(state.g) == _all_f32(state.d) == {torch.float32}
    for opt in (state.opt_g, state.opt_d, state.opt_info):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert _leaf_dtypes(jstate.g.stats) == _leaf_dtypes(jstate.d.stats) == {F32}
