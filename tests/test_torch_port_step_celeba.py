"""Port CelebA train step vs ``eadgan_tpu.train.gan_celeba`` at full width.

Both packages start from the same numpy-seeded weights (carried across
by ``eadgan_tpu_torch.interop.from_jax``) and take the same draws through
the step's ``fixed=`` argument, at batch 2 on the CPU.

Tolerances, with their reasons:

* losses at step 0: rtol 1e-4.  Same weights, same inputs, float32 on
  both sides; only summation orders differ.
* losses over 3 steps at the low-lr config (rates / 10): rtol 3e-3.
  Each Adam step moves a parameter by about lr * sign(g), so parameters
  whose gradients are near zero can take opposite signs in the two
  frameworks, and the difference compounds over steps.
* parameters after step 1: elementwise within 2 * lr for each optimizer
  that stepped the tensor (G: opt_g and opt_info; D: opt_d and opt_info).
  Adam's first update is lr * g / (|g| + eps), at most lr in magnitude,
  so a gradient whose sign differs moves the two copies at most 2 * lr
  apart.  Most elements agree far closer: at most 2% of a tensor may
  differ by more than 1e-5 (measured: at most 0.6%, in a BatchNorm
  scale).  The exception is the bias of each transposed conv that feeds
  a BatchNorm: its true gradient is zero (the BatchNorm subtracts the
  channel mean), so both sides step rounding noise and only the 2 * lr
  bound holds there (measured: 40-80% of such elements beyond 1e-5).
* spectral-norm ``u``/``sigma`` and BatchNorm running statistics after
  step 1: 1e-4 (they are computed from the same forwards).
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
from eadgan_tpu.train.state import GanTrainState, ModelVars, adam
from eadgan_tpu_torch.interop import celeba_discriminator_from_flax, celeba_generator_from_flax
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

from tests.test_torch_port_models_celeba import celeba_flax_variables

B = 2
DEFAULT_LR = dict(g_lr=1e-3, d_lr=2e-4, info_lr=2e-4)
LOW_LR = dict(g_lr=1e-4, d_lr=2e-5, info_lr=2e-5)


def _jax_state(config, g_vars, d_vars):
    g, d = ModelVars.create(g_vars), ModelVars.create(d_vars)
    return GanTrainState(
        step=jnp.zeros((), jnp.int32),
        rng=jax.random.PRNGKey(0),
        g=g,
        d=d,
        opt_g=adam(config.g_lr, config.b1, config.b2).init(g.params),
        opt_d=adam(config.d_lr, config.b1, config.b2).init(d.params),
        opt_info=adam(config.info_lr, config.b1, config.b2).init(
            {"g": g.params, "d": d.params}
        ),
    )


def _port_state(config, g_vars, d_vars):
    state = init_celeba_gan_state(config, device="cpu", seed=0)
    state.g.load_state_dict(celeba_generator_from_flax(g_vars))
    state.d.load_state_dict(celeba_discriminator_from_flax(d_vars))
    return state


def run_both(steps, lrs, seed=1):
    """Run ``steps`` steps in both packages; returns per-step losses
    (jax, port) and the final states."""
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

    jax_config = JaxConfig(batch_size=B, **lrs)
    jstep = jax_make_step(JaxG(), JaxD(), jax_config)
    jstate = _jax_state(jax_config, g_vars, d_vars)
    jax_losses = []
    for fixed in draws:
        jstate, m = jstep(jstate, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in fixed.items()})
        jax_losses.append({k: float(v) for k, v in m.items()})

    config = CelebaConfig(batch_size=B, **lrs)
    step = make_celeba_gan_step(config)
    state = _port_state(config, g_vars, d_vars)
    port_losses = []
    for fixed in draws:
        state, m = step(state, torch.from_numpy(imgs), fixed)
        port_losses.append({k: float(v) for k, v in m.items()})
    return jax_losses, port_losses, jstate, state


def _assert_losses(jax_losses, port_losses, rtol):
    for s, (a, b) in enumerate(zip(jax_losses, port_losses)):
        assert set(a) == set(b) == {"d_loss", "g_loss", "info_loss"}
        for k in a:
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=f"step {s} {k}")


@pytest.fixture(scope="module")
def one_step():
    return run_both(1, DEFAULT_LR)


def test_step0_losses(one_step):
    jax_losses, port_losses, _, _ = one_step
    _assert_losses(jax_losses, port_losses, rtol=1e-4)


def _jax_sd(state):
    g = celeba_generator_from_flax({"params": state.g.params, "batch_stats": state.g.stats})
    d = celeba_discriminator_from_flax({"params": state.d.params, "batch_stats": state.d.stats})
    return g, d


# transposed-conv biases that feed a BatchNorm: zero true gradient
_ZERO_GRAD = {"conv_blocks.1.bias", "conv_blocks.4.bias", "conv_blocks.7.bias"}


def test_step1_params_within_adam_bound(one_step):
    _, _, jstate, state = one_step
    g_ref, d_ref = _jax_sd(jstate)
    bounds = (
        (g_ref, state.g, 2 * (DEFAULT_LR["g_lr"] + DEFAULT_LR["info_lr"])),
        (d_ref, state.d, 2 * (DEFAULT_LR["d_lr"] + DEFAULT_LR["info_lr"])),
    )
    for ref, model, bound in bounds:
        for name, p in model.named_parameters():
            diff = np.abs(p.detach().numpy() - ref[name].numpy())
            assert diff.max() <= bound, f"{name}: max |diff| {diff.max()} > {bound}"
            if name not in _ZERO_GRAD:
                far = np.mean(diff > 1e-5)
                assert far <= 0.02, f"{name}: {far:.4f} of elements beyond 1e-5"


def test_step1_sn_and_bn_state(one_step):
    _, _, jstate, state = one_step
    g_ref, d_ref = _jax_sd(jstate)
    for ref, model in ((g_ref, state.g), (d_ref, state.d)):
        for name, buf in model.named_buffers():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(
                buf.numpy(), ref[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name
            )


def test_three_steps_low_lr():
    jax_losses, port_losses, _, state = run_both(3, LOW_LR, seed=2)
    _assert_losses(jax_losses, port_losses, rtol=3e-3)
    assert state.step == 3
