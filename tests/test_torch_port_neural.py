"""Port neural affine regularizer and approximator step vs the JAX package.

* ``flatten_matrix_2x3`` and ``regularize_neural`` on the same rpqmnxy
  codes and approximator weights (carried across by
  ``interop/from_jax.py``): rtol 1e-4 (float32 on both sides; the 3x3
  products and the MLP's sums in other orders, amplified by the
  unscaling to code units).
* Three approximator steps at the CLI's learning rate against the JAX
  package's pieces: its step draws its codes inside and has no
  ``fixed=`` hook, so the JAX side here is composed of the functions
  that step calls (``code_to_params``, ``code_to_matrix``,
  ``flatten_matrix_2x3``, the model's ``apply``, ``mse_loss`` and the
  package's Adam) on the codes the port's step takes through ``fixed=``.
  Losses rtol 1e-4.
* The closed-form ``regularize`` refuses rpqmnxy and names the neural
  one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eadgan_tpu.losses import mse_loss as jax_mse
from eadgan_tpu.models import AffineApproximator as JaxApprox
from eadgan_tpu.train.state import adam as jax_adam
from eadgan_tpu.transforms import RPQMNXY as JAX_RPQMNXY
from eadgan_tpu.transforms import code_to_matrix as jax_code_to_matrix
from eadgan_tpu.transforms import code_to_params as jax_code_to_params
from eadgan_tpu.transforms.neural import flatten_matrix_2x3 as jax_flatten
from eadgan_tpu.transforms.neural import regularize_neural as jax_regularize_neural
from eadgan_tpu_torch.train.config import ApproximatorConfig
from eadgan_tpu_torch.train.pretrain import init_approximator_state, make_approximator_step
from eadgan_tpu_torch.transforms import RPQMNXY, code_to_matrix, regularize
from eadgan_tpu_torch.transforms.neural import flatten_matrix_2x3, regularize_neural

from tests.test_torch_port_mnist_models import FROM_FLAX, mnist_flax_variables

B = 16


@pytest.fixture(scope="module")
def approx_variables():
    return mnist_flax_variables(seed=5)["approx"]


def _port_approx(variables):
    state = init_approximator_state(ApproximatorConfig(batch_size=B), device="cpu", seed=0)
    state.model.load_state_dict(FROM_FLAX["approx"](variables))
    return state


def test_flatten_matrix_2x3_matches_jax():
    code = np.random.default_rng(0).uniform(-1, 1, (B, 7)).astype(np.float32)
    ref = np.asarray(jax_flatten(jax_code_to_matrix(JAX_RPQMNXY, jnp.asarray(code))))
    got = flatten_matrix_2x3(code_to_matrix(RPQMNXY, torch.from_numpy(code))).numpy()
    assert got.shape == (B, 6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_regularize_neural_matches_jax(approx_variables):
    rng = np.random.default_rng(1)
    real, trans = (rng.uniform(-1, 1, (B, 7)).astype(np.float32) for _ in range(2))
    ref = np.asarray(jax_regularize_neural(
        JaxApprox(), approx_variables, jnp.asarray(real), jnp.asarray(trans)
    ))
    model = _port_approx(approx_variables).model.eval()
    with torch.no_grad():
        got = regularize_neural(model, torch.from_numpy(real), torch.from_numpy(trans)).numpy()
    assert got.shape == (B, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_regularize_neural_passes_gradients_to_the_codes(approx_variables):
    model = _port_approx(approx_variables).model.requires_grad_(False)
    rng = np.random.default_rng(2)
    real, trans = (torch.from_numpy(rng.uniform(-1, 1, (B, 7)).astype(np.float32))
                   .requires_grad_(True) for _ in range(2))
    regularize_neural(model, real, trans).square().sum().backward()
    assert real.grad.abs().sum() > 0 and trans.grad.abs().sum() > 0
    assert all(p.grad is None for p in model.parameters())


def test_closed_form_refuses_rpqmnxy():
    code = torch.zeros(2, 7)
    with pytest.raises(ValueError, match="regularize_neural"):
        regularize(RPQMNXY, code, code)


def test_three_approximator_steps_match_jax(approx_variables):
    config = ApproximatorConfig(batch_size=B)
    state = _port_approx(approx_variables)
    step = make_approximator_step(config)

    model = JaxApprox()
    params = approx_variables["params"]
    tx = jax_adam(config.lr, config.b1, config.b2)
    opt = tx.init(params)

    @jax.jit
    def jax_step(params, opt, code):
        target = jax_code_to_params(JAX_RPQMNXY, code)
        flat = jax_flatten(jax_code_to_matrix(JAX_RPQMNXY, code))
        loss, grads = jax.value_and_grad(
            lambda p: jax_mse(model.apply({"params": p}, flat), target)
        )(params)
        updates, opt = tx.update(grads, opt, params)
        return optax.apply_updates(params, updates), opt, loss

    rng = np.random.default_rng(3)
    jax_losses, port_losses = [], []
    for _ in range(3):
        code = rng.uniform(-1, 1, (B, 7)).astype(np.float32)
        params, opt, loss = jax_step(params, opt, jnp.asarray(code))
        jax_losses.append(float(loss))
        state, m = step(state, {"code": code})
        port_losses.append(float(m["affine_loss"]))
    assert state.step == 3 and all(np.isfinite(port_losses))
    np.testing.assert_allclose(port_losses, jax_losses, rtol=1e-4)
    # the port's own draws are uniform in [-1, 1) from its generator
    state, m = step(state)
    assert np.isfinite(float(m["affine_loss"]))
