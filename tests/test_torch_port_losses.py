"""Port losses vs ``eadgan_tpu.losses`` (values and gradients).

Tolerance rtol 1e-6 / atol 1e-6: the same float32 formulas on both sides.
BCE is also checked where the sigmoid saturates to exactly 0 or 1: the
clip into [eps, 1-eps] keeps values and gradients finite in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu import losses as jl
from eadgan_tpu_torch import losses as tl

TOL = dict(rtol=1e-6, atol=1e-6)


def _grad_pair(jfn, tfn, x, *rest):
    jval, jgrad = jax.value_and_grad(jfn)(jnp.asarray(x), *map(jnp.asarray, rest))
    tx = torch.from_numpy(x).requires_grad_(True)
    tval = tfn(tx, *map(torch.from_numpy, rest))
    tval.backward()
    return (float(jval), np.asarray(jgrad)), (float(tval.detach()), tx.grad.numpy())


def _check(jfn, tfn, x, *rest):
    (jv, jg), (tv, tg) = _grad_pair(jfn, tfn, x, *rest)
    np.testing.assert_allclose(tv, jv, **TOL)
    np.testing.assert_allclose(tg, jg, **TOL)
    assert np.all(np.isfinite(tg))


def test_mse(rng):
    a = rng.standard_normal((8, 5)).astype(np.float32)
    b = rng.standard_normal((8, 5)).astype(np.float32)
    _check(jl.mse_loss, tl.mse_loss, a, b)


@pytest.mark.parametrize("target", [0.0, 1.0, "mixed"])
def test_bce(rng, target):
    p = rng.uniform(0.01, 0.99, 16).astype(np.float32)
    t = (
        rng.integers(0, 2, 16).astype(np.float32)
        if target == "mixed" else np.full(16, target, np.float32)
    )
    _check(jl.bce_loss, tl.bce_loss, p, t)


@pytest.mark.parametrize("p_value", [0.0, 1.0])
@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_saturated(p_value, target):
    """p exactly 0 or 1 (a saturated sigmoid): finite loss and gradient,
    equal to the JAX package's; ``nn.BCELoss`` would give -100-clamped
    values instead."""
    p = np.full(4, p_value, np.float32)
    t = np.full(4, target, np.float32)
    _check(jl.bce_loss, tl.bce_loss, p, t)


def test_bce_gradient_through_sigmoid_at_saturation():
    logits = np.array([-200.0, -50.0, 50.0, 200.0], np.float32)
    t = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    _check(
        lambda x, y: jl.bce_loss(jax.nn.sigmoid(x), y),
        lambda x, y: tl.bce_loss(torch.sigmoid(x), y),
        logits, t,
    )


@pytest.mark.parametrize("softmaxed", [False, True])
def test_torch_cross_entropy(rng, softmaxed):
    """Logits, and already-softmaxed probabilities (the double-softmax
    quirk: log_softmax is applied to whatever the head emits)."""
    x = rng.standard_normal((8, 10)).astype(np.float32)
    if softmaxed:
        x = np.array(jax.nn.softmax(x, axis=-1))
    labels = rng.integers(0, 10, 8)
    _check(
        lambda a: jl.torch_cross_entropy(a, jnp.asarray(labels)),
        lambda a: tl.torch_cross_entropy(a, torch.from_numpy(labels)),
        x,
    )
    ref = torch.nn.functional.cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
    np.testing.assert_allclose(
        float(tl.torch_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))),
        float(ref), **TOL,
    )


def test_mutual_info(rng):
    c_given_x = np.array(jax.nn.softmax(rng.standard_normal((8, 3)), axis=-1), np.float32)
    c = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)]
    _check(jl.mutual_info_loss, tl.mutual_info_loss, c_given_x, c)
