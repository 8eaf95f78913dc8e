"""Port MNIST GAN step vs ``eadgan_tpu.train.gan_mnist`` at full width.

Both packages start from the same numpy-seeded weights (G, D, E and the
frozen approximator, carried across by
``eadgan_tpu_torch.interop.from_jax``) and take the same draws through
``fixed=`` ({"z", "sampled_labels", "code"}), at batch 4 on the CPU, on
the synthetic MNIST stand-in.  The JAX step runs with ``jit=False``.

One run of three steps at the CLI's learning rates / 10 (lr 1e-5, D
2e-5), read at step 0, after step 1 and over the three steps.
Tolerances, with their reasons (as ``test_torch_port_step_dsprites.py``):

* losses at step 0: rtol 1e-4.  Same weights and inputs, float32 on both
  sides; only summation orders differ.
* losses over the 3 steps: rtol 3e-3.  Each Adam step moves a parameter
  by about lr * sign(g); gradients near zero can take opposite signs in
  the two frameworks, and that compounds.
* parameters after step 1: within 2 * lr of each optimizer that stepped
  them (G: ``opt_g`` and ``opt_info``, so 4 * lr; E: ``opt_info``; D:
  ``opt_d``), and at most 2% of a tensor (one element of a tensor under
  50) beyond 1e-5.  The exception is the bias of each conv (or dense
  layer) that feeds a BatchNorm: its true gradient is zero, so both
  sides step rounding noise and only the Adam bound holds.
* spectral-norm ``u``/``sigma`` (D's, moved three times a step, and E's)
  and BatchNorm running statistics (G's and E's) after step 1: 1e-4.
* bf16 (G, D and E in bf16 on both sides): losses rtol 2e-3 at step 0
  and 1e-2 over the 3 steps.

The approximator takes no gradient and does not move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.models import AffineApproximator as JaxApprox
from eadgan_tpu.models import MnistDiscriminator as JaxD
from eadgan_tpu.models import MnistEncoder as JaxE
from eadgan_tpu.models import MnistGenerator as JaxG
from eadgan_tpu.train.config import MnistConfig as JaxMnistConfig
from eadgan_tpu.train.gan_mnist import make_mnist_gan_step as jax_make_step
from eadgan_tpu.train.state import GanTrainState, ModelVars, adam
from eadgan_tpu_torch.data.mnist import normalize_mnist, synthetic_mnist
from eadgan_tpu_torch.train.config import MnistConfig
from eadgan_tpu_torch.train.gan_mnist import METRIC_KEYS, init_mnist_gan_state, make_mnist_gan_step
from eadgan_tpu_torch.train.pretrain import approximator_model

from tests.test_torch_port_mnist_models import FROM_FLAX, mnist_flax_variables
from tests.test_torch_port_step_dsprites import assert_buffers_match, assert_params_within_adam_bound

B = 4
STEPS = 3
LR = 1e-5  # the CLI's 1e-4 / 10; D steps at 2 * LR
# biases that feed a BatchNorm (G's fc and inner convs, E's convs 2-4):
# zero true gradient
_ZERO_GRAD = {
    "g": {"l1.0.bias", "conv_blocks.2.bias", "conv_blocks.6.bias"},
    "e": {"conv_blocks.2.bias", "conv_blocks.5.bias", "conv_blocks.8.bias"},
}
_BUFFERS = (".u", ".sigma", "running_mean", "running_var", "num_batches_tracked")


def mnist_batch(seed):
    """(B, 32, 32, 1) float32 stand-in digits in [-1, 1]."""
    raw, _ = synthetic_mnist(n=16, seed=seed)
    return normalize_mnist(raw[:B])


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _to_sd(name, mv):
    return FROM_FLAX[name]({"params": mv.params, "batch_stats": mv.stats})


def draws(seed, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [
        {
            "z": rng.standard_normal((B, 62)).astype(np.float32),
            "sampled_labels": rng.integers(0, 10, B).astype(np.int32),
            "code": rng.uniform(-1, 1, (B, 7)).astype(np.float32),
        }
        for _ in range(steps)
    ]


def run_mnist(steps=STEPS, seed=1, dtype=None):
    """``steps`` MNIST steps in both packages: (jax losses, port losses,
    (jax state, {model: port state dict}) after step 1, port state)."""
    variables = mnist_flax_variables(seed)
    imgs = mnist_batch(seed)
    jdtype = jnp.bfloat16 if dtype is not None else None
    jconfig = JaxMnistConfig(batch_size=B, lr=LR)
    jstep = jax_make_step(
        JaxG(dtype=jdtype), JaxD(dtype=jdtype), JaxE(dtype=jdtype), JaxApprox(), jconfig, jit=False
    )
    g, d, e = (ModelVars.create(variables[k]) for k in ("g", "d", "e"))
    jstate = GanTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed), g=g, d=d, e=e,
        approx=ModelVars.create(variables["approx"]),
        opt_g=adam(jconfig.lr).init(g.params), opt_d=adam(jconfig.d_lr).init(d.params),
        opt_info=adam(jconfig.lr).init({"g": g.params, "e": e.params}),
    )

    config = MnistConfig(batch_size=B, lr=LR)
    approx = approximator_model(1)
    approx.load_state_dict(FROM_FLAX["approx"](variables["approx"]))
    state = init_mnist_gan_state(config, approx, device="cpu", seed=0, dtype=dtype)
    for k in ("g", "d", "e"):
        getattr(state, k).load_state_dict(FROM_FLAX[k](variables[k]))
    step = make_mnist_gan_step(config)

    jax_losses, port_losses, after_1 = [], [], None
    labels = np.zeros(B, np.int32)  # the dataset's labels: unused by both steps
    for fixed in draws(seed, steps):
        jstate, m = jstep(jstate, jnp.asarray(imgs), jnp.asarray(labels),
                          {k: jnp.asarray(v) for k, v in fixed.items()})
        jax_losses.append({k: float(v) for k, v in m.items()})
        state, m = step(state, torch.from_numpy(imgs), torch.from_numpy(labels), fixed)
        port_losses.append({k: float(v) for k, v in m.items()})
        after_1 = after_1 or (jstate, {k: _snapshot(getattr(state, k)) for k in ("g", "d", "e")})
    return jax_losses, port_losses, after_1, state


def _assert_losses(jax_losses, port_losses, rtol):
    for s, (a, b) in enumerate(zip(jax_losses, port_losses)):
        assert set(a) == set(b) == set(METRIC_KEYS)
        for k in a:
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=f"step {s} {k}")


@pytest.fixture(scope="module")
def mnist_run():
    return run_mnist()


def test_losses_match_jax(mnist_run):
    jax_losses, port_losses, _, state = mnist_run
    _assert_losses(jax_losses[:1], port_losses[:1], rtol=1e-4)
    _assert_losses(jax_losses, port_losses, rtol=3e-3)
    assert state.step == STEPS


def _split(sd):
    params = {k: v for k, v in sd.items() if not k.endswith(_BUFFERS)}
    return params, {k: v for k, v in sd.items() if k.endswith(_BUFFERS)}


@pytest.mark.parametrize("name,bound", [("g", 4 * LR), ("d", 2 * LR), ("e", LR)])
def test_step1_params_within_adam_bound(mnist_run, name, bound):
    _, _, (jstate, sds), _ = mnist_run
    params, _ = _split(sds[name])
    assert_params_within_adam_bound(
        params, _to_sd(name, getattr(jstate, name)), bound, _ZERO_GRAD.get(name, ())
    )


@pytest.mark.parametrize("name", ["g", "d", "e"])
def test_step1_sn_and_bn_state(mnist_run, name):
    """D's spectral-norm ``u``/``sigma`` (three power steps a step), E's
    (three reads) with its BatchNorm statistics, G's BatchNorm statistics
    (the info phase starting from the G phase's)."""
    _, _, (jstate, sds), _ = mnist_run
    _, buffers = _split(sds[name])
    assert buffers
    assert_buffers_match(buffers, _to_sd(name, getattr(jstate, name)), name)


def test_approximator_takes_no_gradient(mnist_run):
    _, _, (jstate, _), state = mnist_run
    assert not state.approx.training
    ref = _to_sd("approx", jstate.approx)
    for key, p in state.approx.named_parameters():
        assert p.grad is None and not p.requires_grad
        assert torch.equal(p, ref[key]), key
    assert all(p.requires_grad for p in state.d.parameters())
    owned = {id(p) for g in state.opt_info.param_groups for p in g["params"]}
    owned |= {id(p) for o in (state.opt_g, state.opt_d) for g in o.param_groups for p in g["params"]}
    assert not owned & {id(p) for p in state.approx.parameters()}


def test_draws_without_fixed_are_seeded():
    """Without ``fixed`` the step draws from ``state.rng``: two states from
    one seed take equal steps."""
    config = MnistConfig(batch_size=B)
    imgs = torch.from_numpy(mnist_batch(0))
    losses = []
    for _ in range(2):
        state = init_mnist_gan_state(config, approximator_model(1), device="cpu", seed=3)
        _, m = make_mnist_gan_step(config)(state, imgs)
        losses.append([float(m[k]) for k in METRIC_KEYS])
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))


def test_bf16_step_matches_jax_bf16():
    jax_losses, port_losses, _, state = run_mnist(dtype=torch.bfloat16)
    _assert_losses(jax_losses[:1], port_losses[:1], rtol=2e-3)
    _assert_losses(jax_losses, port_losses, rtol=1e-2)
    for model in (state.g, state.d, state.e):
        dtypes = {t.dtype for t in [*model.parameters(), *model.buffers()] if t.is_floating_point()}
        assert dtypes == {torch.float32}
    for st in state.opt_info.state.values():
        assert st["exp_avg"].dtype == torch.float32
