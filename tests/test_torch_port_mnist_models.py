"""Port MNIST models and the affine approximator vs the JAX package at the
published widths.

The same flax variables (numpy-seeded, spectral norms near their fixed
point) go into ``eadgan_tpu.models`` and, through
``eadgan_tpu_torch.interop.from_jax``, into the port's models.  After two
training-mode applies the outputs, the BatchNorm running statistics and
the spectral-norm ``u``/``sigma`` must agree; in eval mode too (G with
its running statistics, the encoder's BatchNorms still on batch
statistics, as the JAX model calls them without ``use_running_average``).

Tolerance: 1e-5 absolute and relative.  Both sides compute in float32 on
the CPU; only summation orders differ (reductions of at most 1,152
terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.interop.torch_export import (
    export_approximator,
    export_mnist_discriminator,
    export_mnist_encoder,
    export_mnist_generator,
)
from eadgan_tpu.models import AffineApproximator as JaxApprox
from eadgan_tpu.models import MnistDiscriminator as JaxD
from eadgan_tpu.models import MnistEncoder as JaxE
from eadgan_tpu.models import MnistGenerator as JaxG
from eadgan_tpu_torch.interop import from_jax
from eadgan_tpu_torch.models import (
    AffineApproximator,
    MnistDiscriminator,
    MnistEncoder,
    MnistGenerator,
    no_stat_updates,
)
from eadgan_tpu_torch.train.gan_mnist import init_mnist_gan_state
from eadgan_tpu_torch.train.config import MnistConfig
from eadgan_tpu_torch.train.pretrain import approximator_model

from tests.test_torch_port_models_dsprites import _fill, converge_sn

TOL = dict(rtol=1e-5, atol=1e-5)
B = 4
NAMES = ("g", "d", "e", "approx")
FROM_FLAX = {
    "g": from_jax.mnist_generator_from_flax,
    "d": from_jax.mnist_discriminator_from_flax,
    "e": from_jax.mnist_encoder_from_flax,
    "approx": from_jax.approximator_from_flax,
}
EXPORT = {
    "g": export_mnist_generator,
    "d": export_mnist_discriminator,
    "e": export_mnist_encoder,
    "approx": export_approximator,
}


def jax_models(dtype=None):
    return {"g": JaxG(dtype=dtype), "d": JaxD(dtype=dtype), "e": JaxE(dtype=dtype),
            "approx": JaxApprox()}


def _jax_inputs(name):
    if name == "g":
        return (jnp.zeros((1, 62)), jnp.zeros((1, 10)), jnp.zeros((1, 7)))
    if name == "approx":
        return (jnp.zeros((1, 6)),)
    return (jnp.zeros((1, 32, 32, 1)),)


def mnist_flax_variables(seed=0):
    """{"g", "d", "e", "approx"} -> numpy flax variable trees."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, model in jax_models().items():
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), *_jax_inputs(name)))
        out[name] = converge_sn(_fill(shapes, rng))
    return out


def port_model(name, variables, dtype=None):
    model = {
        "g": lambda: MnistGenerator(dtype=dtype),
        "d": lambda: MnistDiscriminator(dtype=dtype),
        "e": lambda: MnistEncoder(dtype=dtype),
        "approx": AffineApproximator,
    }[name]()
    model.load_state_dict(FROM_FLAX[name](variables[name]))
    return model.train()


def model_inputs(name, rng):
    """Numpy inputs of one model: G (z, one-hot, code), D/E an NHWC batch
    in [-1, 1], the approximator flattened 2x3 matrices."""
    if name == "g":
        return (
            rng.standard_normal((B, 62)).astype(np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)],
            rng.uniform(-1, 1, (B, 7)).astype(np.float32),
        )
    if name == "approx":
        return (rng.uniform(-1.5, 1.5, (B, 6)).astype(np.float32),)
    return (rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),)


def _port_out(name, model, inputs):
    """The port model's outputs as a tuple of numpy arrays, images NHWC."""
    xs = [torch.from_numpy(x) for x in inputs]
    if name in ("d", "e"):
        xs = [xs[0].permute(0, 3, 1, 2).contiguous()]
    with torch.no_grad():
        out = model(*xs)
    if name == "g":
        return (out.permute(0, 2, 3, 1).numpy(),)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else (out.numpy(),)


def _jax_apply(name, model, variables, inputs, train=True):
    """(outputs tuple, updated batch_stats)."""
    xs = [jnp.asarray(x) for x in inputs]
    kw = {} if name == "approx" else {"train": train}
    if "batch_stats" not in variables:
        return (np.asarray(model.apply(variables, *xs, **kw)),), {}
    out, upd = model.apply(variables, *xs, mutable=["batch_stats"], **kw)
    out = out if isinstance(out, tuple) else (out,)
    return tuple(np.asarray(o) for o in out), upd["batch_stats"]


def assert_state_matches(name, model, params, stats, sn_tol=TOL, bn_tol=TOL):
    """The port model's SN ``u``/``sigma`` and BN running statistics
    against a flax ``batch_stats`` tree; returns how many were held."""
    ref = FROM_FLAX[name]({"params": params, "batch_stats": stats})
    checked = 0
    for key, buf in model.named_buffers():
        if key.endswith("num_batches_tracked"):
            continue
        tol = bn_tol if key.endswith(("running_mean", "running_var")) else sn_tol
        np.testing.assert_allclose(buf.numpy(), ref[key].numpy(), err_msg=key, **tol)
        checked += 1
    return checked


@pytest.fixture(scope="module")
def variables():
    return mnist_flax_variables()


@pytest.mark.parametrize("name", NAMES)
def test_two_training_applies_match_jax(variables, name):
    rng = np.random.default_rng(1)
    jmodel = jax_models()[name]
    model = port_model(name, variables)
    jvars = dict(variables[name])
    for _ in range(2):
        inputs = model_inputs(name, rng)
        ref, stats = _jax_apply(name, jmodel, jvars, inputs)
        got = _port_out(name, model, inputs)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, **TOL)
        if stats:
            jvars["batch_stats"] = stats
            assert assert_state_matches(name, model, jvars["params"], stats) > 0


@pytest.mark.parametrize("name", ["g", "d", "e"])
def test_eval_mode_matches_jax(variables, name):
    """Eval mode against ``train=False``: G on its running statistics, D
    and E taking the power step without storing it, E's BatchNorms still
    on (and updating) batch statistics."""
    inputs = model_inputs(name, np.random.default_rng(2))
    ref, stats = _jax_apply(name, jax_models()[name], variables[name], inputs, train=False)
    model = port_model(name, variables).eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    got = _port_out(name, model, inputs)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL)
    assert_state_matches(name, model, variables[name]["params"], stats)
    moved = {k for k, v in model.named_buffers() if not torch.equal(v, before[k])}
    if name == "e":
        assert moved and all("running" in k or "num_batches" in k for k in moved), moved
    else:
        assert not moved, moved


def test_batch_norm_quirks(variables):
    """G's first BatchNorm has eps 1e-5 and its inner ones 0.8; the
    encoder's three have eps 0.8 and stay on batch statistics in eval
    mode: its outputs then depend on the batch they are in."""
    gen = port_model("g", variables)
    assert [m.eps for m in gen.conv_blocks if hasattr(m, "eps")] == [1e-5, 0.8, 0.8]
    model = port_model("e", variables).eval()
    bns = [m for m in model.conv_blocks if hasattr(m, "always_batch_stats")]
    assert len(bns) == 3 and all(m.always_batch_stats and m.eps == 0.8 for m in bns)
    (x,) = model_inputs("e", np.random.default_rng(3))
    whole = _port_out("e", model, (x,))[1]
    half = _port_out("e", model, (x[:2],))[1]
    assert np.abs(whole[:2] - half).max() > 1e-4


def test_frozen_stats_leave_state(variables):
    inputs = model_inputs("e", np.random.default_rng(4))
    model = port_model("e", variables)
    before = {k: v.clone() for k, v in model.named_buffers()}
    with no_stat_updates(model):
        _port_out("e", model, inputs)
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


def test_parameter_counts_match_jax(variables):
    for name, model in jax_models().items():
        want = sum(np.size(x) for x in jax.tree_util.tree_leaves(variables[name]["params"]))
        got = sum(p.numel() for p in port_model(name, variables).parameters())
        assert got == want, name
    # under 1.5 M parameters for the whole step
    total = sum(
        sum(np.size(x) for x in jax.tree_util.tree_leaves(variables[n]["params"])) for n in NAMES
    )
    assert total < 1_500_000


@pytest.mark.parametrize("name", NAMES)
def test_from_flax_matches_torch_export(variables, name):
    """``from_jax`` equals the JAX package's own exporter on every
    parameter (the flatten permutation included), and the state_dict
    loads strictly into the reference layouts of
    ``tests/test_torch_import.py``."""
    from tests.test_torch_import import TorchApprox, TorchMnistE, TorchMnistG

    ours = FROM_FLAX[name](variables[name])
    theirs = EXPORT[name](variables[name])
    plain = {k: v for k, v in theirs.items()
             if not k.endswith(("weight_u", "weight_v", "weight_orig"))}
    assert plain and set(plain) <= set(ours)
    for k, v in plain.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    ref = {"g": TorchMnistG, "e": TorchMnistE, "approx": TorchApprox}.get(name)
    if ref is not None:
        model = port_model(name, variables)
        keys = {k for k in model.state_dict() if not k.endswith((".u", ".sigma"))}
        ref_keys = {k.replace("weight_orig", "weight") for k in ref().state_dict()
                    if not k.endswith(("weight_u", "weight_v"))}
        assert keys == ref_keys


def test_normal_init_regime():
    """``weights_init_normal``: plain conv weights N(0, 0.02), BN scales
    N(1, 0.02), BN biases 0; SN convs and linears keep torch's default
    (uniform within 1/sqrt(fan_in))."""
    state = init_mnist_gan_state(MnistConfig(), approximator_model(1), device="cpu", seed=0)
    g, e = state.g, state.e
    for conv in (g.conv_blocks[2], g.conv_blocks[6], g.conv_blocks[9]):
        assert abs(conv.weight.std().item() - 0.02) < 0.004
    for bn in [m for m in (*g.modules(), *e.modules()) if hasattr(m, "running_var")]:
        assert abs(bn.weight.mean().item() - 1.0) < 0.01 and bn.weight.std().item() < 0.03
        assert torch.count_nonzero(bn.bias) == 0
    sn = e.conv_blocks[2]
    bound = 1.0 / np.sqrt(16 * 9)
    assert sn.weight.abs().max().item() <= bound and sn.weight.std().item() > 0.3 * bound
    lin = g.l1[0]
    assert lin.weight.abs().max().item() <= 1.0 / np.sqrt(79)
    # the approximator is frozen and in eval mode beside them
    assert not state.approx.training
    assert not any(p.requires_grad for p in state.approx.parameters())
