"""Port CelebA models vs the JAX package at full width.

The same flax variables (numpy-seeded) go into ``eadgan_tpu.models`` and,
through ``eadgan_tpu_torch.interop.from_jax``, into the port's models.
After one and two training-mode applies the outputs, the BatchNorm
running statistics and the spectral-norm ``u``/``sigma`` must agree.

Tolerance 1e-4 (absolute and relative): both sides compute in float32 on
the CPU, and the only differences are summation orders in convolutions
whose reductions run over up to 16384 terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.interop.torch_export import export_celeba_generator
from eadgan_tpu.models import CelebaDiscriminator as JaxD
from eadgan_tpu.models import CelebaGenerator as JaxG
from eadgan_tpu_torch.interop import celeba_discriminator_from_flax, celeba_generator_from_flax
from eadgan_tpu_torch.models import CelebaDiscriminator, CelebaGenerator, no_stat_updates

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2


def _l2n(x):
    return x / np.sqrt(np.sum(x * x) + 1e-12)


def _fill(tree, rng, path=()):
    """Numpy values for an eval_shape tree: torch-default-scale kernels,
    perturbed BatchNorm parameters and statistics, random SN ``u``."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in tree.items()}
    shape, name, coll = tree.shape, path[-1], path[0]
    if name == "kernel":
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return rng.uniform(-bound, bound, shape).astype(np.float32)
    if coll == "params" and name == "bias":
        return rng.uniform(-0.05, 0.05, shape).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "mean":
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if name.endswith("/u"):
        return rng.standard_normal(shape).astype(np.float32)
    if name.endswith("/sigma"):
        return np.ones(shape, np.float32)
    raise KeyError("/".join(path))


def converge_sn(variables, iters=30):
    """Run the power iteration (float64, numpy) to near its fixed point
    for every SN layer, as a trained discriminator's state would be."""
    for name, mod in variables["batch_stats"].items():
        sn = mod.get("SpectralNorm_0")
        if sn is None:
            continue
        mat = variables["params"][name]["Conv_0"]["kernel"].astype(np.float64)
        mat = mat.reshape(-1, mat.shape[-1])
        u = sn["Conv_0/kernel/u"].astype(np.float64)
        for _ in range(iters):
            v = _l2n(u @ mat.T)
            u = _l2n(v @ mat)
        sn["Conv_0/kernel/u"] = u.astype(np.float32)
        sn["Conv_0/kernel/sigma"] = np.float32((v @ mat @ u.T).item())
    return variables


def celeba_flax_variables(seed=0):
    """(generator variables, discriminator variables) as numpy trees."""
    rng = np.random.default_rng(seed)
    g_shapes = jax.eval_shape(
        lambda: JaxG().init(
            jax.random.PRNGKey(0), jnp.zeros((1, 200)), jnp.zeros((1, 10)), jnp.zeros((1, 8))
        )
    )
    d_shapes = jax.eval_shape(
        lambda: JaxD().init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    )
    g_vars = _fill(g_shapes, rng)
    d_vars = converge_sn(_fill(d_shapes, rng))
    return g_vars, d_vars


def port_models(g_vars, d_vars):
    g, d = CelebaGenerator(), CelebaDiscriminator()
    g.load_state_dict(celeba_generator_from_flax(g_vars))
    d.load_state_dict(celeba_discriminator_from_flax(d_vars))
    return g.train(), d.train()


@pytest.fixture(scope="module")
def variables():
    return celeba_flax_variables(0)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def test_generator_from_flax_matches_torch_export(variables):
    g_vars, _ = variables
    ours = celeba_generator_from_flax(g_vars)
    theirs = export_celeba_generator(g_vars)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def test_generator_state_dict_loads_into_reference_layout(variables, rng):
    """The port's generator state_dict loads strictly into the reference
    module layout (``tests/test_torch_import.py::TorchCelebaG``), and in
    eval mode both give the same images."""
    from tests.test_torch_import import TorchCelebaG

    g, _ = port_models(*variables)
    ref = TorchCelebaG()
    ref.load_state_dict(g.state_dict(), strict=True)
    z = torch.from_numpy(rng.standard_normal((B, 200)).astype(np.float32))
    labels = torch.eye(10)[torch.from_numpy(rng.integers(0, 10, B))]
    code = torch.from_numpy(rng.uniform(-1, 1, (B, 8)).astype(np.float32))
    with torch.no_grad():
        torch.testing.assert_close(
            g.eval()(z, labels, code), ref.eval()(z, labels, code), rtol=1e-5, atol=1e-5
        )


def test_generator_two_training_applies(variables, rng):
    g_vars, _ = variables
    g, _ = port_models(*variables)
    jg = JaxG()
    stats = g_vars["batch_stats"]
    for _ in range(2):
        z = rng.standard_normal((B, 200)).astype(np.float32)
        labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
        code = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
        out, upd = jg.apply(
            {"params": g_vars["params"], "batch_stats": stats}, z, labels, code,
            mutable=["batch_stats"],
        )
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = g(*map(torch.from_numpy, (z, labels, code)))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(out), **TOL)
        for i, seq in enumerate((2, 5, 8)):
            bn = stats[f"TorchBatchNorm_{i}"]["BatchNorm_0"]
            layer = g.conv_blocks[seq]
            np.testing.assert_allclose(layer.running_mean.numpy(), np.asarray(bn["mean"]), **TOL)
            np.testing.assert_allclose(layer.running_var.numpy(), np.asarray(bn["var"]), **TOL)


def test_generator_eval_and_frozen_stats(variables, rng):
    """Eval mode uses the running statistics (JAX ``train=False``);
    ``no_stat_updates`` keeps a training-mode forward from moving them."""
    g_vars, _ = variables
    g, _ = port_models(*variables)
    z = rng.standard_normal((B, 200)).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, B)]
    code = rng.uniform(-1, 1, (B, 8)).astype(np.float32)
    before = g.conv_blocks[2].running_mean.clone()
    with torch.no_grad(), no_stat_updates(g):
        g(*map(torch.from_numpy, (z, labels, code)))
    torch.testing.assert_close(g.conv_blocks[2].running_mean, before, rtol=0, atol=0)
    ref = JaxG().apply(g_vars, z, labels, code, train=False)
    with torch.no_grad():
        got = g.eval()(*map(torch.from_numpy, (z, labels, code)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), **TOL)


def test_discriminator_two_training_applies(variables, rng):
    _, d_vars = variables
    _, d = port_models(*variables)
    jd = JaxD()
    stats = d_vars["batch_stats"]
    for _ in range(2):
        img = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
        out, upd = jd.apply(
            {"params": d_vars["params"], "batch_stats": stats}, img, mutable=["batch_stats"]
        )
        stats = upd["batch_stats"]
        with torch.no_grad():
            got = d(_nchw(img))
        for a, b in zip(got, out):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        for i, seq in enumerate((0, 2, 4, 6)):
            sn = stats[f"SNConv_{i}"]["SpectralNorm_0"]
            layer = d.main[seq]
            np.testing.assert_allclose(
                layer.u.numpy(), np.asarray(sn["Conv_0/kernel/u"])[0], **TOL
            )
            np.testing.assert_allclose(
                layer.sigma.numpy(), np.asarray(sn["Conv_0/kernel/sigma"]), **TOL
            )


def test_discriminator_eval_takes_power_step_without_storing(variables, rng):
    """Eval mode (JAX ``train=False``) still normalizes with one power
    step from the stored ``u`` but stores nothing."""
    _, d_vars = variables
    _, d = port_models(*variables)
    d.eval()
    img = rng.uniform(-1, 1, (B, 64, 64, 3)).astype(np.float32)
    u_before = d.main[0].u.clone()
    ref = JaxD().apply(d_vars, img, train=False)
    with torch.no_grad():
        got = d(_nchw(img))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    torch.testing.assert_close(d.main[0].u, u_before, rtol=0, atol=0)
