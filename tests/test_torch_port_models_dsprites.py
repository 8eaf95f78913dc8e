"""Port dSprites models vs the JAX package at full width, gray and colored.

The same flax variables (numpy-seeded, spectral norms near their fixed
point) go into ``eadgan_tpu.models`` and, through
``eadgan_tpu_torch.interop.from_jax``, into the port's models.  After two
training-mode applies the outputs, the BatchNorm running statistics and
the spectral-norm ``u``/``sigma`` (conv and dense layers) must agree.

Tolerances:

* float32: 1e-4 absolute and relative.  Both sides compute in float32 on
  the CPU; only summation orders differ (reductions of up to 1,024
  terms).
* bf16 (G, D and E built with a bf16 compute type on both sides; measured
  values in brackets, the port's float32 path in braces): G's image
  within 8e-3, two bf16 steps at |x| < 1 [3.9e-3], on the bf16 grid, and
  at least 30% of its pixels equal bit for bit [63-71% {0-0.01%}]; D and
  E within 1e-3 [at most 1.1e-4].  Spectral-norm state 1e-5 (the power
  step runs in float32 on both sides), BatchNorm statistics 1e-4
  (float32 sums of the same bf16 activations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.interop.torch_export import export_sprites_encoder_pxy, export_sprites_generator
from eadgan_tpu.models import SpritesDiscriminator as JaxD
from eadgan_tpu.models import SpritesEncoder as JaxE
from eadgan_tpu.models import SpritesEncoderPxy as JaxPxy
from eadgan_tpu.models import SpritesGenerator as JaxG
from eadgan_tpu_torch.interop import from_jax
from eadgan_tpu_torch.models import (
    SpritesDiscriminator,
    SpritesEncoder,
    SpritesEncoderPxy,
    SpritesGenerator,
    no_stat_updates,
)

TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
N_CLASSES = 3
NAMES = ("pxy", "g", "d", "e")
FROM_FLAX = {
    "pxy": from_jax.sprites_encoder_pxy_from_flax,
    "g": from_jax.sprites_generator_from_flax,
    "d": from_jax.sprites_discriminator_from_flax,
    "e": from_jax.sprites_encoder_from_flax,
}


def dims(colored):
    """(channels, pxy out_dim, code_dim)."""
    return (3, 6, 7) if colored else (1, 3, 4)


def jax_models(colored, dtype=None):
    c, out_dim, code_dim = dims(colored)
    return {
        "pxy": JaxPxy(out_dim=out_dim, channels=c),
        "g": JaxG(channels=c, dtype=dtype),
        "d": JaxD(channels=c, dtype=dtype),
        "e": JaxE(n_classes=N_CLASSES, code_dim=code_dim, channels=c, dtype=dtype),
    }


def port_model(name, colored, variables, dtype=None):
    c, out_dim, code_dim = dims(colored)
    model = {
        "pxy": lambda: SpritesEncoderPxy(out_dim=out_dim, channels=c),
        "g": lambda: SpritesGenerator(in_dim=N_CLASSES + code_dim, channels=c, dtype=dtype),
        "d": lambda: SpritesDiscriminator(channels=c, dtype=dtype),
        "e": lambda: SpritesEncoder(N_CLASSES, code_dim, channels=c, dtype=dtype),
    }[name]()
    model.load_state_dict(FROM_FLAX[name](variables[name]))
    return model.train()


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
    """Run every SN layer's power iteration (float64, numpy) near its
    fixed point, as a trained model's state would be."""
    for name, mod in variables.get("batch_stats", {}).items():
        sn = mod.get("SpectralNorm_0")
        if sn is None:
            continue
        inner = "Conv_0" if "Conv_0/kernel/u" in sn else "Dense_0"
        mat = variables["params"][name][inner]["kernel"].astype(np.float64)
        mat = mat.reshape(-1, mat.shape[-1])
        u = sn[f"{inner}/kernel/u"].astype(np.float64)
        for _ in range(iters):
            v = _l2n(u @ mat.T)
            u = _l2n(v @ mat)
        sn[f"{inner}/kernel/u"] = u.astype(np.float32)
        sn[f"{inner}/kernel/sigma"] = np.float32((v @ mat @ u.T).item())
    return variables


def sprites_flax_variables(colored, seed=0):
    """{"pxy", "g", "d", "e"} -> numpy flax variable trees."""
    rng = np.random.default_rng(seed)
    c, _, code_dim = dims(colored)
    img = jnp.zeros((1, 64, 64, c))
    inputs = {"pxy": img, "g": jnp.zeros((1, N_CLASSES + code_dim)), "d": img, "e": img}
    out = {}
    for name, model in jax_models(colored).items():
        shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), inputs[name]))
        out[name] = converge_sn(_fill(shapes, rng))
    return out


def model_inputs(colored, rng):
    """(NHWC image batch in [0, 1], (B, n_classes + code_dim) z_c)."""
    c, _, code_dim = dims(colored)
    img = rng.uniform(0, 1, (B, 64, 64, c)).astype(np.float32)
    onehot = np.eye(N_CLASSES, dtype=np.float32)[rng.integers(0, N_CLASSES, B)]
    z_c = np.concatenate([onehot, rng.uniform(-1, 1, (B, code_dim)).astype(np.float32)], -1)
    return img, z_c


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _port_out(name, model, img, z_c):
    """The port model's outputs as a tuple of numpy arrays, images NHWC."""
    with torch.no_grad():
        out = model(torch.from_numpy(z_c)) if name == "g" else model(_nchw(img))
    if name == "g":
        return (out.permute(0, 2, 3, 1).numpy(),)
    return tuple(o.numpy() for o in out) if isinstance(out, tuple) else (out.numpy(),)


def _jax_apply(name, model, variables, img, z_c, train=True):
    """(outputs tuple, updated batch_stats)."""
    x = z_c if name == "g" else img
    if "batch_stats" not in variables:
        return (np.asarray(model.apply(variables, x, train=train)),), {}
    out, upd = model.apply(variables, x, train=train, mutable=["batch_stats"])
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


@pytest.fixture(scope="module", params=[False, True], ids=["gray", "colored"])
def case(request):
    colored = request.param
    return colored, sprites_flax_variables(colored)


@pytest.mark.parametrize("name", NAMES)
def test_two_training_applies_match_jax(case, name):
    colored, variables = case
    rng = np.random.default_rng(1)
    jmodel = jax_models(colored)[name]
    model = port_model(name, colored, variables)
    jvars = dict(variables[name])
    for _ in range(2):
        img, z_c = model_inputs(colored, rng)
        ref, stats = _jax_apply(name, jmodel, jvars, img, z_c)
        got = _port_out(name, model, img, z_c)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.shape == b.shape and a.dtype == np.float32
            np.testing.assert_allclose(a, b, **TOL)
        if stats:
            jvars["batch_stats"] = stats
            assert assert_state_matches(name, model, jvars["params"], stats) > 0


def test_from_flax_matches_torch_export(case, rng):
    """Plain layers carried by ``from_jax`` equal the JAX package's own
    exporter, flatten permutation included; the state_dicts load strictly
    into the reference layouts of ``tests/test_torch_import.py`` and give
    the same outputs."""
    from tests.test_torch_import import TorchSpritesG, TorchSpritesPxy

    colored, variables = case
    c, out_dim, code_dim = dims(colored)
    for name, export in (("pxy", export_sprites_encoder_pxy), ("g", export_sprites_generator)):
        ours = FROM_FLAX[name](variables[name])
        theirs = export(variables[name])
        assert set(ours) == set(theirs)
        for k, v in theirs.items():
            np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)
    img, z_c = model_inputs(colored, rng)
    for name, ref_model, x in (
        ("pxy", TorchSpritesPxy(channels=c, out_dim=out_dim), _nchw(img)),
        ("g", TorchSpritesG(in_dim=N_CLASSES + code_dim, channels=c), torch.from_numpy(z_c)),
    ):
        model = port_model(name, colored, variables).eval()
        ref_model.load_state_dict(model.state_dict(), strict=True)
        with torch.no_grad():
            torch.testing.assert_close(model(x), ref_model.eval()(x), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["pxy", "d", "e"])
def test_dropping_the_flatten_permutation_fails(case, name, monkeypatch):
    """The fc after each flatten needs its input rows permuted: without
    it, the outputs fall outside the tolerance of the tests above by at
    least 10x (D's sigmoid compresses its error most: ~2e-3)."""
    colored, variables = case
    img, z_c = model_inputs(colored, np.random.default_rng(2))
    ref, _ = _jax_apply(name, jax_models(colored)[name], variables[name], img, z_c)
    monkeypatch.setattr(from_jax, "_SPRITES_FLAT", None)
    got = _port_out(name, port_model(name, colored, variables), img, z_c)
    worst = max(np.abs(a - b).max() for a, b in zip(got, ref))
    assert worst > 10 * TOL["atol"], worst


def test_eval_and_frozen_stats(case, rng):
    """Eval mode uses running BatchNorm statistics and takes the power
    step without storing it (JAX ``train=False``); ``no_stat_updates``
    also freezes ``SNDense``."""
    colored, variables = case
    img, z_c = model_inputs(colored, rng)
    for name in ("g", "e"):
        model = port_model(name, colored, variables)
        before = {k: v.clone() for k, v in model.named_buffers()}
        with torch.no_grad(), no_stat_updates(model):
            _port_out(name, model, img, z_c)
        got = _port_out(name, model.eval(), img, z_c)
        for k, v in model.named_buffers():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
        ref, _ = _jax_apply(name, jax_models(colored)[name], variables[name], img, z_c, train=False)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, **TOL)


def _on_bf16_grid(x: np.ndarray) -> bool:
    return np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)


@pytest.mark.parametrize("name", ["g", "d", "e"])
def test_bf16_matches_jax_bf16(case, name):
    colored, variables = case
    img, z_c = model_inputs(colored, np.random.default_rng(3))
    ref, stats = _jax_apply(name, jax_models(colored, jnp.bfloat16)[name], variables[name], img, z_c)
    model = port_model(name, colored, variables, dtype=torch.bfloat16)
    got = _port_out(name, model, img, z_c)
    f32 = {t.dtype for t in [*model.parameters(), *model.buffers()] if t.is_floating_point()}
    assert f32 == {torch.float32}
    for a, b in zip(got, ref):
        assert a.dtype == np.float32 and b.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=8e-3 if name == "g" else 1e-3)
    if name == "g":
        assert _on_bf16_grid(got[0])
        assert np.mean(got[0] == ref[0]) >= 0.3
    assert_state_matches(name, model, variables[name]["params"], stats, sn_tol=dict(rtol=0, atol=1e-5), bn_tol=TOL)
