"""Port dSprites steps vs ``eadgan_tpu.train`` at full width: the pxy
pretrain step (gray, colored) and the rp GAN step (gray, colored; gray
also in bf16).

Both packages start from the same numpy-seeded weights (carried across
by ``eadgan_tpu_torch.interop.from_jax``) and take the same draws, at
batch 2 on the CPU, on binary synthetic sprites.  The rp step takes its
codes and one-hots through ``fixed=`` on both sides.  Draws the JAX steps
make from ``state.rng`` (the colorize colours of both steps, the pxy
step's codes) are replayed here from the JAX state's split, as the JAX
step makes them, and handed to the port through ``fixed=``.

Each case is one run of three steps at the learning rates / 10 (one JAX
compile per case), read at step 0, after step 1 and over the three
steps.  Tolerances, with their reasons (as
``test_torch_port_step_celeba.py``):

* losses at step 0: rtol 1e-4.  Same weights and inputs, float32 on both
  sides; only summation orders differ.
* losses over the 3 steps: rtol 3e-3.  Each Adam step moves a parameter
  by about lr * sign(g); gradients near zero can take opposite signs in
  the two frameworks, and that compounds.
* parameters after step 1: within 2 * lr of each optimizer that stepped
  them (pxy: its Adam; G and E: ``opt_info``; D: ``opt_d``), and at most
  2% of a tensor (one element of a tensor under 50) beyond 1e-5.  The
  exception is the bias of each transposed conv that feeds a BatchNorm:
  its true gradient is zero, so both sides step rounding noise and only
  the 2 * lr bound holds.
* spectral-norm ``u``/``sigma`` and BatchNorm running statistics after
  step 1: 1e-4.
* bf16 (gray rp, G, D and E in bf16 on both sides, as
  ``test_torch_port_bf16.py`` holds the CelebA step): losses rtol 2e-3
  at step 0 and 1e-2 over the 3 steps.

The aligner takes no gradient: after a step its parameters have no
``.grad`` and do not require one, and D requires gradients again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.models import SpritesDiscriminator as JaxD
from eadgan_tpu.models import SpritesEncoder as JaxE
from eadgan_tpu.models import SpritesEncoderPxy as JaxPxy
from eadgan_tpu.models import SpritesGenerator as JaxG
from eadgan_tpu.train.config import PxyConfig as JaxPxyConfig
from eadgan_tpu.train.config import SpritesGanConfig as JaxGanConfig
from eadgan_tpu.train.gan_dsprites import make_sprites_gan_step as jax_make_rp_step
from eadgan_tpu.train.pretrain import make_pxy_step as jax_make_pxy_step
from eadgan_tpu.train.state import EncoderTrainState, GanTrainState, ModelVars, adam
from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
from eadgan_tpu_torch.train.config import PxyConfig, SpritesGanConfig
from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
from eadgan_tpu_torch.train.pretrain import init_pxy_state, make_pxy_step, pxy_encoder

from tests.test_torch_port_models_dsprites import FROM_FLAX, dims, sprites_flax_variables

B = 2
STEPS = 3
# the CLIs' learning rates / 10: rp (lr, d_lr) gray and colored, pxy
RP_LOW = {False: dict(lr=1e-5, d_lr=2e-5), True: dict(lr=2e-5, d_lr=2e-5)}
PXY_LOW = 2e-5
# transposed-conv biases that feed a BatchNorm: zero true gradient
_ZERO_GRAD = {"conv_block.0.bias", "conv_block.3.bias", "conv_block.6.bias"}


def sprite_batch(seed):
    """(B, 64, 64, 1) float32 sprites in {0, 1}."""
    imgs = synthetic_dsprites(n_pos=2).imgs
    idx = np.random.default_rng(seed).choice(len(imgs), B, replace=False)
    return imgs[idx][..., None].astype(np.float32)


def _color(key):
    return np.array(jax.random.uniform(key, (B, 1, 1, 3), minval=0.5, maxval=1.0))


def _to_sd(name, mv):
    return FROM_FLAX[name]({"params": mv.params, "batch_stats": mv.stats})


def _snapshot(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_params_within_adam_bound(params, ref, lr, skip=()):
    """Each parameter within 2 * lr of the JAX one, and at most 2% of
    its elements (at least one) beyond 1e-5 unless its key is in
    ``skip``."""
    for key, p in params.items():
        diff = np.abs(p.numpy() - ref[key].numpy())
        assert diff.max() <= 2 * lr, f"{key}: max |diff| {diff.max()} > {2 * lr}"
        if key not in skip:
            far = int(np.sum(diff > 1e-5))
            assert far <= max(1, 0.02 * diff.size), f"{key}: {far} of {diff.size} beyond 1e-5"


def assert_buffers_match(buffers, ref, prefix):
    for key, buf in buffers.items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(
                buf.numpy(), ref[key].numpy(), rtol=1e-4, atol=1e-4, err_msg=f"{prefix}.{key}"
            )


# --- pxy ---------------------------------------------------------------------


def run_pxy(colored, steps=STEPS, lr=PXY_LOW, seed=1):
    """``steps`` pxy steps in both packages: (jax losses, port losses,
    (jax state, port state dict) after step 1, port state)."""
    variables = sprites_flax_variables(colored, seed)["pxy"]
    code_dim = dims(colored)[1]
    imgs = sprite_batch(seed)

    jconfig = JaxPxyConfig(batch_size=B, lr=lr, code_dim=code_dim, colored=colored)
    jstep = jax_make_pxy_step(JaxPxy(out_dim=code_dim, channels=dims(colored)[0]), jconfig)
    mv = ModelVars.create(variables)
    jstate = EncoderTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed), model=mv,
        opt=adam(lr).init(mv.params),
    )
    config = PxyConfig(batch_size=B, lr=lr, code_dim=code_dim, colored=colored)
    step = make_pxy_step(config)
    state = init_pxy_state(config, device="cpu", seed=0)
    state.model.load_state_dict(FROM_FLAX["pxy"](variables))

    jax_losses, port_losses, after_1 = [], [], None
    for _ in range(steps):
        # the JAX step's own draws: split(rng, 3) -> (rng, colour, code)
        _, color_key, code_key = jax.random.split(jstate.rng, 3)
        code = jax.random.uniform(code_key, (B, code_dim), minval=-1.0, maxval=1.0)
        fixed = {"code": np.array(code)}
        if colored:
            fixed["color"] = _color(color_key)
        jstate, m = jstep(jstate, jnp.asarray(imgs))
        jax_losses.append(float(m["affine_loss"]))
        state, m = step(state, torch.from_numpy(imgs), fixed)
        port_losses.append(float(m["affine_loss"]))
        after_1 = after_1 or (jstate, _snapshot(state.model))
    return jax_losses, port_losses, after_1, state


@pytest.fixture(scope="module", params=[False, True], ids=["gray", "colored"])
def pxy_run(request):
    return run_pxy(request.param)


def test_pxy_losses_match_jax(pxy_run):
    jax_losses, port_losses, _, state = pxy_run
    assert all(np.isfinite(port_losses)) and state.step == STEPS
    np.testing.assert_allclose(port_losses[0], jax_losses[0], rtol=1e-4)
    np.testing.assert_allclose(port_losses, jax_losses, rtol=3e-3)


def test_pxy_step1_params_within_adam_bound(pxy_run):
    _, _, (jstate, sd), _ = pxy_run
    assert_params_within_adam_bound(sd, _to_sd("pxy", jstate.model), PXY_LOW)


# --- rp ----------------------------------------------------------------------


def run_rp(colored, steps=STEPS, seed=1, dtype=None):
    """``steps`` rp steps in both packages: (jax losses, port losses,
    (jax state, {model: port state dict}) after step 1, port state),
    losses as per-step dicts."""
    variables = sprites_flax_variables(colored, seed)
    channels, out_dim, code_dim = dims(colored)
    imgs = sprite_batch(seed)
    rng = np.random.default_rng(seed)
    draws = []
    for _ in range(steps):
        draws.append({
            f"{k}_{p}": v
            for p in ("d", "i")
            for k, v in (
                ("code", rng.uniform(-1, 1, (B, code_dim)).astype(np.float32)),
                ("onehot", np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]),
            )
        })

    lrs = RP_LOW[colored]
    jdtype = jnp.bfloat16 if dtype is not None else None
    jconfig = JaxGanConfig(batch_size=B, code_dim=code_dim, channels=channels, colored=colored, **lrs)
    jstep = jax_make_rp_step(
        JaxG(channels=channels, dtype=jdtype), JaxD(channels=channels, dtype=jdtype),
        JaxE(n_classes=3, code_dim=code_dim, channels=channels, dtype=jdtype),
        JaxPxy(out_dim=out_dim, channels=channels), jconfig,
    )
    g, d, e = (ModelVars.create(variables[k]) for k in ("g", "d", "e"))
    jstate = GanTrainState(
        step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(seed), g=g, d=d, e=e,
        pxy=ModelVars.create(variables["pxy"]), opt_g=None,
        opt_d=adam(jconfig.d_lr).init(d.params),
        opt_info=adam(jconfig.lr).init({"g": g.params, "e": e.params}),
    )

    config = SpritesGanConfig(batch_size=B, code_dim=code_dim, channels=channels, colored=colored, **lrs)
    pxy = pxy_encoder(colored, seed=1)
    pxy.load_state_dict(FROM_FLAX["pxy"](variables["pxy"]))
    state = init_sprites_gan_state(config, pxy, device="cpu", seed=0, dtype=dtype)
    for k in ("g", "d", "e"):
        getattr(state, k).load_state_dict(FROM_FLAX[k](variables[k]))
    step = make_sprites_gan_step(config)

    jax_losses, port_losses, after_1 = [], [], None
    for fixed in draws:
        if colored:
            # the JAX step's colour: split(rng, 4)[1]
            fixed = dict(fixed, color=_color(jax.random.split(jstate.rng, 4)[1]))
        jfixed = {k: jnp.asarray(v) for k, v in fixed.items() if k != "color"}
        jstate, m = jstep(jstate, jnp.asarray(imgs), jfixed)
        jax_losses.append({k: float(v) for k, v in m.items()})
        state, m = step(state, torch.from_numpy(imgs), fixed)
        port_losses.append({k: float(v) for k, v in m.items()})
        after_1 = after_1 or (jstate, {k: _snapshot(getattr(state, k)) for k in ("g", "d", "e")})
    return jax_losses, port_losses, after_1, state


def _assert_losses(jax_losses, port_losses, rtol):
    for s, (a, b) in enumerate(zip(jax_losses, port_losses)):
        assert set(a) == set(b) and len(a) == 6
        for k in a:
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=f"step {s} {k}")


@pytest.fixture(scope="module", params=[False, True], ids=["gray", "colored"])
def rp_run(request):
    return request.param, run_rp(request.param)


def test_rp_losses_match_jax(rp_run):
    _, (jax_losses, port_losses, _, state) = rp_run
    _assert_losses(jax_losses[:1], port_losses[:1], rtol=1e-4)
    _assert_losses(jax_losses, port_losses, rtol=3e-3)
    assert state.step == STEPS


def _split(sd):
    params = {k: v for k, v in sd.items() if not k.endswith(_BUFFERS)}
    return params, {k: v for k, v in sd.items() if k.endswith(_BUFFERS)}


_BUFFERS = (".u", ".sigma", "running_mean", "running_var", "num_batches_tracked")


def test_rp_step1_params_within_adam_bound(rp_run):
    colored, (_, _, (jstate, sds), _) = rp_run
    lr, d_lr = RP_LOW[colored]["lr"], RP_LOW[colored]["d_lr"]
    for name, lr in (("g", lr), ("e", lr), ("d", d_lr)):
        params, _ = _split(sds[name])
        skip = _ZERO_GRAD if name == "g" else ()
        assert_params_within_adam_bound(params, _to_sd(name, getattr(jstate, name)), lr, skip)


def test_rp_step1_sn_and_bn_state(rp_run):
    _, (_, _, (jstate, sds), _) = rp_run
    for name in ("g", "d", "e"):
        _, buffers = _split(sds[name])
        assert buffers
        assert_buffers_match(buffers, _to_sd(name, getattr(jstate, name)), name)


def test_rp_aligner_takes_no_gradient(rp_run):
    _, (_, _, (jstate, _), state) = rp_run
    assert not state.pxy.training
    for p in state.pxy.parameters():
        assert p.grad is None and not p.requires_grad
    # the aligner is unchanged: its weights are still the JAX state's
    ref = _to_sd("pxy", jstate.pxy)
    for key, p in state.pxy.named_parameters():
        assert torch.equal(p, ref[key]), key
    assert all(p.requires_grad for p in state.d.parameters())
    assert state.opt_g is None


def test_rp_bf16_step_matches_jax_bf16():
    jax_losses, port_losses, _, state = run_rp(False, dtype=torch.bfloat16)
    for s, (a, b) in enumerate(zip(jax_losses, port_losses)):
        rtol = 2e-3 if s == 0 else 1e-2
        for k in a:
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], rtol=rtol, err_msg=f"step {s} {k}")
    for model in (state.g, state.d, state.e):
        dtypes = {t.dtype for t in [*model.parameters(), *model.buffers()] if t.is_floating_point()}
        assert dtypes == {torch.float32}
    for st in state.opt_info.state.values():
        assert st["exp_avg"].dtype == torch.float32
