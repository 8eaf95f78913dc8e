"""The train steps' Adam (``train/state.py::FusedAdam``) on the CPU, where
it runs the kernel's plain version (``ops/adam_cuda.py::adam_plain``):

* five steps of CelebA's three optimizers, ``opt_g`` over G's shapes,
  ``opt_d`` over D's and ``opt_info`` over the same tensors of both, in
  the train step's order, against ``torch.optim.Adam`` doing the same;
* a parameter whose grad is None is skipped, as torch skips it;
* the state keeps ``torch.optim.Adam``'s layout, so it round trips
  through ``train/checkpoint.py`` and ``interop/jax_state.py`` and a
  restored optimizer steps on as the saved one would;
* ``parallel.ZeroAdam`` builds its slices' optimizer as a ``FusedAdam``
  and steps bit-equal to the replicated one in a group of one;
* torch's global step hooks, which the replayed step's stamps use,
  bracket its step; every trainer's optimizer fits one launch; what the
  kernel does not take raises.

Tolerances against torch's Adam: torch updates the first moment by
``lerp`` and this Adam by ``b1 m + (1 - b1) g`` (the kernel's form), so
the moments part by a few float32 roundings a step: 1e-5 of the largest
moment.  The parameters start within [-1, 1] and move ~lr (1e-3, 2e-4)
a step; over five steps they part by a few ulps of 1 (1.2e-7 each), so
1e-6 absolute, three orders under one step's update.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from eadgan_tpu_torch import parallel
from eadgan_tpu_torch.interop.jax_state import state_from_jax, state_to_jax
from eadgan_tpu_torch.ops import adam_cuda
from eadgan_tpu_torch.train import checkpoint as ckpt
from eadgan_tpu_torch.train.config import (ApproximatorConfig, CelebaConfig, MnistConfig, PxyConfig,
                                           SpritesGanConfig)
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state
from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state
from eadgan_tpu_torch.train.gan_mnist import init_mnist_gan_state
from eadgan_tpu_torch.train.pretrain import (approximator_model, init_approximator_state,
                                             init_pxy_state, make_pxy_step, pxy_encoder)
from eadgan_tpu_torch.train.state import FusedAdam, adam

STEPS = 5


def _celeba_shapes():
    state = init_celeba_gan_state(CelebaConfig(), device="cpu")
    return ([tuple(p.shape) for p in state.g.parameters()],
            [tuple(p.shape) for p in state.d.parameters()])


@pytest.fixture(scope="module")
def celeba_shapes():
    return _celeba_shapes()


def _trio(make, g, d, config=CelebaConfig()):
    """CelebA's three optimizers over ``g`` and ``d``, made by ``make``."""
    return {"opt_g": make(g, config.g_lr), "opt_d": make(d, config.d_lr),
            "opt_info": make([*g, *d], config.info_lr)}


def _close(got, want, rel=None, atol=None):
    gap = (got - want).abs().max().item()
    bar = rel * want.abs().max().item() if rel is not None else atol
    assert gap <= bar, f"{gap} > {bar}"


@pytest.mark.parametrize("name", ["opt_g", "opt_d", "opt_info"])
def test_plain_version_matches_torch_adam_on_celeba_shapes(celeba_shapes, name):
    """Five steps of the three optimizers in the step's order, fresh
    gradients before each, over shared tensors: ``name``'s moments and
    step counts, and every parameter, against torch's Adam."""
    gen = torch.Generator().manual_seed(0)
    g_shapes, d_shapes = celeba_shapes
    g = [torch.rand(s, generator=gen) * 2 - 1 for s in g_shapes]
    d = [torch.rand(s, generator=gen) * 2 - 1 for s in d_shapes]
    ours = [t.clone().requires_grad_() for t in (*g, *d)]
    theirs = [t.clone().requires_grad_() for t in (*g, *d)]
    n = len(g)
    mine = _trio(lambda ps, lr: adam(ps, lr), ours[:n], ours[n:])
    ref = _trio(lambda ps, lr: torch.optim.Adam(ps, lr=lr, betas=(0.5, 0.999), eps=1e-8),
                theirs[:n], theirs[n:])
    assert all(type(o) is FusedAdam for o in mine.values())
    for _ in range(STEPS):
        for key in ("opt_g", "opt_d", "opt_info"):
            for a, b in zip(ours, theirs):
                a.grad = torch.randn(a.shape, generator=gen) * 1e-2
                b.grad = a.grad.clone()
            mine[key].step()
            ref[key].step()
    for a, b in zip(ours, theirs):
        _close(a.detach(), b.detach(), atol=1e-6)
    for a, b in zip(mine[name].param_groups[0]["params"], ref[name].param_groups[0]["params"]):
        st, rt = mine[name].state[a], ref[name].state[b]
        assert st.keys() == rt.keys() == {"step", "exp_avg", "exp_avg_sq"}
        assert st["step"].dtype == rt["step"].dtype and float(st["step"]) == float(rt["step"]) == STEPS
        _close(st["exp_avg"], rt["exp_avg"], rel=1e-5)
        _close(st["exp_avg_sq"], rt["exp_avg_sq"], rel=1e-5)


def test_none_grads_are_skipped():
    """A parameter without a grad keeps its value and gets no state; one
    whose grad goes missing later keeps its moments and step count."""
    a, b = (torch.nn.Parameter(torch.randn(4, 3)) for _ in range(2))
    opt = adam([a, b], 1e-3)
    a.grad = torch.randn(4, 3)
    before = b.detach().clone()
    opt.step()
    assert torch.equal(b.detach(), before) and b not in opt.state
    assert float(opt.state[a]["step"]) == 1
    kept = {k: v.clone() for k, v in opt.state[a].items()}
    a.grad, b.grad = None, torch.randn(4, 3)
    opt.step()
    assert all(torch.equal(opt.state[a][k], v) for k, v in kept.items())
    assert float(opt.state[b]["step"]) == 1


def _pxy_run(state, steps, seed=0):
    config = PxyConfig(batch_size=2)
    step = make_pxy_step(config)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        step(state, torch.from_numpy(rng.integers(0, 2, (2, 64, 64, 1)).astype(np.float32)))
    return state


def _equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("route", ["checkpoint", "jax_state"])
def test_state_round_trips(route, tmp_path):
    """Two pxy steps; the state written and read back through ``route``
    into a fresh state holds the same payload, keeps ``torch.optim.Adam``'s
    layout and steps on bit-equal to the state it was saved from."""
    config = PxyConfig(batch_size=2)
    state = _pxy_run(init_pxy_state(config, device="cpu", seed=0), 2)
    fresh = init_pxy_state(config, device="cpu", seed=1)
    payload = ckpt.train_state_payload(state)
    torch_layout = torch.optim.Adam(list(state.model.parameters()), lr=1.0).state_dict()
    assert payload["opt"]["param_groups"][0].keys() == torch_layout["param_groups"][0].keys()
    if route == "checkpoint":
        ckpt.restore_train_state(ckpt.save_train_state(str(tmp_path), "s", 2, state), fresh)
    else:
        ckpt._apply(fresh, state_from_jax(state_to_jax(state, payload), fresh))
    assert type(fresh.opt) is FusedAdam
    assert _equal(ckpt.train_state_payload(fresh)["opt"], payload["opt"])
    fresh.rng.set_state(state.rng.get_state())
    _pxy_run(state, 2, seed=1)
    _pxy_run(fresh, 2, seed=1)
    assert _equal(ckpt.train_state_payload(fresh), ckpt.train_state_payload(state))


@pytest.fixture
def world1():
    """A gloo group of one process, destroyed after the test."""
    assert not dist.is_initialized()
    device = parallel.join_local("cpu")
    yield device
    dist.destroy_process_group()


def test_zero_adam_over_fused_adam(world1):
    """``ZeroAdam`` builds its slices' optimizer as a ``FusedAdam`` (the
    replicated optimizer's type) and, in a group of one, steps bit-equal
    to it; two ranks' slices of a stepped state tile its moments."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(*s)) for s in ((64, 32, 4, 4), (16, 128), (8,))]
    twins = [torch.nn.Parameter(p.detach().clone()) for p in params]
    plain, zero = adam(params, 1e-3), parallel.ZeroAdam(adam(twins, 1e-3))
    assert type(zero.inner) is FusedAdam
    for _ in range(3):
        for p, t in zip(params, twins):
            p.grad = torch.randn(p.shape)
            t.grad = p.grad.clone()
        plain.step()
        zero.step()
    assert all(torch.equal(p, t) for p, t in zip(params, twins))
    assert _equal(zero.state_dict()["state"], plain.state_dict()["state"])
    ranks = [parallel.ZeroAdam(plain, rank=r, world=2) for r in range(2)]
    for i, p in enumerate(params):
        d = parallel.zero_spec(p.shape, 2)
        parts = [z.inner.state[z.shards[i]]["exp_avg"] for z in ranks]
        assert torch.equal(plain.state[p]["exp_avg"], parts[0] if d is None else torch.cat(parts, d))


def test_global_step_hooks_bracket_the_step():
    from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                       register_optimizer_step_pre_hook)

    p = torch.ones(3)
    p.grad = torch.ones(3)
    opt, seen = adam([p], 1e-3), []
    pre = register_optimizer_step_pre_hook(lambda o, *_: seen.append(("pre", p[0].item())))
    post = register_optimizer_step_post_hook(lambda o, *_: seen.append(("post", p[0].item())))
    try:
        opt.step()
    finally:
        pre.remove()
        post.remove()
    assert [k for k, _ in seen] == ["pre", "post"] and seen[0][1] == 1.0 and seen[1][1] < 1.0


def _optimizers():
    states = [
        init_celeba_gan_state(CelebaConfig(), device="cpu"),
        init_sprites_gan_state(SpritesGanConfig(), pxy_encoder(False, seed=1), device="cpu"),
        init_sprites_gan_state(SpritesGanConfig.for_dataset(True), pxy_encoder(True, seed=1),
                               device="cpu"),
        init_mnist_gan_state(MnistConfig(), approximator_model(0), device="cpu"),
        init_pxy_state(PxyConfig(), device="cpu"),
        init_pxy_state(PxyConfig.for_dataset(True), device="cpu"),
        init_approximator_state(ApproximatorConfig(), device="cpu"),
    ]
    return [getattr(s, k) for s in states for k in ("opt_g", "opt_d", "opt_info", "opt")
            if getattr(s, k, None) is not None]


def test_every_trainers_optimizer_fits_one_launch():
    """Each optimizer the trainers build is a ``FusedAdam`` of one group
    whose tensors fit one kernel launch, and is capturable only on the
    card."""
    opts = _optimizers()
    assert len(opts) == 13
    for opt in opts:
        assert type(opt) is FusedAdam and len(opt.param_groups) == 1
        assert len(opt.param_groups[0]["params"]) <= adam_cuda.MAX_TENSORS
        assert opt.param_groups[0]["capturable"] is False


@pytest.mark.parametrize("setting,match", [
    ({"weight_decay": 0.1}, "weight_decay"), ({"amsgrad": True}, "amsgrad"),
    ({"maximize": True}, "maximize")])
def test_what_the_kernel_does_not_take_raises(setting, match):
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.ones(3)
    with pytest.raises(ValueError, match=match):
        FusedAdam([p], lr=1e-3, **setting).step()


@pytest.mark.parametrize("n,device,match", [
    (1, "cpu", "CUDA"), (adam_cuda.MAX_TENSORS + 1, "meta", "at most")])
def test_kernel_wrapper_refuses(n, device, match):
    """The wrapper takes CUDA tensors only, and no more than one launch's."""
    t = [torch.zeros(4, device=device) for _ in range(n)]
    steps = [torch.zeros((), device=device) for _ in range(n)]
    with pytest.raises(ValueError, match=match):
        adam_cuda.adam_cuda(t, t, t, t, steps, 1e-3, 0.5, 0.999, 1e-8,
                            torch.zeros(1, dtype=torch.int32, device=device))
