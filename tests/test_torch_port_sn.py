"""The spectral norm's plain version and wrapper (``ops/sn_cuda.py``) on
the CPU.

The backward's closed form, ``G / s + (c u') v^T`` with ``c = -(sum(G *
W) / s) / s`` (``spectral_norm_grad_plain``, the kernels' arithmetic in
torch), against autograd through the layers' expression
(``spectral_norm_plain``), in float64 at CelebA's discriminator shapes
and every shape the rp, colored rp and MNIST steps normalize, and with
sigma 0.  The wrapper's routing: a CPU weight takes the plain version,
bit for bit what the layers computed before the kernels, in float32 and
bf16 and in eval mode; a model-sharded layer keeps its torch path and
never calls the wrapper; a weight on neither the CPU nor a card is
refused.  A step's spectral-norm calls (``tools/sn_bench.py::census``):
CelebA 24 forwards and 20 backwards, rp 39 and 33, and the launches
they make on the card by size.
"""

import types

import pytest
import torch

from eadgan_tpu_torch.models import layers
from eadgan_tpu_torch.models.layers import SNConv, SNDense, no_stat_updates
from eadgan_tpu_torch.ops import sn_cuda

SHAPES = [(128, 3, 4, 4), (256, 128, 4, 4), (512, 256, 4, 4), (1024, 512, 4, 4),
          (32, 1, 4, 4), (32, 3, 4, 4), (32, 32, 4, 4), (64, 32, 4, 4), (64, 64, 4, 4),
          (128, 1024), (128, 128), (3, 128), (4, 128), (7, 128),
          (16, 1, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3), (1, 512), (10, 512),
          (62, 512)]


def _inputs(shape, seed=0, zero=False):
    gen = torch.Generator().manual_seed(seed)
    fan_in = torch.Size(shape[1:]).numel()
    w = (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) / fan_in**0.5
    if zero:
        w = torch.zeros_like(w)
    u = sn_cuda.l2n(torch.randn(shape[0], generator=gen, dtype=torch.float64))
    g = torch.randn(shape, generator=gen, dtype=torch.float64)
    return w.requires_grad_(), u, g


def _vectors(w, u):
    """The plain version's v, u' and sigma from ``u``, as the kernels hand
    them to their backward."""
    w_mat = w.detach().reshape(w.shape[0], -1)
    v = sn_cuda.l2n(u @ w_mat)
    u_new = sn_cuda.l2n(w_mat @ v)
    return v, u_new, torch.dot(w_mat @ v, u_new)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_closed_form_backward_matches_autograd(shape):
    w, u, g = _inputs(shape)
    out = sn_cuda.spectral_norm_plain(w, u.clone(), torch.ones((), dtype=torch.float64))
    (auto,) = torch.autograd.grad(out, w, g)
    v, u_new, sigma = _vectors(w, u)
    closed = sn_cuda.spectral_norm_grad_plain(g, w.detach(), u_new, v, sigma)
    assert closed.shape == w.shape
    torch.testing.assert_close(closed, auto, rtol=1e-12, atol=1e-12 * auto.abs().max().item())


@pytest.mark.parametrize("shape", [(32, 32, 4, 4), (512, 256, 4, 4)], ids=["small", "large"])
def test_closed_form_backward_with_sigma_zero_is_the_gradient(shape):
    w, u, g = _inputs(shape, zero=True)
    out = sn_cuda.spectral_norm_plain(w, u.clone(), torch.ones((), dtype=torch.float64))
    (auto,) = torch.autograd.grad(out, w, g)
    v, u_new, sigma = _vectors(w, u)
    assert float(sigma) == 0.0
    closed = sn_cuda.spectral_norm_grad_plain(g, w.detach(), u_new, v, sigma)
    assert torch.equal(closed, g) and torch.equal(auto, g)


def _old_normalized_weight(layer):
    """What ``_SpectralNorm.normalized_weight`` computed unsharded before
    the kernels, then the layer's cast to its compute type."""
    w = layer.weight
    w_mat = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = sn_cuda.l2n(layer.u @ w_mat)
        u = sn_cuda.l2n(w_mat @ v)
    sigma = torch.dot(w_mat @ v, u)
    if layer.training and layer.update_stats:
        with torch.no_grad():
            layer.u.copy_(u)
            layer.sigma.copy_(sigma)
    out = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
    return out if layer.compute_dtype is None else out.to(layer.compute_dtype)


@pytest.mark.parametrize("mode", ["train", "eval", "no_stat_updates"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("make", [lambda dt: SNConv(32, 64, 4, 2, 1, dtype=dt),
                                  lambda dt: SNDense(1024, 128, dtype=dt)], ids=["conv", "dense"])
def test_cpu_layer_takes_the_plain_version_bit_for_bit(make, dtype, mode):
    torch.manual_seed(0)
    layer = make(dtype)
    twin = make(dtype)
    twin.load_state_dict(layer.state_dict())
    layer.train(mode != "eval")
    twin.train(mode != "eval")
    x = torch.randn(2, 32, 8, 8) if isinstance(layer, SNConv) else torch.randn(2, 1024)
    g = None
    for _ in range(2):  # the second call starts from the first's stored u
        if mode == "no_stat_updates":
            with no_stat_updates(layer), no_stat_updates(twin):
                got, want = layer.normalized_weight(), _old_normalized_weight(twin)
        else:
            got, want = layer.normalized_weight(), _old_normalized_weight(twin)
        assert got.dtype == (dtype or torch.float32) and torch.equal(got, want)
        g = torch.randn(got.shape).to(got.dtype)
        (a,) = torch.autograd.grad(got, layer.weight, g)
        (b,) = torch.autograd.grad(want, twin.weight, g)
        assert torch.equal(a, b)
    assert torch.equal(layer.u, twin.u) and torch.equal(layer.sigma, twin.sigma)
    assert torch.equal(layer(x), twin.conv(x, _old_normalized_weight(twin))
                       if isinstance(twin, SNConv) else twin.linear(x, _old_normalized_weight(twin)))


def test_cpu_weight_routes_to_the_plain_version(monkeypatch):
    seen = []
    monkeypatch.setattr(sn_cuda, "spectral_norm_plain",
                        lambda *a, **k: seen.append(a) or torch.zeros(()))
    monkeypatch.setattr(sn_cuda._SpectralNorm, "apply",
                        lambda *a: pytest.fail("a CPU weight reached the kernels"))
    layer = SNConv(3, 8, 4, 2, 1)
    sn_cuda.spectral_norm(layer.weight, layer.u, layer.sigma, None, True)
    assert len(seen) == 1 and seen[0][0] is layer.weight


def test_weight_on_no_cpu_or_card_is_refused():
    w = torch.zeros(8, 4, device="meta")
    with pytest.raises(ValueError, match="need a CUDA tensor"):
        sn_cuda.spectral_norm(w, torch.zeros(8, device="meta"), torch.ones((), device="meta"))


@pytest.mark.parametrize("make", [lambda: SNConv(4, 8, 4, 2, 1), lambda: SNDense(16, 8)],
                         ids=["conv", "dense"])
def test_sharded_layer_keeps_its_torch_path(monkeypatch, make):
    """A model-sharded layer (a group of one here: the collectives are
    the identity) takes the torch path it had, never the wrapper, and
    returns float32 W / sigma as before."""
    monkeypatch.setattr(layers, "spectral_norm",
                        lambda *a, **k: pytest.fail("a sharded layer reached the wrapper"))
    for name in ("reduce_from_model", "copy_to_model"):
        monkeypatch.setattr(layers, name, lambda x, mesh: x)
    monkeypatch.setattr(layers, "gather_from_model", lambda x, dim, mesh: x)
    torch.manual_seed(0)
    layer = make()
    twin = make()
    twin.load_state_dict(layer.state_dict())
    twin.compute_dtype = None
    layer.model_shard = types.SimpleNamespace(mesh=None, rows=slice(None))
    got = layer.normalized_weight()
    want = _old_normalized_weight(twin)
    assert got.dtype == torch.float32 and torch.allclose(got, want, rtol=1e-6, atol=0)
    assert torch.allclose(layer.sigma, twin.sigma, rtol=1e-6)


def test_step_census_and_launches():
    """One CelebA and one gray rp step (bf16, batch 4): the spectral-norm
    calls each layer makes, and the launches they make on the card."""
    from eadgan_tpu_torch.tools.sn_bench import census, launches_per_step

    celeba, rp = census("celeba", 4), census("rp", 4)
    assert [(c["forward"], c["backward"]) for c in celeba] == [(6, 5)] * 4
    assert [c["shape"] for c in celeba] == [[128, 3, 4, 4], [256, 128, 4, 4], [512, 256, 4, 4],
                                            [1024, 512, 4, 4]]
    assert sum(c["forward"] for c in rp) == 39 and sum(c["backward"] for c in rp) == 33
    for layers_ in (celeba, rp):
        want = 0
        for c in layers_:
            one = torch.Size(c["shape"]).numel() <= sn_cuda.ONE_BLOCK_MAX
            want += c["forward"] * (1 if one else 3) + c["backward"] * (1 if one else 2)
        assert launches_per_step(layers_) == want
