"""The port's reference-checkpoint interop (``eadgan_tpu_torch.interop.
torch_import`` / ``torch_export`` and the ``cli.import_torch`` /
``cli.export_torch`` CLIs) against the JAX package's and against the
reference torch modules.

Every kind: a reference module (seeded torch init, its spectral-norm
vectors moved by a few train-mode forwards) is imported by the port and
by the JAX package (carried into the port by ``interop.from_jax``); the
two state dicts agree within 1e-6.  The imported port model's eval
output matches the reference module's within 2e-3 (the JAX import
tests' bar).  Exported (from flax variables whose stored ``u`` is moved
off the unit-sigma solution, carried into the port by ``from_jax``),
the port's reference state dict agrees with the JAX export within 1e-6,
and loaded into the reference module it gives the port model's output
within 2e-3.
"""

import copy
import functools

import numpy as np
import pytest
import torch

from test_torch_export import TorchMnistD, _bn_train
from test_torch_import import (
    TorchApprox,
    TorchCelebaD,
    TorchCelebaG,
    TorchMnistE,
    TorchMnistG,
    TorchSpritesD,
    TorchSpritesE,
    TorchSpritesG,
    TorchSpritesPxy,
    _to_sn_equilibrium,
)

import eadgan_tpu.interop as jax_interop
from eadgan_tpu_torch import interop as port_interop
from eadgan_tpu_torch.cli.export_torch import main as export_main
from eadgan_tpu_torch.cli.import_torch import KINDS
from eadgan_tpu_torch.cli.import_torch import main as import_main
from eadgan_tpu_torch.interop.torch_export import export_state_dict
from tests.test_torch_port_jax_files import drop_big_files

TOL_WEIGHTS = 1e-6
TOL_OUT = 2e-3
TOL_EQUILIBRIUM = 1e-4


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


def _g(seed):
    return torch.Generator().manual_seed(seed)


# kind: (reference module, its inputs, the kind's name in the JAX package)
CASES = {
    "approximator": (TorchApprox, lambda g: (torch.randn(4, 6, generator=g),), "approximator"),
    "mnist_generator": (
        TorchMnistG,
        lambda g: (torch.randn(4, 62, generator=g), torch.rand(4, 10, generator=g),
                   torch.rand(4, 7, generator=g)),
        "mnist_generator",
    ),
    "mnist_encoder": (TorchMnistE, lambda g: (torch.rand(4, 1, 32, 32, generator=g) * 2 - 1,),
                      "mnist_encoder"),
    "mnist_discriminator": (TorchMnistD, lambda g: (torch.rand(4, 1, 32, 32, generator=g) * 2 - 1,),
                            "mnist_discriminator"),
    "sprites_encoder_pxy": (TorchSpritesPxy, lambda g: (torch.rand(4, 1, 64, 64, generator=g),),
                            "sprites_encoder_pxy"),
    "sprites_generator": (TorchSpritesG, lambda g: (torch.randn(4, 7, generator=g),),
                          "sprites_generator"),
    "sprites_discriminator": (TorchSpritesD, lambda g: (torch.rand(4, 1, 64, 64, generator=g),),
                              "sprites_discriminator"),
    "sprites_encoder": (TorchSpritesE, lambda g: (torch.rand(4, 1, 64, 64, generator=g),),
                        "sprites_encoder"),
    "celeba_generator": (
        TorchCelebaG,
        lambda g: (torch.randn(2, 200, generator=g), torch.rand(2, 10, generator=g),
                   torch.rand(2, 8, generator=g)),
        "celeba_generator",
    ),
    "celeba_discriminator": (TorchCelebaD, lambda g: (torch.rand(2, 3, 64, 64, generator=g) * 2 - 1,),
                             "celeba_discriminator"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_blas_thread():
    """The importers' SVDs and power iterations in one BLAS thread: the
    test runs beside other test processes, and numpy's default of one
    thread a core each oversubscribes the host."""
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        yield
        return
    with threadpool_limits(limits=1, user_api="blas"):
        yield


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """A reference module of ``kind`` (seeded init; spectral-norm vectors
    and BatchNorm statistics moved by 3 train-mode forwards), its numpy
    state dict and inputs, and the JAX package's import of it (flax
    variables), made once: an import takes an SVD of every spectral-norm
    kernel.  Callers copy what they change."""
    cls, inputs, _ = CASES[kind]
    torch.manual_seed(0)
    t = cls()
    x = inputs(_g(1))
    t.train()
    with torch.no_grad():
        for _ in range(3):
            t(*x)
    t.eval()
    if kind == "mnist_encoder":
        _bn_train(t)  # batch-statistics BN, as the port's MNIST encoder (and the JAX one)
    sd = {k: v.numpy().copy() for k, v in t.state_dict().items()}
    return t, sd, x, getattr(jax_interop, f"import_{CASES[kind][2]}")(sd)


def _port_model(kind, state_dict):
    model = KINDS[kind][0](False)
    model.load_state_dict(state_dict)
    return model.eval()


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _close_outputs(got, want, tol):
    for a, b in zip(_outputs(got), _outputs(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=tol, atol=tol)


def _from_jax(kind, variables):
    return getattr(port_interop, f"{CASES[kind][2]}_from_flax")(variables)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_import_equals_jax_import_and_reference_output(kind):
    t, sd, x, variables = _reference(kind)
    port_sd = getattr(port_interop, f"import_{kind}")(sd)
    carried = _from_jax(kind, variables)
    assert set(port_sd) == set(_port_model(kind, port_sd).state_dict())
    for key, value in port_sd.items():
        if key.endswith("num_batches_tracked"):
            # the port keeps the reference's count; the JAX package has none
            assert int(value) == int(sd[key]), key
            continue
        np.testing.assert_allclose(value.numpy(), carried[key].numpy(), rtol=0,
                                   atol=TOL_WEIGHTS, err_msg=key)
    with torch.no_grad():
        _close_outputs(_port_model(kind, port_sd)(*x), t(*x), TOL_OUT)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_export_equals_jax_export_and_loads_into_reference(kind):
    _, _, x, variables = _reference(kind)
    variables = copy.deepcopy(variables)
    # move each stored u off the unit-sigma solution, so the export's power
    # step from it matters
    g = np.random.default_rng(9)
    for stats in variables.get("batch_stats", {}).values():
        for name, u in stats.get("SpectralNorm_0", {}).items():
            if name.endswith("/u"):
                stats["SpectralNorm_0"][name] = u + 0.05 * g.standard_normal(u.shape).astype(u.dtype)
    port_sd = _from_jax(kind, variables)
    ours = export_state_dict(port_sd)
    theirs = getattr(jax_interop, f"export_{CASES[kind][2]}")(variables)
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        np.testing.assert_allclose(ours[key], value, rtol=0, atol=TOL_WEIGHTS, err_msg=key)
    ref = CASES[kind][0]()
    ref.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ours.items()})
    ref.eval()
    if kind == "mnist_encoder":
        _bn_train(ref)
    with torch.no_grad():
        _close_outputs(ref(*x), _port_model(kind, port_sd)(*x), TOL_OUT)


@pytest.mark.parametrize("kind", ["sprites_encoder", "celeba_discriminator"])
def test_import_at_sn_equilibrium(kind):
    """Long SN training drives every singular value toward 1 while torch's
    eval sigma stays its stored-uv Rayleigh quotient != s1; the import
    must still match the torch eval forward to 1e-4 (no re-convergence)."""
    _, sd, x, _ = _reference(kind)
    sd = _to_sn_equilibrium({k: v.copy() for k, v in sd.items()},
                            seed=7 if kind == "sprites_encoder" else 11)
    t = CASES[kind][0]()
    t.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()})
    t.eval()
    port = _port_model(kind, getattr(port_interop, f"import_{kind}")(sd))
    with torch.no_grad():
        _close_outputs(port(*x), t(*x), TOL_EQUILIBRIUM)


def test_cli_round_trips(tmp_path, monkeypatch):
    """import_torch then export_torch through the CLIs: a plain kind, a
    colored kind and the CelebA checkpoint; each output loads into its
    consumer and gives the reference module's outputs."""
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    torch.manual_seed(0)
    for colored in (False, True):
        c = 3 if colored else 1
        t = TorchSpritesE(channels=c, code_dim=7 if colored else 4)
        x = torch.rand(2, c, 64, 64, generator=_g(c))
        with torch.no_grad():  # power steps, as training takes them
            for _ in range(3):
                t(x)
        t.eval()
        src, port, back = (str(tmp_path / f"{n}_{c}.pt") for n in ("ref", "port", "back"))
        torch.save(t.state_dict(), src)
        flag = ["--colored"] if colored else []
        import_main(["--kind", "sprites_encoder", "--input", src, "--output", port, *flag])
        model = KINDS["sprites_encoder"][0](colored)
        model.load_state_dict(torch.load(port, weights_only=True))
        with torch.no_grad():
            _close_outputs(model.eval()(x), t(x), TOL_OUT)
        export_main(["--kind", "sprites_encoder", "--input", port, "--output", back, *flag])
        t2 = TorchSpritesE(channels=c, code_dim=7 if colored else 4)
        t2.load_state_dict(torch.load(back, weights_only=True))
        with torch.no_grad():
            _close_outputs(t2.eval()(x), t(x), TOL_OUT)

    (g, _, z, _), (d, _, (img,), _) = (_reference(k) for k in ("celeba_generator",
                                                              "celeba_discriminator"))
    tar, port, back = (str(tmp_path / n) for n in ("checkpoint_7.tar", "port.tar", "back.tar"))
    torch.save({"generator_state_dict": g.state_dict(), "discriminator_state_dict": d.state_dict(),
                "epoch": 1, "batches_done": 7}, tar)
    import_main(["--kind", "celeba_checkpoint", "--input", tar, "--output", port])
    ckpt = torch.load(port, weights_only=True)
    assert (ckpt["epoch"], ckpt["batches_done"]) == (1, 7)
    export_main(["--kind", "celeba_checkpoint", "--input", port, "--output", back])
    ref = torch.load(back, weights_only=True)
    assert (ref["epoch"], ref["batches_done"]) == (1, 7)
    g2, d2 = TorchCelebaG(), TorchCelebaD()
    g2.load_state_dict(ref["generator_state_dict"])
    d2.load_state_dict(ref["discriminator_state_dict"])
    # the port's checkpoint holds the generator ``cli.gen_imgs`` loads
    port_g = KINDS["celeba_generator"][0](False)
    port_g.load_state_dict(ckpt["generator_state_dict"])
    with torch.no_grad():
        _close_outputs(g2.eval()(*z), g(*z), TOL_OUT)
        _close_outputs(d2.eval()(img), d(img), TOL_OUT)
        _close_outputs(port_g.eval()(*z), g(*z), TOL_OUT)


def test_cli_refuses_other_kinds_and_needs_a_device(tmp_path, monkeypatch):
    src = str(tmp_path / "pxy.pt")
    torch.save(TorchSpritesPxy().state_dict(), src)
    monkeypatch.delenv("EADGAN_PLATFORM", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            import_main(["--kind", "sprites_encoder_pxy", "--input", src, "--output", "x.pt"])
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="really a 'mnist_generator'"):
        import_main(["--kind", "mnist_generator", "--input", src, "--output", "x.pt"])
    with pytest.raises(SystemExit, match="does not fit the port's 'sprites_encoder_pxy'"):
        import_main(["--kind", "sprites_encoder_pxy", "--input", src, "--output", "x.pt",
                     "--colored"])
    with pytest.raises(SystemExit, match="not a reference CelebA"):
        import_main(["--kind", "celeba_checkpoint", "--input", src, "--output", "y"])
