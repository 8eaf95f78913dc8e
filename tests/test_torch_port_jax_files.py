"""The JAX package's checkpoint files in the port: the flax msgpack codec
(``interop/flax_msgpack.py``), the model maps back to flax
(``interop/to_jax.py``), the train-state map (``interop/jax_state.py``),
the format-sniffing readers of ``train/checkpoint.py`` and the CLIs that
read model files.

The JAX package writes every file with its own functions
(``save_train_state``, ``save_model``, ``save_pytree``) after one real
JAX step of each of the seven trainers, at batch 2 on the CPU, so the
Adam moments are non-zero; nothing is committed.  Exact checks:

* the port's ``packb`` gives the bytes of ``flax.serialization.to_bytes``
  (drawn trees of the subset flax emits, a chunked leaf among them with
  the chunk size patched small; every trainer's train state and model
  files), and its ``unpackb`` the tree of ``msgpack_restore``;
* each train state restored by the port equals ``from_jax`` of the JAX
  state tensor for tensor, and the port writes it back to the JAX
  file's bytes (the key as ``interop/jax_state.py`` states it);
* each model file read by its port CLI equals ``from_jax`` of the model.

One port step from the restored state against the JAX step from the same
state, with the same draws (``fixed=``, or the JAX step's own draws
replayed), holds the step-parity tests' tolerances
(``test_torch_port_step_celeba.py``, ``..._step_dsprites.py``,
``..._step_mnist.py``): losses rtol 1e-4 (same weights and inputs,
float32 on both sides); each parameter within 2 x the summed learning
rates of the optimizers that step it, with at most 2% of a tensor beyond
1e-5 (the transposed-conv biases before a BatchNorm, whose true gradient
is zero, excepted); spectral-norm ``u``/``sigma`` and BatchNorm
statistics within 1e-4.

Disk: the CelebA train state (~0.52 GB a format) goes through memory
only, built once; a file a test writes is deleted when the test ends if
it is above 8 MB.
"""

import copy
import dataclasses
import io
import os
import pathlib
import struct
from typing import Any, Callable, Dict, Tuple
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as ser
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from eadgan_tpu import models as jm
from eadgan_tpu.interop import torch_export as jax_te
from eadgan_tpu.train import checkpoint as jck
from eadgan_tpu.train import config as jcfg
from eadgan_tpu.train import gan_celeba as jax_celeba
from eadgan_tpu.train import gan_dsprites as jax_dsprites
from eadgan_tpu.train import gan_mnist as jax_mnist
from eadgan_tpu.train import pretrain as jax_pretrain
from eadgan_tpu_torch.cli import common, export_torch, gen_imgs, generate_image, mnist, rp, rp_color, score
from eadgan_tpu_torch.interop import flax_msgpack as fm
from eadgan_tpu_torch import models as pm
from eadgan_tpu_torch.interop import from_jax, jax_state, to_jax
from eadgan_tpu_torch.models import CelebaGenerator, MnistGenerator
from eadgan_tpu_torch.train import checkpoint as ck
from eadgan_tpu_torch.train import config as pcfg
from eadgan_tpu_torch.train import gan_celeba, gan_dsprites, gan_mnist, pretrain

from tests.test_torch_port_step_dsprites import assert_buffers_match, assert_params_within_adam_bound

B = 2
BIG = 8 * 2**20  # no test leaves a file above this on disk
CELEBA_LR = dict(g_lr=1e-3, d_lr=2e-4, info_lr=2e-4)
RP_LR = {False: dict(lr=1e-5, d_lr=2e-5), True: dict(lr=2e-5, d_lr=2e-5)}
PXY_LR, MNIST_LR, APPROX_LR = 2e-5, 1e-5, 2e-4


def drop_big_files(root) -> None:
    for p in pathlib.Path(root).rglob("*"):
        if p.is_file() and p.stat().st_size > BIG:
            p.unlink()


@pytest.fixture
def tmp(tmp_path):
    yield tmp_path
    drop_big_files(tmp_path)


# --- the codec ----------------------------------------------------------------


def same_tree(a, b, path="") -> None:
    """``a`` and ``b`` equal in structure, key order, types and bits."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray) and a.dtype.name == "bfloat16":
        assert isinstance(b, torch.Tensor) and b.dtype == torch.bfloat16, path
        assert a.shape == tuple(b.shape), path
        assert a.view(np.int16).tobytes() == b.view(torch.int16).numpy().tobytes(), path
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
    elif isinstance(a, float):
        assert type(b) is float and struct.pack(">d", a) == struct.pack(">d", b), path
    else:
        assert type(a) is type(b) and a == b, path


_DTYPES = ["float16", "float32", "float64", "int8", "int16", "int32", "int64",
           "uint8", "uint16", "uint32", "uint64", "bool", "complex64"]


def _array(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, int(np.prod(shape)) * np.dtype(dtype).itemsize,
                        dtype=np.uint8).view(dtype).reshape(shape)


_arrays = st.builds(_array, st.sampled_from(_DTYPES),
                    st.lists(st.integers(0, 5), max_size=3).map(tuple), st.integers(0, 2**32 - 1))
_np_scalars = st.one_of(st.floats(width=32).map(np.float32), st.integers(-2**31, 2**31 - 1).map(np.int32),
                        st.booleans().map(np.bool_), st.integers(0, 255).map(np.uint8))
_plain = st.one_of(st.none(), st.booleans(), st.integers(-2**63, 2**64 - 1), st.floats(),
                   st.text(max_size=40), st.binary(max_size=300),
                   st.complex_numbers(allow_nan=False, allow_infinity=False))
_leaves = st.one_of(_arrays, _np_scalars, _plain, st.lists(st.one_of(_plain, _arrays), max_size=4))
_trees = st.dictionaries(
    st.text(max_size=20),
    st.recursive(_leaves, lambda c: st.dictionaries(st.text(max_size=20), c, max_size=5), max_leaves=12),
    min_size=1, max_size=6,
)


@settings(max_examples=50, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=_trees)
def test_codec_is_flax_on_drawn_trees(tree):
    """``to_bytes`` (lists become maps in its state dict) and the packer
    under it on the raw tree (lists as msgpack arrays).  Arrays above 64
    bytes that are map values go chunked here: the chunk size is patched
    small in both codecs."""
    with mock.patch.object(ser, "MAX_CHUNK_SIZE", 64), mock.patch.object(fm, "MAX_CHUNK_SIZE", 64):
        data = ser.to_bytes(tree)
        assert fm.packb(ser.to_state_dict(tree)) == data
        raw = ser.msgpack_serialize(copy.deepcopy(tree), in_place=True)
        assert fm.packb(tree) == raw
        for encoded in (data, raw):
            same_tree(ser.msgpack_restore(encoded), fm.unpackb(encoded))


def test_a_chunked_leaf_round_trips():
    tree = {"a": {"w": np.arange(50, dtype=np.float32).reshape(5, 10)}, "n": 3}
    with mock.patch.object(ser, "MAX_CHUNK_SIZE", 48), mock.patch.object(fm, "MAX_CHUNK_SIZE", 48):
        data = ser.to_bytes(tree)
        assert b"__msgpack_chunked_array__" in data
        assert fm.packb(tree) == data
        same_tree(ser.msgpack_restore(data), fm.unpackb(data))


def test_bfloat16_maps_to_torch_bfloat16():
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4), jnp.bfloat16)
    data = ser.to_bytes({"x": x})
    back = fm.unpackb(data)["x"]
    assert back.dtype == torch.bfloat16 and tuple(back.shape) == (3, 4)
    assert fm.packb({"x": back}) == data


def test_decoded_arrays_are_views_of_the_buffer():
    data = bytearray(ser.to_bytes({"w": np.arange(1000, dtype=np.float32)}))
    w = fm.unpackb(data)["w"]
    assert np.shares_memory(w, np.frombuffer(data, np.uint8))


@pytest.mark.parametrize("cut", [1, 7, 100, -1])
def test_damaged_bytes_raise(cut):
    data = ser.to_bytes({"w": np.arange(100, dtype=np.float32), "s": "x"})
    with pytest.raises(ValueError):
        fm.unpackb(data[:cut])


# --- the seven trainers ----------------------------------------------------------


@dataclasses.dataclass
class Case:
    """One trainer: its JAX state and step, the draws of a step, the
    port's state and step, the bounds of the parameter check."""

    stem: str
    jstate: Any
    jax_step: Callable  # (state, draws) -> (state, metrics)
    draws: Callable  # jax state -> draws for both sides
    port_init: Callable  # () -> a fresh port state on the CPU
    port_step: Callable  # (state, draws) -> (state, metrics)
    lr: Dict[str, float]  # model field -> summed learning rates
    zero_grad: Tuple[str, ...] = ()
    model_files: Dict[str, str] = dataclasses.field(default_factory=dict)  # file -> field


def _leaf(path, spec, rng):
    """A numpy value for one leaf of a train state's shapes: Adam moments
    and counts zero, the key from the seed, weights and statistics at
    torch's default scales (as ``test_torch_port_models_celeba.py``)."""
    names = [str(getattr(p, "name", getattr(p, "key", ""))) for p in path]
    shape, dtype, name = spec.shape, spec.dtype, names[-1]
    if dtype == np.uint32:  # the key
        return rng.integers(0, 2**32, shape, dtype=np.uint32)
    if np.issubdtype(dtype, np.integer) or "mu" in names or "nu" in names:
        return np.zeros(shape, dtype)
    if name == "kernel":
        bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
        return rng.uniform(-bound, bound, shape).astype(dtype)
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(dtype)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(dtype)
    if name.endswith("/sigma"):
        return np.ones(shape, dtype)
    if name.endswith("/u"):
        return rng.standard_normal(shape).astype(dtype)
    return (0.05 * rng.standard_normal(shape)).astype(dtype)  # bias, mean


def numpy_state(init, seed, *abstract):
    """The state the JAX package's ``init(PRNGKey(seed), *abstract)``
    builds, its shapes traced (``jax.eval_shape``: nothing compiles) and
    its values drawn with numpy from ``seed``."""
    shapes = jax.eval_shape(init, jax.random.PRNGKey(seed), *abstract)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, spec: _leaf(p, spec, rng), shapes)


def _uniform(rng, shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _celeba() -> Case:
    rng = np.random.default_rng(1)
    jc = jcfg.CelebaConfig(batch_size=B, **CELEBA_LR)
    js = numpy_state(lambda k: jax_celeba.init_celeba_gan_state(
        jm.CelebaGenerator(), jm.CelebaDiscriminator(), jc, k), 1)
    jstep = jax_celeba.make_celeba_gan_step(jm.CelebaGenerator(), jm.CelebaDiscriminator(), jc)
    pc = pcfg.CelebaConfig(batch_size=B, **CELEBA_LR)
    pstep = gan_celeba.make_celeba_gan_step(pc)
    imgs = _uniform(rng, (B, 64, 64, 3))

    def draws(_):
        return {"z": rng.standard_normal((B, 200)).astype(np.float32),
                "sampled_labels": rng.integers(0, 10, B).astype(np.int32),
                "code": _uniform(rng, (B, 8))}

    return Case(
        "celeba_train_state", js,
        lambda s, d: jstep(s, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in d.items()}),
        draws, lambda: gan_celeba.init_celeba_gan_state(pc, device="cpu", seed=5),
        lambda s, d: pstep(s, torch.from_numpy(imgs), d),
        {"g": CELEBA_LR["g_lr"] + CELEBA_LR["info_lr"], "d": CELEBA_LR["d_lr"] + CELEBA_LR["info_lr"]},
        ("conv_blocks.1.bias", "conv_blocks.4.bias", "conv_blocks.7.bias"),
        {"checkpoint_1.tar": "celeba"},
    )


def _sprites_batch(rng, channels=1):
    return (rng.uniform(0, 1, (B, 64, 64, 1)) > 0.7).astype(np.float32)


def _color(key):
    return np.array(jax.random.uniform(key, (B, 1, 1, 3), minval=0.5, maxval=1.0))


def _pxy(colored) -> Case:
    rng = np.random.default_rng(2)
    code_dim = 6 if colored else 3
    jc = jcfg.PxyConfig(batch_size=B, lr=PXY_LR, code_dim=code_dim, colored=colored)
    enc = jm.SpritesEncoderPxy(out_dim=code_dim, channels=3 if colored else 1)
    js = numpy_state(lambda k: jax_pretrain.init_pxy_state(enc, jc, k), 2)
    jstep = jax_pretrain.make_pxy_step(enc, jc)
    pc = pcfg.PxyConfig(batch_size=B, lr=PXY_LR, code_dim=code_dim, colored=colored)
    pstep = pretrain.make_pxy_step(pc)
    imgs = _sprites_batch(rng)

    def draws(s):  # the JAX step's own: split(rng, 3) -> (rng, colour, code)
        _, color_key, code_key = jax.random.split(s.rng, 3)
        d = {"code": np.array(jax.random.uniform(code_key, (B, code_dim), minval=-1.0, maxval=1.0))}
        if colored:
            d["color"] = _color(color_key)
        return d

    stem = "encoder_pxy_color" if colored else "encoder_pxy"
    return Case(
        f"{stem}_train_state", js, lambda s, d: jstep(s, jnp.asarray(imgs)), draws,
        lambda: pretrain.init_pxy_state(pc, device="cpu", seed=5),
        lambda s, d: pstep(s, torch.from_numpy(imgs), d), {"model": PXY_LR},
        model_files={f"{stem}_1.pt": "model"},
    )


def _rp(colored) -> Case:
    rng = np.random.default_rng(3)
    channels, out_dim, code_dim = (3, 6, 7) if colored else (1, 3, 4)
    lrs = RP_LR[colored]
    jc = jcfg.SpritesGanConfig(batch_size=B, code_dim=code_dim, channels=channels, colored=colored, **lrs)
    mods = (jm.SpritesGenerator(channels=channels), jm.SpritesDiscriminator(channels=channels),
            jm.SpritesEncoder(n_classes=3, code_dim=code_dim, channels=channels),
            jm.SpritesEncoderPxy(out_dim=out_dim, channels=channels))
    pxy_vars = jax.eval_shape(mods[3].init, jax.random.PRNGKey(4), jnp.zeros((1, 64, 64, channels)))
    js = numpy_state(lambda k, pv: jax_dsprites.init_sprites_gan_state(*mods, pv, jc, k), 3, pxy_vars)
    jstep = jax_dsprites.make_sprites_gan_step(*mods, jc)
    pc = pcfg.SpritesGanConfig(batch_size=B, code_dim=code_dim, channels=channels, colored=colored, **lrs)
    pstep = gan_dsprites.make_sprites_gan_step(pc)
    imgs = _sprites_batch(rng)

    def draws(s):
        d = {f"{k}_{p}": v for p in ("d", "i") for k, v in (
            ("code", _uniform(rng, (B, code_dim))),
            ("onehot", np.eye(3, dtype=np.float32)[rng.integers(0, 3, B)]))}
        if colored:  # the JAX step's colour: split(rng, 4)[1]
            d["color"] = _color(jax.random.split(s.rng, 4)[1])
        return d

    return Case(
        "rp_train_state", js,
        lambda s, d: jstep(s, jnp.asarray(imgs), {k: jnp.asarray(v) for k, v in d.items() if k != "color"}),
        draws,
        lambda: gan_dsprites.init_sprites_gan_state(pc, pretrain.pxy_encoder(colored, 1), device="cpu", seed=5),
        lambda s, d: pstep(s, torch.from_numpy(imgs), d),
        {"g": lrs["lr"], "e": lrs["lr"], "d": lrs["d_lr"]},
        ("conv_block.0.bias", "conv_block.3.bias", "conv_block.6.bias"),
        {"encoder_1.pt": "e", "generator_1.pt": "g"},
    )


def _mnist() -> Case:
    rng = np.random.default_rng(4)
    jc = jcfg.MnistConfig(batch_size=B, lr=MNIST_LR)
    mods = (jm.MnistGenerator(), jm.MnistDiscriminator(), jm.MnistEncoder())
    approx_vars = jax.eval_shape(jm.AffineApproximator().init, jax.random.PRNGKey(6), jnp.zeros((1, 6)))
    js = numpy_state(lambda k, av: jax_mnist.init_mnist_gan_state(*mods, av, jc, k), 4, approx_vars)
    jstep = jax_mnist.make_mnist_gan_step(*mods, jm.AffineApproximator(), jc)
    pc = pcfg.MnistConfig(batch_size=B, lr=MNIST_LR)
    pstep = gan_mnist.make_mnist_gan_step(pc)
    imgs, labels = _uniform(rng, (B, 32, 32, 1)), np.zeros(B, np.int32)

    def draws(_):
        return {"z": rng.standard_normal((B, 62)).astype(np.float32),
                "sampled_labels": rng.integers(0, 10, B).astype(np.int32),
                "code": _uniform(rng, (B, 7))}

    return Case(
        "mnist_train_state", js,
        lambda s, d: jstep(s, jnp.asarray(imgs), jnp.asarray(labels), {k: jnp.asarray(v) for k, v in d.items()}),
        draws,
        lambda: gan_mnist.init_mnist_gan_state(pc, pretrain.approximator_model(1), device="cpu", seed=5),
        lambda s, d: pstep(s, torch.from_numpy(imgs), torch.from_numpy(labels), d),
        {"g": 2 * MNIST_LR, "d": 2 * MNIST_LR, "e": MNIST_LR},
        ("conv_blocks.2.bias", "conv_blocks.6.bias"),
        {"generator_1.pt": "g", "encoder_1.pt": "e"},
    )


def _approximator() -> Case:
    jc = jcfg.ApproximatorConfig(batch_size=B, lr=APPROX_LR)
    js = numpy_state(lambda k: jax_pretrain.init_approximator_state(jm.AffineApproximator(), jc, k), 5)
    jstep = jax_pretrain.make_approximator_step(jm.AffineApproximator(), jc)
    pc = pcfg.ApproximatorConfig(batch_size=B, lr=APPROX_LR)
    pstep = pretrain.make_approximator_step(pc)

    def draws(s):  # the JAX step's own: split(rng) -> (rng, code)
        key = jax.random.split(s.rng)[1]
        return {"code": np.array(jax.random.uniform(key, (B, 7), minval=-1.0, maxval=1.0))}

    return Case(
        "approximator_train_state", js, lambda s, d: jstep(s), draws,
        lambda: pretrain.init_approximator_state(pc, device="cpu", seed=5),
        lambda s, d: pstep(s, d), {"model": APPROX_LR},
        model_files={"rpqmnxy_approximator.pt": "model"},
    )


CASES = {
    "celeba": _celeba, "pxy": lambda: _pxy(False), "pxy_color": lambda: _pxy(True),
    "rp": lambda: _rp(False), "rp_color": lambda: _rp(True), "mnist": _mnist,
    "approximator": _approximator,
}


@dataclasses.dataclass
class Trained:
    case: Case
    jstate: Any  # after one JAX step
    data: bytes  # the JAX package's train-state file
    models: Dict[str, bytes]  # the JAX package's model files


def _model_tree(mv):
    return {"params": mv.params, "stats": mv.stats}


def _jax_model_files(case: Case, js, directory) -> Dict[str, bytes]:
    """The model files the trainer's JAX CLI writes, by its functions."""
    out = {}
    for name, field in case.model_files.items():
        path = os.path.join(directory, name)
        if field == "celeba":  # eadgan_tpu/cli/celeba.py:110-122
            jck.save_pytree(path, {"discriminator_state_dict": _model_tree(js.d),
                                   "generator_state_dict": _model_tree(js.g),
                                   "epoch": 0, "batches_done": 1})
        else:
            jck.save_model(path, getattr(js, field))
        out[name] = pathlib.Path(path).read_bytes()
        os.unlink(path)
    return out


@pytest.fixture(scope="module", params=list(CASES))
def trained(request, tmp_path_factory):
    case = CASES[request.param]()
    js, _ = case.jax_step(case.jstate, case.draws(case.jstate))  # non-zero moments
    directory = tmp_path_factory.mktemp(request.param)
    if request.param == "celeba":
        # ~0.52 GB: in memory only; save_pytree writes serialization.to_bytes(tree)
        data = ser.to_bytes(js)
    else:
        path = jck.save_train_state(str(directory), case.stem, 1, js)
        data = pathlib.Path(path).read_bytes()
        os.unlink(path)
    yield Trained(case, js, data, _jax_model_files(case, js, str(directory)))
    drop_big_files(directory)


def _restored(t: Trained):
    state = t.case.port_init()
    ck.restore_train_state(io.BytesIO(t.data), state)
    return state


def _models(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.nn.Module)}


def _expected(model, mv) -> Dict[str, torch.Tensor]:
    return from_jax.from_flax(from_jax.model_layers(model),
                              {"params": mv.params, "batch_stats": mv.stats})


def _equal_dicts(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), f"{where}.{k}"


def test_restored_state_equals_from_jax(trained):
    js, state = trained.jstate, _restored(trained)
    assert state.step == int(js.step) == 1
    assert state.rng.initial_seed() == jax_state.seed_from_key(js.rng)
    for field, model in _models(state).items():
        _equal_dicts(model.state_dict(), _expected(model, getattr(js, field)), field)
    jfields = jax_state.JAX_FIELDS[type(state)]
    for name in (f for f in jfields if f.startswith("opt")):
        opt, jopt = getattr(state, name), getattr(js, name)
        assert (opt is None) == (jopt is None), name
        if opt is None:
            continue
        adam = jopt[0]
        params = {id(p): (f, k) for f, m in _models(state).items() for k, p in m.named_parameters()}
        fields = sorted({params[id(p)][0] for g in opt.param_groups for p in g["params"]})
        moments = {}
        for which in ("mu", "nu"):
            tree = getattr(adam, which)
            per = tree if len(fields) > 1 else {fields[0]: tree}
            moments[which] = {f: from_jax.from_flax(from_jax.model_layers(getattr(state, f)),
                                                    {"params": per[f]}, params_only=True) for f in fields}
        n = 0
        for g in opt.param_groups:
            for p in g["params"]:
                f, k = params[id(p)]
                st = opt.state[p]
                assert int(st["step"]) == int(adam.count) == 1
                assert torch.equal(st["exp_avg"], moments["mu"][f][k]), f"{name} mu {f}.{k}"
                assert torch.equal(st["exp_avg_sq"], moments["nu"][f][k]), f"{name} nu {f}.{k}"
                n += 1
        assert n == len(opt.state)


def numpy_tree(tree):
    """``tree`` with its JAX arrays as numpy arrays, key order kept."""
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree) if isinstance(tree, jax.Array) else tree


class _SameBytes:
    """A file object that checks what is written against ``data``."""

    def __init__(self, data):
        self.data, self.pos = np.frombuffer(data, np.uint8), 0

    def write(self, piece):
        piece = np.frombuffer(piece, np.uint8)
        assert np.array_equal(self.data[self.pos : self.pos + piece.size], piece), self.pos
        self.pos += piece.size


def _assert_packs_to(tree, data):
    same = _SameBytes(data)
    assert fm.pack_into(same, tree) == len(data) == same.pos


def test_port_writes_the_jax_files(trained, tmp):
    """The port's encoder on flax's state dict, and on the state it
    restored, gives the JAX file's bytes; ``save_jax_model`` writes the
    JAX package's model files byte for byte."""
    _assert_packs_to(numpy_tree(ser.to_state_dict(trained.jstate)), trained.data)
    state = _restored(trained)
    _assert_packs_to(ck.jax_train_state(state), trained.data)
    for name, field in trained.case.model_files.items():
        obj = ({"discriminator_state_dict": state.d, "generator_state_dict": state.g,
                "epoch": 0, "batches_done": 1} if field == "celeba" else getattr(state, field))
        assert ck.save_jax_model(str(tmp / name), obj) == len(trained.models[name])
        assert (tmp / name).read_bytes() == trained.models[name], name


def test_unpackb_equals_msgpack_restore(trained):
    same_tree(ser.msgpack_restore(trained.data), fm.unpackb(trained.data))
    for data in trained.models.values():
        same_tree(ser.msgpack_restore(data), fm.unpackb(data))


def test_port_step_after_a_jax_resume_matches_jax(trained):
    case, js = trained.case, trained.jstate
    draws = case.draws(js)
    js2, jm_ = case.jax_step(js, draws)
    state, pm = case.port_step(_restored(trained), draws)
    assert set(jm_) == set(pm)
    for k in jm_:
        assert np.isfinite(float(pm[k]))
        np.testing.assert_allclose(float(pm[k]), float(jm_[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(js2.step) == 2
    for field, model in _models(state).items():
        ref = _expected(model, getattr(js2, field))
        sd = {k: v.detach() for k, v in model.state_dict().items()}
        params = dict(model.named_parameters())
        if field in case.lr:
            assert_params_within_adam_bound({k: sd[k] for k in params}, ref, case.lr[field],
                                            skip=case.zero_grad)
        else:  # frozen: bit for bit
            _equal_dicts(sd, ref, field)
        assert_buffers_match({k: v for k, v in sd.items() if k not in params}, ref, field)


# --- the model maps both ways -----------------------------------------------------

_MODEL_KINDS = {  # port model, JAX model, its init inputs, to_jax / from_jax functions
    "celeba_generator": (pm.CelebaGenerator, jm.CelebaGenerator, [(1, 200), (1, 10), (1, 8)]),
    "celeba_discriminator": (pm.CelebaDiscriminator, jm.CelebaDiscriminator, [(1, 64, 64, 3)]),
    "sprites_encoder_pxy": (pm.SpritesEncoderPxy, jm.SpritesEncoderPxy, [(1, 64, 64, 1)]),
    "sprites_generator": (pm.SpritesGenerator, jm.SpritesGenerator, [(1, 7)]),
    "sprites_discriminator": (pm.SpritesDiscriminator, jm.SpritesDiscriminator, [(1, 64, 64, 1)]),
    "sprites_encoder": (pm.SpritesEncoder, jm.SpritesEncoder, [(1, 64, 64, 1)]),
    "mnist_generator": (pm.MnistGenerator, jm.MnistGenerator, [(1, 62), (1, 10), (1, 7)]),
    "mnist_discriminator": (pm.MnistDiscriminator, jm.MnistDiscriminator, [(1, 32, 32, 1)]),
    "mnist_encoder": (pm.MnistEncoder, jm.MnistEncoder, [(1, 32, 32, 1)]),
    "approximator": (pm.AffineApproximator, jm.AffineApproximator, [(1, 6)]),
}


def _leaf_specs(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _leaf_specs(tree[key], path + (key,)).items()}
    return {path: (tuple(tree.shape), np.dtype(tree.dtype))}


def _all_sorted(tree) -> bool:
    return not isinstance(tree, dict) or (list(tree) == sorted(tree)
                                          and all(_all_sorted(v) for v in tree.values()))


@pytest.mark.parametrize("kind", list(_MODEL_KINDS))
def test_to_flax_inverts_from_flax(kind):
    """``*_to_flax`` gives the JAX model's variables (every path, shape
    and dtype of its init, keys sorted) and ``*_from_flax`` of them gives
    the port's state_dict back bit for bit."""
    port_cls, jax_cls, inputs = _MODEL_KINDS[kind]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = port_cls()
    sd = model.state_dict()
    variables = getattr(to_jax, f"{kind}_to_flax")(sd)
    shapes = jax.eval_shape(jax_cls().init, jax.random.PRNGKey(0), *[jnp.zeros(i) for i in inputs])
    assert _leaf_specs({k: v for k, v in variables.items() if v}) == _leaf_specs(dict(shapes))
    assert _all_sorted(variables)
    back = getattr(from_jax, f"{kind}_from_flax")(variables)
    assert set(back) == set(sd)
    for k, v in sd.items():
        want = torch.zeros_like(v) if k.endswith("num_batches_tracked") else v
        assert back[k].dtype == want.dtype and torch.equal(back[k], want), k


# --- what does not fit ---------------------------------------------------------


def _init_bytes(name):
    return ser.to_bytes(CASES[name]().jstate)


def test_an_rp_state_offered_to_celeba_names_the_first_path():
    state = gan_celeba.init_celeba_gan_state(pcfg.CelebaConfig(batch_size=B), device="cpu")
    with pytest.raises(ValueError, match=r"^g/params/"):
        ck.restore_train_state(io.BytesIO(_init_bytes("rp")), state)


def test_a_colored_state_offered_to_gray_names_the_first_path():
    state = pretrain.init_pxy_state(pcfg.PxyConfig(batch_size=B), device="cpu")
    with pytest.raises(ValueError, match=r"^model/params/TorchConv_0/Conv_0/kernel: shape \(\d+, \d+, 3, \d+\)"):
        ck.restore_train_state(io.BytesIO(_init_bytes("pxy_color")), state)
    model = pretrain.pxy_encoder(False, 1)
    tree = fm.unpackb(_init_bytes("pxy_color"))["model"]
    with pytest.raises(ValueError, match="TorchConv_0/Conv_0/kernel"):
        jax_state.model_from_jax(tree, model)


def test_an_encoder_state_offered_to_a_gan_state():
    state = pretrain.init_approximator_state(pcfg.ApproximatorConfig(batch_size=B), device="cpu")
    with pytest.raises(ValueError, match="holds"):
        ck.restore_train_state(io.BytesIO(_init_bytes("mnist")), state)


# --- --resume auto over both formats -------------------------------------------


def test_resume_auto_takes_the_newest_loadable_of_either_format(tmp, capsys):
    """pxy train states: step 1 the JAX package's, step 2 the port's,
    step 3 a truncated JAX file, step 4 a truncated port file."""
    case = CASES["pxy"]()
    stem = case.stem
    js, _ = case.jax_step(case.jstate, case.draws(case.jstate))
    jck.save_train_state(str(tmp), stem, 1, js)
    port = _restored(Trained(case, js, (tmp / f"{stem}_1.ckpt").read_bytes(), {}))
    port.step = 2
    ck.save_train_state(str(tmp), stem, 2, port)
    good = {1: (tmp / f"{stem}_1.ckpt").read_bytes(), 2: (tmp / f"{stem}_2.ckpt").read_bytes()}
    (tmp / f"{stem}_3.ckpt").write_bytes(good[1][: len(good[1]) // 2])
    (tmp / f"{stem}_4.ckpt").write_bytes(good[2][: len(good[2]) // 2])

    state = common.maybe_resume(case.port_init(), "auto", str(tmp), stem)
    assert state.step == 2
    err = capsys.readouterr().err
    assert f"{stem}_4.ckpt failed to load" in err and f"{stem}_3.ckpt failed to load" in err
    (tmp / f"{stem}_2.ckpt").unlink()
    state = common.maybe_resume(case.port_init(), "auto", str(tmp), stem)
    assert state.step == 1
    _equal_dicts(state.model.state_dict(), _expected(state.model, js.model), "model")


# --- the CLIs that read model files -----------------------------------------------


@pytest.fixture
def cpu_env(monkeypatch):
    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")
    monkeypatch.setenv("EADGAN_SYNTH_N", "64")


class _Stop(Exception):
    pass


def _write(directory, name, data) -> str:
    path = os.path.join(directory, name)
    pathlib.Path(path).write_bytes(data)
    return path


def _grid_probe(monkeypatch, module, name, inputs):
    """Replace a CLI's grid writer by one call of the renderer on
    ``inputs``; returns the list its outputs land in."""
    got = []
    monkeypatch.setattr(module, name, lambda apply, out_dir, batches_done: got.append(apply(*inputs)))
    return got


def _celeba_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((3, 200)).astype(np.float32),
            np.eye(10, dtype=np.float32)[[1, 4, 7]], _uniform(rng, (3, 8)))


def test_model_files_read_by_the_cli(trained, tmp, cpu_env, monkeypatch):
    case, js = trained.case, trained.jstate
    files = {name: _write(tmp, name, data) for name, data in trained.models.items()}
    if "checkpoint_1.tar" in files:  # celeba: gen_imgs and export_torch
        got = _grid_probe(monkeypatch, gen_imgs, "celeba_inference_grids", _celeba_inputs())
        gen_imgs.main(["--checkpoint", files["checkpoint_1.tar"], "--out_dir", str(tmp)])
        model = CelebaGenerator()
        model.load_state_dict(_expected(model, js.g))
        want = gen_imgs.eval_apply(model, torch.device("cpu"))(*_celeba_inputs())
        np.testing.assert_array_equal(got[0], want)
        _exports_match(tmp, "celeba_checkpoint", files["checkpoint_1.tar"], False, {
            "generator_state_dict": jax_te.export_celeba_generator(_variables(js.g)),
            "discriminator_state_dict": jax_te.export_celeba_discriminator(_variables(js.d))})
    elif case.stem.startswith("encoder_pxy"):  # rp --encoder_pxy, score, export_torch
        colored = "color" in case.stem
        trainer = rp_color if colored else rp
        trainer.main(["--encoder_pxy", files[next(iter(files))], "--batch_size", "2", "--max_steps", "1",
                      "--sample_interval", "1000", "--data_dir", str(tmp), "--out_dir", str(tmp / "img"),
                      "--ckpt_dir", str(tmp / "rp"), "--compute", "f32"])
        saved = torch.load(tmp / "rp" / "rp_train_state_0.ckpt", weights_only=True)
        _equal_dicts(saved["pxy"], _expected(pretrain.pxy_encoder(colored, 1), js.model), "pxy")
        loaded = _score_models(monkeypatch, tmp, ["--encoder_pxy", files[next(iter(files))]], colored)
        _equal_dicts(loaded[0], _expected(pretrain.pxy_encoder(colored, 1), js.model), "aligner")
        _exports_match(tmp, "sprites_encoder_pxy", files[next(iter(files))], colored,
                       jax_te.export_sprites_encoder_pxy(_variables(js.model)))
    elif case.stem == "rp_train_state":  # score --encoder
        state = case.port_init()
        colored = state.g.conv_block[9].weight.shape[1] == 3
        loaded = _score_models(monkeypatch, tmp, ["--encoder", files["encoder_1.pt"]], colored)
        _equal_dicts(loaded[1], _expected(state.e, js.e), "encoder")
    elif case.stem == "mnist_train_state":  # generate_image
        inputs = (np.random.default_rng(8).standard_normal((3, 62)).astype(np.float32),
                  np.eye(10, dtype=np.float32)[[0, 5, 9]], _uniform(np.random.default_rng(9), (3, 7)))
        got = _grid_probe(monkeypatch, generate_image, "mnist_inference_grids", inputs)
        generate_image.main(["--checkpoint", files["generator_1.pt"], "--out_dir", str(tmp)])
        model = MnistGenerator()
        model.load_state_dict(_expected(model, js.g))
        np.testing.assert_array_equal(got[0], generate_image.eval_apply(model, torch.device("cpu"))(*inputs))
    else:  # the approximator: mnist's frozen approximator
        mnist.main(["--approximator", files["rpqmnxy_approximator.pt"], "--batch_size", "2",
                    "--max_steps", "1", "--sample_interval", "1000", "--data_dir", str(tmp),
                    "--out_dir", str(tmp / "img"), "--ckpt_dir", str(tmp / "m"), "--compute", "f32"])
        saved = torch.load(tmp / "m" / "mnist_train_state_0.ckpt", weights_only=True)
        _equal_dicts(saved["approx"], _expected(pretrain.approximator_model(1), js.model), "approx")


def _score_models(monkeypatch, tmp, flags, colored):
    """``cli.score`` up to its Representer: the (aligner, encoder)
    state_dicts it loaded."""
    got = []

    def representer(aligner, encoder, **kwargs):
        got.extend([aligner.state_dict(), encoder.state_dict()])
        raise _Stop

    monkeypatch.setattr(score, "Representer", representer)
    with pytest.raises(_Stop):
        score.main([*flags, "--allow_fresh", "--n_groups", "2", "--data_dir", str(tmp),
                    *(["--colored"] if colored else [])])
    return got


def _variables(mv):
    return {"params": mv.params, "batch_stats": mv.stats}


def _exports_match(tmp, kind, path, colored, want):
    """The port's ``export_torch`` of a JAX file equals the JAX
    package's exporter (``eadgan_tpu/interop/torch_export.py``, what its
    ``export_torch`` runs) on the same weights, bit for bit."""
    export_torch.main(["--kind", kind, "--input", path, "--output", str(tmp / "port.pt"),
                       *(["--colored"] if colored else [])])
    got = torch.load(tmp / "port.pt", weights_only=True)
    if kind == "celeba_checkpoint":
        assert (got["epoch"], got["batches_done"]) == (0, 1)
        got = {f"{p}/{k}": v for p in want for k, v in got[p].items()}
        want = {f"{p}/{k}": v for p, sub in want.items() for k, v in sub.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
