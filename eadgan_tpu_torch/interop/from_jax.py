"""Carry weights from the JAX package's flax variables into the port.

Each ``*_from_flax`` function takes the flax variables of one model as
nested dicts of arrays, ``{"params": ..., "batch_stats": ...}``, and
returns the port model's ``state_dict`` (torch tensors);
``interop/to_jax.py`` holds the inverses.  Both read one table per model
(a :class:`Layer` per port layer), and every step of a layer's map is a
permutation, so the two directions invert each other exactly.  The
layout maps (as in ``eadgan_tpu/interop/torch_export.py``,
re-implemented here):

* conv kernel: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
* transposed-conv kernel: flax (kh, kw, in, out) with the taps flipped
  -> torch ConvTranspose2d (in, out, kh, kw);
* dense kernel: flax (in, out) -> torch Linear (out, in).  A dense layer
  that follows a flatten of a conv map also has its input rows permuted:
  flax flattens NHWC in (H, W, C) order, the port NCHW in (C, H, W)
  order.  Permuting rows leaves the singular values, so ``sigma``, and
  the stored ``u`` (one entry per output) as they were;
* BatchNorm: scale/bias -> weight/bias, mean/var -> running_mean/var
  (the port's ``num_batches_tracked``, which nothing reads, is 0).

Spectral-norm layers carry the *raw* kernel plus flax's stored ``u``
(``(1, out)`` under ``.../Conv_0/kernel/u`` or ``.../Dense_0/kernel/u``)
and ``sigma``: the port takes flax's power step itself and must start
from the same ``u``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Layer",
    "Leaf",
    "leaves",
    "from_flax",
    "model_layers",
    "celeba_generator_from_flax",
    "celeba_discriminator_from_flax",
    "sprites_encoder_pxy_from_flax",
    "sprites_generator_from_flax",
    "sprites_discriminator_from_flax",
    "sprites_encoder_from_flax",
    "mnist_generator_from_flax",
    "mnist_discriminator_from_flax",
    "mnist_encoder_from_flax",
    "approximator_from_flax",
]

StateDict = Dict[str, torch.Tensor]
Chw = Tuple[int, int, int]
_SPRITES_FLAT = (64, 4, 4)  # (C, H, W) of the dSprites trunks' last map


class Layer(NamedTuple):
    """One port layer: its ``state_dict`` prefix, its flax module, its
    kind (``conv``, ``convT``, ``dense``, ``sn_conv``, ``sn_dense``,
    ``bn``) and, for a dense layer after a flatten, the (C, H, W) of the
    flattened map."""

    key: str
    module: str
    kind: str
    flatten: Optional[Chw] = None


class Leaf(NamedTuple):
    """One array: its flax path (``("params", module, ...)``), its port
    key, the map flax -> port and its inverse, and whether it is a
    parameter (an Adam moment has the parameter's layout)."""

    path: Tuple[str, ...]
    key: str
    to_port: Callable[[np.ndarray], np.ndarray]
    to_flax: Callable[[np.ndarray], np.ndarray]
    param: bool


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a writable copy


def conv_transpose_kernel(k) -> torch.Tensor:
    """flax (kh, kw, in, out), taps flipped -> torch ConvTranspose2d
    (in, out, kh, kw)."""
    return _t(_convt_to_port(np.asarray(k)))


def nchw_rows(c: int, h: int, w: int) -> np.ndarray:
    """For each input index of a (C, H, W)-order flatten, the index of the
    same element in an (H, W, C)-order flatten."""
    ci, hi, wi = np.meshgrid(np.arange(c), np.arange(h), np.arange(w), indexing="ij")
    return (hi * w * c + wi * c + ci).reshape(-1)


def _convt_to_port(k: np.ndarray) -> np.ndarray:
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def _convt_to_flax(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 0, 1))[::-1, ::-1]


def _dense_to_port(flatten: Optional[Chw]):
    if flatten is None:
        return lambda k: k.T
    rows = nchw_rows(*flatten)
    return lambda k: k[rows].T


def _dense_to_flax(flatten: Optional[Chw]):
    if flatten is None:
        return lambda w: w.T
    rows = nchw_rows(*flatten)

    def inverse(w):
        k = np.empty_like(w.T)
        k[rows] = w.T
        return k

    return inverse


def _same(x):
    return x


_INNER = {"conv": "Conv_0", "sn_conv": "Conv_0", "convT": "ConvTranspose_0",
          "dense": "Dense_0", "sn_dense": "Dense_0"}


def leaves(layers: List[Layer]) -> List[Leaf]:
    """Every array of a model, in table order."""
    out: List[Leaf] = []
    for layer in layers:
        key, mod = layer.key, layer.module
        if layer.kind == "bn":
            out += [
                Leaf(("params", mod, "BatchNorm_0", "scale"), f"{key}.weight", _same, _same, True),
                Leaf(("params", mod, "BatchNorm_0", "bias"), f"{key}.bias", _same, _same, True),
                Leaf(("batch_stats", mod, "BatchNorm_0", "mean"), f"{key}.running_mean",
                     _same, _same, False),
                Leaf(("batch_stats", mod, "BatchNorm_0", "var"), f"{key}.running_var",
                     _same, _same, False),
            ]
            continue
        inner = _INNER[layer.kind]
        if layer.kind == "convT":
            fwd, inv = _convt_to_port, _convt_to_flax
        elif inner == "Conv_0":
            fwd, inv = (lambda k: np.transpose(k, (3, 2, 0, 1))), (lambda w: np.transpose(w, (2, 3, 1, 0)))
        else:
            fwd, inv = _dense_to_port(layer.flatten), _dense_to_flax(layer.flatten)
        out += [
            Leaf(("params", mod, inner, "kernel"), f"{key}.weight", fwd, inv, True),
            Leaf(("params", mod, inner, "bias"), f"{key}.bias", _same, _same, True),
        ]
        if layer.kind.startswith("sn_"):
            sn = ("batch_stats", mod, "SpectralNorm_0")
            out += [
                Leaf(sn + (f"{inner}/kernel/u",), f"{key}.u",
                     lambda u: u.reshape(-1), lambda u: u.reshape(1, -1), False),
                Leaf(sn + (f"{inner}/kernel/sigma",), f"{key}.sigma",
                     lambda s: s.reshape(()), lambda s: s.reshape(()), False),
            ]
    return out


def lookup(tree, path: Tuple[str, ...]):
    """``tree[path[0]][path[1]]...``; a missing key raises naming the
    path."""
    node = tree
    for i, k in enumerate(path):
        if not isinstance(node, dict) or k not in node:
            raise KeyError(f"{'/'.join(path[: i + 1])}: not in the flax tree")
        node = node[k]
    return node


def from_flax(layers: List[Layer], variables, params_only: bool = False) -> StateDict:
    """A model's flax variables -> the port's ``state_dict``.  With
    ``params_only`` only the ``params`` collection is read (a tree of
    Adam moments has that layout) and only parameters come back."""
    sd: StateDict = {}
    for leaf in leaves(layers):
        if leaf.param or not params_only:
            sd[leaf.key] = _t(leaf.to_port(np.asarray(lookup(variables, leaf.path))))
    for layer in layers:
        if layer.kind == "bn" and not params_only:
            sd[f"{layer.key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


# --- the tables -------------------------------------------------------------


def _trunk(module: str, kind: str) -> List[Layer]:
    return [Layer(f"conv_block.{seq}", f"{module}_{i}", kind) for i, seq in enumerate((0, 2, 4, 6))]


def _mnist_flat(img_size: int) -> Chw:
    """(C, H, W) of the MNIST trunks' last map."""
    return (128, img_size // 16, img_size // 16)


CELEBA_GENERATOR = [
    *(Layer(f"conv_blocks.{seq}", f"TorchConvTranspose_{i}", "convT")
      for i, seq in enumerate((0, 1, 4, 7, 10))),
    *(Layer(f"conv_blocks.{seq}", f"TorchBatchNorm_{i}", "bn") for i, seq in enumerate((2, 5, 8))),
]
CELEBA_DISCRIMINATOR = [
    *(Layer(f"main.{seq}", f"SNConv_{i}", "sn_conv") for i, seq in enumerate((0, 2, 4, 6))),
    Layer("main.8", "TorchConv_0", "conv"),
]


# The dSprites tables read ``_SPRITES_FLAT`` when called.
def sprites_encoder_pxy_layers() -> List[Layer]:
    return [*_trunk("TorchConv", "conv"), Layer("fc1", "TorchDense_0", "dense", _SPRITES_FLAT)]


def sprites_generator_layers() -> List[Layer]:
    # its fc output is viewed NCHW on both sides: no permutation
    return [
        Layer("fc1.0", "TorchDense_0", "dense"),
        Layer("fc2.0", "TorchDense_1", "dense"),
        *(Layer(f"conv_block.{seq}", f"TorchConvTranspose_{i}", "convT")
          for i, seq in enumerate((0, 3, 6, 9))),
        *(Layer(f"conv_block.{seq}", f"TorchBatchNorm_{i}", "bn")
          for i, seq in enumerate((1, 4, 7))),
    ]


def sprites_discriminator_layers() -> List[Layer]:
    return [
        *_trunk("SNConv", "sn_conv"),
        Layer("fc1.0", "SNDense_0", "sn_dense", _SPRITES_FLAT),
        Layer("fc2", "TorchDense_0", "dense"),
    ]


def sprites_encoder_layers() -> List[Layer]:
    return [
        *_trunk("SNConv", "sn_conv"),
        Layer("fc1.0", "SNDense_0", "sn_dense", _SPRITES_FLAT),
        Layer("fc2.0", "SNDense_1", "sn_dense"),
        Layer("cat_layer.0", "SNDense_2", "sn_dense"),
        Layer("cont_layer.0", "SNDense_3", "sn_dense"),
    ]


MNIST_GENERATOR = [  # its fc output is viewed NCHW on both sides: no permutation
    Layer("l1.0", "TorchDense_0", "dense"),
    Layer("conv_blocks.0", "TorchBatchNorm_0", "bn"),
    Layer("conv_blocks.2", "TorchConv_0", "conv"),
    Layer("conv_blocks.3", "TorchBatchNorm_1", "bn"),
    Layer("conv_blocks.6", "TorchConv_1", "conv"),
    Layer("conv_blocks.7", "TorchBatchNorm_2", "bn"),
    Layer("conv_blocks.9", "TorchConv_2", "conv"),
]
APPROXIMATOR = [Layer(f"fc_block.{seq}", f"TorchDense_{i}", "dense")
                for i, seq in enumerate((0, 2, 4, 6, 8))]


def mnist_discriminator_layers(img_size: int = 32) -> List[Layer]:
    return [
        *(Layer(f"conv_blocks.{seq}", f"SNConv_{i}", "sn_conv") for i, seq in enumerate((0, 2, 4, 6))),
        Layer("adv_layer.0", "SNDense_0", "sn_dense", _mnist_flat(img_size)),
    ]


def mnist_encoder_layers(img_size: int = 32) -> List[Layer]:
    return [
        *(Layer(f"conv_blocks.{seq}", f"SNConv_{i}", "sn_conv") for i, seq in enumerate((0, 2, 5, 8))),
        *(Layer(f"conv_blocks.{seq}", f"TorchBatchNorm_{i}", "bn") for i, seq in enumerate((4, 7, 10))),
        *(Layer(f"{head}.0", f"SNDense_{i}", "sn_dense", _mnist_flat(img_size))
          for i, head in enumerate(("aux_layer", "latent_layer", "noise_layer"))),
    ]


def model_layers(model: torch.nn.Module) -> List[Layer]:
    """The table of a port model (one of the five families' ten classes)."""
    from eadgan_tpu_torch import models

    if isinstance(model, (models.MnistDiscriminator, models.MnistEncoder)):
        dense = model.adv_layer[0] if isinstance(model, models.MnistDiscriminator) else model.aux_layer[0]
        img_size = 16 * int(round((dense.in_features // 128) ** 0.5))
        build = (mnist_discriminator_layers if isinstance(model, models.MnistDiscriminator)
                 else mnist_encoder_layers)
        return build(img_size)
    for cls, layers in (
        (models.CelebaGenerator, CELEBA_GENERATOR),
        (models.CelebaDiscriminator, CELEBA_DISCRIMINATOR),
        (models.SpritesEncoderPxy, sprites_encoder_pxy_layers()),
        (models.SpritesGenerator, sprites_generator_layers()),
        (models.SpritesDiscriminator, sprites_discriminator_layers()),
        (models.SpritesEncoder, sprites_encoder_layers()),
        (models.MnistGenerator, MNIST_GENERATOR),
        (models.AffineApproximator, APPROXIMATOR),
    ):
        if isinstance(model, cls):
            return layers
    raise TypeError(f"{type(model).__name__} has no counterpart in the JAX package")


def celeba_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.CelebaGenerator`` variables -> the port's
    ``CelebaGenerator`` state_dict."""
    return from_flax(CELEBA_GENERATOR, variables)


def celeba_discriminator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.CelebaDiscriminator`` variables -> the port's
    ``CelebaDiscriminator`` state_dict."""
    return from_flax(CELEBA_DISCRIMINATOR, variables)


def sprites_encoder_pxy_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesEncoderPxy`` -> the port's
    ``SpritesEncoderPxy``."""
    return from_flax(sprites_encoder_pxy_layers(), variables)


def sprites_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesGenerator`` -> the port's
    ``SpritesGenerator``."""
    return from_flax(sprites_generator_layers(), variables)


def sprites_discriminator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesDiscriminator`` -> the port's
    ``SpritesDiscriminator``."""
    return from_flax(sprites_discriminator_layers(), variables)


def sprites_encoder_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesEncoder`` -> the port's
    ``SpritesEncoder``."""
    return from_flax(sprites_encoder_layers(), variables)


def mnist_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.MnistGenerator`` -> the port's
    ``MnistGenerator``."""
    return from_flax(MNIST_GENERATOR, variables)


def mnist_discriminator_from_flax(variables, img_size: int = 32) -> StateDict:
    """``eadgan_tpu.models.MnistDiscriminator`` -> the port's
    ``MnistDiscriminator``."""
    return from_flax(mnist_discriminator_layers(img_size), variables)


def mnist_encoder_from_flax(variables, img_size: int = 32) -> StateDict:
    """``eadgan_tpu.models.MnistEncoder`` -> the port's ``MnistEncoder``."""
    return from_flax(mnist_encoder_layers(img_size), variables)


def approximator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.AffineApproximator`` -> the port's
    ``AffineApproximator``."""
    return from_flax(APPROXIMATOR, variables)
