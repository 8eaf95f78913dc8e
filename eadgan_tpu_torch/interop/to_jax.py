"""The port's weights as the JAX package's flax variables.

The inverse of ``interop/from_jax.py``, read from the same per-model
tables: each ``*_to_flax`` function takes a port model's ``state_dict``
and returns ``{"params": ..., "batch_stats": ...}`` as nested dicts of
C-contiguous float32 numpy arrays, every dict's keys sorted (the order
in which JAX leaves a tree after any jitted step, so the tree packs to
the bytes the JAX package writes).  Conv kernels go back to
(kh, kw, in, out), transposed-conv taps are flipped back, dense kernels
to (in, out) with a flatten's rows back in (H, W, C) order, ``u`` to
``(1, out)``; ``sigma`` and the BatchNorm statistics are kept as
stored, and ``num_batches_tracked`` (which flax has not) is dropped.
Every step is a permutation, so ``from_flax(to_flax(sd)) == sd`` bit
for bit (up to ``num_batches_tracked``, which comes back as 0).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from eadgan_tpu_torch.interop.from_jax import (
    APPROXIMATOR,
    CELEBA_DISCRIMINATOR,
    CELEBA_GENERATOR,
    MNIST_GENERATOR,
    Layer,
    leaves,
    mnist_discriminator_layers,
    mnist_encoder_layers,
    sprites_discriminator_layers,
    sprites_encoder_layers,
    sprites_encoder_pxy_layers,
    sprites_generator_layers,
)

__all__ = [
    "to_flax",
    "sorted_tree",
    "celeba_generator_to_flax",
    "celeba_discriminator_to_flax",
    "sprites_encoder_pxy_to_flax",
    "sprites_generator_to_flax",
    "sprites_discriminator_to_flax",
    "sprites_encoder_to_flax",
    "mnist_generator_to_flax",
    "mnist_discriminator_to_flax",
    "mnist_encoder_to_flax",
    "approximator_to_flax",
]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _c_order(x: np.ndarray) -> np.ndarray:
    return x if x.flags.c_contiguous else x.copy(order="C")  # 0-d stays 0-d


def sorted_tree(tree):
    """Every dict of ``tree`` with its keys sorted, as a JAX tree
    flatten/unflatten leaves it."""
    if isinstance(tree, dict):
        return {k: sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def to_flax(layers: List[Layer], sd: Dict[str, torch.Tensor], params_only: bool = False) -> dict:
    """A port model's ``state_dict`` -> its flax variables.  With
    ``params_only`` only the parameters are read (``sd`` may hold Adam
    moments under the parameters' keys) and only ``params`` comes back."""
    out: dict = {"params": {}} if params_only else {"params": {}, "batch_stats": {}}
    for leaf in leaves(layers):
        if params_only and not leaf.param:
            continue
        node = out
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = _c_order(leaf.to_flax(_np(sd[leaf.key])))
    return sorted_tree(out)


def celeba_generator_to_flax(sd) -> dict:
    """The port's ``CelebaGenerator`` -> ``eadgan_tpu.models.CelebaGenerator``."""
    return to_flax(CELEBA_GENERATOR, sd)


def celeba_discriminator_to_flax(sd) -> dict:
    """The port's ``CelebaDiscriminator`` -> ``eadgan_tpu.models.CelebaDiscriminator``."""
    return to_flax(CELEBA_DISCRIMINATOR, sd)


def sprites_encoder_pxy_to_flax(sd) -> dict:
    """The port's ``SpritesEncoderPxy`` -> ``eadgan_tpu.models.SpritesEncoderPxy``."""
    return to_flax(sprites_encoder_pxy_layers(), sd)


def sprites_generator_to_flax(sd) -> dict:
    """The port's ``SpritesGenerator`` -> ``eadgan_tpu.models.SpritesGenerator``."""
    return to_flax(sprites_generator_layers(), sd)


def sprites_discriminator_to_flax(sd) -> dict:
    """The port's ``SpritesDiscriminator`` -> ``eadgan_tpu.models.SpritesDiscriminator``."""
    return to_flax(sprites_discriminator_layers(), sd)


def sprites_encoder_to_flax(sd) -> dict:
    """The port's ``SpritesEncoder`` -> ``eadgan_tpu.models.SpritesEncoder``."""
    return to_flax(sprites_encoder_layers(), sd)


def mnist_generator_to_flax(sd) -> dict:
    """The port's ``MnistGenerator`` -> ``eadgan_tpu.models.MnistGenerator``."""
    return to_flax(MNIST_GENERATOR, sd)


def mnist_discriminator_to_flax(sd, img_size: int = 32) -> dict:
    """The port's ``MnistDiscriminator`` -> ``eadgan_tpu.models.MnistDiscriminator``."""
    return to_flax(mnist_discriminator_layers(img_size), sd)


def mnist_encoder_to_flax(sd, img_size: int = 32) -> dict:
    """The port's ``MnistEncoder`` -> ``eadgan_tpu.models.MnistEncoder``."""
    return to_flax(mnist_encoder_layers(img_size), sd)


def approximator_to_flax(sd) -> dict:
    """The port's ``AffineApproximator`` -> ``eadgan_tpu.models.AffineApproximator``."""
    return to_flax(APPROXIMATOR, sd)
