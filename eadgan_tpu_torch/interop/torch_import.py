"""Reference PyTorch state_dicts -> the port's modules.

PyTorch counterpart of ``eadgan_tpu/interop/torch_import.py``.  The
port's modules keep the reference's layout and key names (NCHW, a
(C, H, W) flatten before each trunk's first fc, torch's conv, transposed
conv and linear layouts, ``BatchNorm2d`` keys), so every tensor but the
spectral-norm state is carried as it is.  A reference spectral-norm
layer stores ``weight_orig`` with torch's power-iteration vectors
``weight_u``/``weight_v``; the port's stores ``weight`` with flax's
``u``/``sigma`` (``models/layers.py``).  The importer makes the JAX
package's choice:

* ``weight`` is torch's eval-time effective weight ``weight_orig /
  (u . W v)`` with the stored vectors (:func:`sn_effective`);
* ``u`` is the unit-sigma solution (:func:`sn_u0_unit_sigma`): the
  port's one power step from it gives sigma = 1 to float32 rounding, so
  the eval forward divides the pre-normalized weight by 1.  It is
  computed on the kernel in flax's (in..., out) layout, as the JAX
  importer computes it, so the two give the same ``u``;
* ``sigma`` is 1.

Do NOT re-converge the power iteration: at the SN equilibrium of
long-trained layers (all singular values ~1) a converged iteration
finds s1 != u'Wv, and each layer's effective weight skews ~1e-3
relative against the torch eval forward, compounding to percent-level
head outputs.

Each ``import_*`` takes a reference state_dict (tensors or numpy
arrays) and returns the port module's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "sn_effective",
    "sn_u0_unit_sigma",
    "as_numpy",
    "convert_state_dict",
    "load_torch_state_dict",
    "import_approximator",
    "import_mnist_generator",
    "import_mnist_encoder",
    "import_mnist_discriminator",
    "import_sprites_encoder_pxy",
    "import_sprites_generator",
    "import_sprites_discriminator",
    "import_sprites_encoder",
    "import_celeba_generator",
    "import_celeba_discriminator",
]

StateDict = Dict[str, torch.Tensor]
Flatten = Dict[str, Tuple[int, int, int]]

_SPRITES_FLATTEN = {"fc1.0": (64, 4, 4)}  # the SN fc after the dSprites trunks


def _mnist_flatten(img_size: int, heads) -> Flatten:
    ds = img_size // 16
    return {head: (128, ds, ds) for head in heads}


def load_torch_state_dict(path: str) -> StateDict:
    """A reference ``.pt`` state_dict, on the CPU (tensors only)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def as_numpy(x) -> np.ndarray:
    """A tensor (detached, on the CPU) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def nchw_flatten_perm(c: int, h: int, w: int) -> np.ndarray:
    """``p`` with ``p[flax_idx] = torch_idx``: flax flattens a conv map in
    (H, W, C) order, torch in (C, H, W) order."""
    ci, hi, wi = np.meshgrid(np.arange(c), np.arange(h), np.arange(w), indexing="ij")
    perm = np.empty(c * h * w, np.int64)
    perm[(hi * w * c + wi * c + ci).reshape(-1)] = np.arange(c * h * w)
    return perm


def flax_kernel(w: np.ndarray, flatten_chw: Optional[Tuple[int, int, int]] = None) -> np.ndarray:
    """A torch conv (out, in, kh, kw) or linear (out, in) weight in the JAX
    package's layout: (kh, kw, in, out), or (in, out) with a flattened
    conv map's rows in (H, W, C) order."""
    if w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    k = w.T
    if flatten_chw is not None:
        k = k[nchw_flatten_perm(*flatten_chw)]
    return np.ascontiguousarray(k)


def sn_effective(w: np.ndarray, u: Optional[np.ndarray], v: Optional[np.ndarray] = None) -> np.ndarray:
    """torch spectral_norm's effective weight W / sigma over W viewed as
    (out, -1).

    With the checkpoint's stored ``weight_u`` AND ``weight_v``, sigma is
    ``u . W v`` with no iteration: exactly the cached weight torch's
    eval-mode forward uses.  With only u, one torch-style power
    iteration; with neither, iterate to convergence from a fixed seed.
    """
    mat = w.reshape(w.shape[0], -1).astype(np.float64)
    eps = 1e-12
    if u is not None and v is not None:
        u_vec = np.asarray(u, np.float64).reshape(-1)
        v_vec = np.asarray(v, np.float64).reshape(-1)
        sigma = float(u_vec @ mat @ v_vec)
        return (w / sigma).astype(np.float32)
    if u is None:
        rng = np.random.default_rng(0)
        u_vec = rng.normal(size=mat.shape[0])
        n_iter = 50
    else:
        u_vec = np.asarray(u, np.float64).reshape(-1)
        n_iter = 1
    for _ in range(n_iter):
        v_vec = mat.T @ u_vec
        v_vec /= np.linalg.norm(v_vec) + eps
        u_vec = mat @ v_vec
        u_vec /= np.linalg.norm(u_vec) + eps
    sigma = float(u_vec @ mat @ v_vec)
    return (w / sigma).astype(np.float32)


def sn_u0_unit_sigma(kernel: np.ndarray) -> np.ndarray:
    """The stored ``u`` (one entry per output) that makes one flax power
    step on a pre-normalized ``kernel`` (flax layout, outputs last) give
    sigma = 1 exactly.

    One step from ``u0`` gives ``v0 = normalize(u0 K^T)`` and ``sigma =
    |v0 K|``.  With K = U S V^T, ``u0 = cos/S_i V_i + sin/S_j V_j`` gives
    ``sigma = sqrt(cos^2 S_i^2 + sin^2 S_j^2)``; cos^2 = (1 - S_j^2) /
    (S_i^2 - S_j^2) for S_j <= 1 <= S_i pins it to 1.  S_0 >= 1 holds on
    a pre-normalized kernel (the Rayleigh quotient is at most s1); when
    every S > 1, or no usable S_j exists, the closest achievable vector.
    """
    mat = kernel.reshape(-1, kernel.shape[-1]).astype(np.float64)
    _, s, vt = np.linalg.svd(mat, full_matrices=False)
    if s[0] <= 1.0:  # sigma range tops out below 1: top vector is closest
        u0 = vt[0]
    else:
        below = [j for j in range(len(s)) if s[j] <= 1.0 and s[j] > 1e-6]
        if not below:
            u0 = vt[-1] if s[-1] > 1.0 else vt[0]
        else:
            j = below[0]  # largest singular value <= 1 (s is descending)
            c2 = (1.0 - s[j] ** 2) / (s[0] ** 2 - s[j] ** 2)
            c2 = min(max(c2, 0.0), 1.0)
            cos, sin = np.sqrt(c2), np.sqrt(1.0 - c2)
            u0 = (cos / s[0]) * vt[0] + (sin / s[j]) * vt[j]
            u0 = u0 / (np.linalg.norm(u0) + 1e-300)
    return u0.astype(np.float32)


def convert_state_dict(sd, flatten: Optional[Flatten] = None) -> StateDict:
    """A reference state_dict in the port's keys: each spectral-norm layer
    (``<layer>.weight_orig``) becomes ``<layer>.weight`` (the effective
    weight), ``.u`` (unit sigma) and ``.sigma`` (1); ``flatten`` gives the
    (C, H, W) of the conv map each spectral-norm linear layer reads
    flattened, for its ``u``.  Every other tensor is copied as it is."""
    flatten = flatten or {}
    out: StateDict = {}
    for key, value in sd.items():
        if key.endswith((".weight_u", ".weight_v")):
            continue
        if key.endswith(".weight_orig"):
            layer = key[: -len(".weight_orig")]
            uv = (sd.get(f"{layer}.weight_{p}") for p in "uv")
            w = sn_effective(as_numpy(value), *(None if t is None else as_numpy(t) for t in uv))
            out[f"{layer}.weight"] = torch.from_numpy(w)
            out[f"{layer}.u"] = torch.from_numpy(sn_u0_unit_sigma(flax_kernel(w, flatten.get(layer))))
            out[f"{layer}.sigma"] = torch.ones((), dtype=torch.float32)
        else:
            out[key] = torch.as_tensor(as_numpy(value)).clone()
    return out


def _require(sd, *keys) -> None:
    """A ``KeyError`` naming the first of ``keys`` that ``sd`` lacks."""
    for key in keys:
        if key not in sd:
            raise KeyError(key)


# dSprites family (dSprites/pxy.py:54-80, dSprites/rp.py:61-194; colored
# variants share the structure with 3 channels / wider heads)


def import_sprites_encoder_pxy(sd) -> StateDict:
    _require(sd, "conv_block.0.weight", "fc1.weight")
    return convert_state_dict(sd)


def import_sprites_discriminator(sd) -> StateDict:
    _require(sd, "conv_block.0.weight_orig", "fc1.0.weight_orig", "fc2.weight")
    return convert_state_dict(sd, _SPRITES_FLATTEN)


def import_sprites_generator(sd) -> StateDict:
    _require(sd, "fc1.0.weight", "conv_block.1.running_mean")
    return convert_state_dict(sd)


def import_sprites_encoder(sd) -> StateDict:
    _require(sd, "conv_block.0.weight_orig", "cat_layer.0.weight_orig", "cont_layer.0.weight_orig")
    return convert_state_dict(sd, _SPRITES_FLATTEN)


# MNIST family (MNIST/EAD-GAN_rpqmnxy.py:71-175, MNIST/approximate_rpqmnxy.py:20-42)


def import_mnist_generator(sd) -> StateDict:
    _require(sd, "l1.0.weight", "conv_blocks.0.running_mean")
    return convert_state_dict(sd)


def import_mnist_encoder(sd, img_size: int = 32) -> StateDict:
    heads = ("aux_layer.0", "latent_layer.0", "noise_layer.0")
    _require(sd, "conv_blocks.0.weight_orig", *(f"{h}.weight_orig" for h in heads))
    return convert_state_dict(sd, _mnist_flatten(img_size, heads))


def import_mnist_discriminator(sd, img_size: int = 32) -> StateDict:
    _require(sd, "conv_blocks.0.weight_orig", "adv_layer.0.weight_orig")
    return convert_state_dict(sd, _mnist_flatten(img_size, ("adv_layer.0",)))


def import_approximator(sd) -> StateDict:
    _require(sd, "fc_block.0.weight")
    return convert_state_dict(sd)


# CelebA family (celebA/EAD-GAN_celebA.py:67-138; checkpoint_%d.tar holds
# {'generator_state_dict', 'discriminator_state_dict', ...})


def import_celeba_generator(sd) -> StateDict:
    _require(sd, "conv_blocks.0.weight", "conv_blocks.2.running_mean")
    return convert_state_dict(sd)


def import_celeba_discriminator(sd) -> StateDict:
    _require(sd, "main.0.weight_orig", "main.8.weight")
    return convert_state_dict(sd)
