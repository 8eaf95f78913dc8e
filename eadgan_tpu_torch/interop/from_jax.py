"""Carry weights from the JAX package's flax variables into the port.

Each function takes the flax variables of one model as nested dicts of
numpy arrays, ``{"params": ..., "batch_stats": ...}``, and returns the
port model's ``state_dict`` (torch tensors).  Layout inverses (as in
``eadgan_tpu/interop/torch_export.py``, re-implemented here):

* conv kernel: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
* transposed-conv kernel: flax (kh, kw, in, out) with the taps flipped
  -> torch ConvTranspose2d (in, out, kh, kw);
* dense kernel: flax (in, out) -> torch Linear (out, in).  A dense layer
  that follows a flatten of a conv map also has its input rows permuted:
  flax flattens NHWC in (H, W, C) order, the port NCHW in (C, H, W)
  order.  Permuting rows leaves the singular values, so ``sigma``, and
  the stored ``u`` (one entry per output) as they were;
* BatchNorm: scale/bias -> weight/bias, mean/var -> running_mean/var.

Spectral-norm layers carry the *raw* kernel plus flax's stored ``u``
(``(1, out)`` under ``.../Conv_0/kernel/u`` or ``.../Dense_0/kernel/u``)
and ``sigma``: the port takes flax's power step itself and must start
from the same ``u``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
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
_SPRITES_FLAT = (64, 4, 4)  # (C, H, W) of the dSprites trunks' last map


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a writable copy


def conv_kernel(k) -> torch.Tensor:
    """flax (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_kernel(k) -> torch.Tensor:
    """flax (kh, kw, in, out), taps flipped -> torch ConvTranspose2d
    (in, out, kh, kw)."""
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def nchw_rows(c: int, h: int, w: int) -> np.ndarray:
    """For each input index of a (C, H, W)-order flatten, the index of the
    same element in an (H, W, C)-order flatten."""
    ci, hi, wi = np.meshgrid(np.arange(c), np.arange(h), np.arange(w), indexing="ij")
    return (hi * w * c + wi * c + ci).reshape(-1)


def dense_kernel(k, flatten_chw: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax (in, out) -> torch Linear (out, in); with ``flatten_chw`` the
    input rows are taken in the port's (C, H, W) flatten order."""
    k = np.asarray(k)
    if flatten_chw is not None:
        k = k[nchw_rows(*flatten_chw)]
    return _t(k.T)


def _conv(sd: StateDict, key: str, variables, module: str, sn=False, transpose=False) -> None:
    inner = "ConvTranspose_0" if transpose else "Conv_0"
    leaf = variables["params"][module][inner]
    sd[f"{key}.weight"] = (conv_transpose_kernel if transpose else conv_kernel)(leaf["kernel"])
    sd[f"{key}.bias"] = _t(leaf["bias"])
    if sn:
        _sn_state(sd, key, variables, module, inner)


def _dense(sd: StateDict, key: str, variables, module: str, sn=False, flatten_chw=None) -> None:
    leaf = variables["params"][module]["Dense_0"]
    sd[f"{key}.weight"] = dense_kernel(leaf["kernel"], flatten_chw)
    sd[f"{key}.bias"] = _t(leaf["bias"])
    if sn:
        _sn_state(sd, key, variables, module, "Dense_0")


def _sn_state(sd: StateDict, key: str, variables, module: str, inner: str) -> None:
    sn = variables["batch_stats"][module]["SpectralNorm_0"]
    sd[f"{key}.u"] = _t(sn[f"{inner}/kernel/u"]).reshape(-1)
    sd[f"{key}.sigma"] = _t(sn[f"{inner}/kernel/sigma"]).reshape(())


def _batch_norm(sd: StateDict, key: str, variables, module: str) -> None:
    leaf = variables["params"][module]["BatchNorm_0"]
    st = variables["batch_stats"][module]["BatchNorm_0"]
    sd[f"{key}.weight"] = _t(leaf["scale"])
    sd[f"{key}.bias"] = _t(leaf["bias"])
    sd[f"{key}.running_mean"] = _t(st["mean"])
    sd[f"{key}.running_var"] = _t(st["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def celeba_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.CelebaGenerator`` variables -> the port's
    ``CelebaGenerator`` state_dict."""
    sd: StateDict = {}
    for i, seq in enumerate((0, 1, 4, 7, 10)):
        _conv(sd, f"conv_blocks.{seq}", variables, f"TorchConvTranspose_{i}", transpose=True)
    for i, seq in enumerate((2, 5, 8)):
        _batch_norm(sd, f"conv_blocks.{seq}", variables, f"TorchBatchNorm_{i}")
    return sd


def celeba_discriminator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.CelebaDiscriminator`` variables -> the port's
    ``CelebaDiscriminator`` state_dict."""
    sd: StateDict = {}
    for i, seq in enumerate((0, 2, 4, 6)):
        _conv(sd, f"main.{seq}", variables, f"SNConv_{i}", sn=True)
    _conv(sd, "main.8", variables, "TorchConv_0")
    return sd


def _sprites_trunk(sd: StateDict, variables, module: str, sn: bool) -> None:
    for i, seq in enumerate((0, 2, 4, 6)):
        _conv(sd, f"conv_block.{seq}", variables, f"{module}_{i}", sn=sn)


def sprites_encoder_pxy_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesEncoderPxy`` -> the port's
    ``SpritesEncoderPxy``."""
    sd: StateDict = {}
    _sprites_trunk(sd, variables, "TorchConv", sn=False)
    _dense(sd, "fc1", variables, "TorchDense_0", flatten_chw=_SPRITES_FLAT)
    return sd


def sprites_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesGenerator`` -> the port's
    ``SpritesGenerator`` (its fc output is viewed NCHW on both sides: no
    permutation)."""
    sd: StateDict = {}
    _dense(sd, "fc1.0", variables, "TorchDense_0")
    _dense(sd, "fc2.0", variables, "TorchDense_1")
    for i, seq in enumerate((0, 3, 6, 9)):
        _conv(sd, f"conv_block.{seq}", variables, f"TorchConvTranspose_{i}", transpose=True)
    for i, seq in enumerate((1, 4, 7)):
        _batch_norm(sd, f"conv_block.{seq}", variables, f"TorchBatchNorm_{i}")
    return sd


def sprites_discriminator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesDiscriminator`` -> the port's
    ``SpritesDiscriminator``."""
    sd: StateDict = {}
    _sprites_trunk(sd, variables, "SNConv", sn=True)
    _dense(sd, "fc1.0", variables, "SNDense_0", sn=True, flatten_chw=_SPRITES_FLAT)
    _dense(sd, "fc2", variables, "TorchDense_0")
    return sd


def sprites_encoder_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.SpritesEncoder`` -> the port's
    ``SpritesEncoder``."""
    sd: StateDict = {}
    _sprites_trunk(sd, variables, "SNConv", sn=True)
    _dense(sd, "fc1.0", variables, "SNDense_0", sn=True, flatten_chw=_SPRITES_FLAT)
    _dense(sd, "fc2.0", variables, "SNDense_1", sn=True)
    _dense(sd, "cat_layer.0", variables, "SNDense_2", sn=True)
    _dense(sd, "cont_layer.0", variables, "SNDense_3", sn=True)
    return sd


def _mnist_flat(img_size: int) -> Tuple[int, int, int]:
    """(C, H, W) of the MNIST trunks' last map."""
    return (128, img_size // 16, img_size // 16)


def mnist_generator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.MnistGenerator`` -> the port's
    ``MnistGenerator`` (its fc output is viewed NCHW on both sides: no
    permutation)."""
    sd: StateDict = {}
    _dense(sd, "l1.0", variables, "TorchDense_0")
    _batch_norm(sd, "conv_blocks.0", variables, "TorchBatchNorm_0")
    for i, (conv, bn) in enumerate(((2, 3), (6, 7))):
        _conv(sd, f"conv_blocks.{conv}", variables, f"TorchConv_{i}")
        _batch_norm(sd, f"conv_blocks.{bn}", variables, f"TorchBatchNorm_{i + 1}")
    _conv(sd, "conv_blocks.9", variables, "TorchConv_2")
    return sd


def mnist_discriminator_from_flax(variables, img_size: int = 32) -> StateDict:
    """``eadgan_tpu.models.MnistDiscriminator`` -> the port's
    ``MnistDiscriminator``."""
    sd: StateDict = {}
    for i, seq in enumerate((0, 2, 4, 6)):
        _conv(sd, f"conv_blocks.{seq}", variables, f"SNConv_{i}", sn=True)
    _dense(sd, "adv_layer.0", variables, "SNDense_0", sn=True, flatten_chw=_mnist_flat(img_size))
    return sd


def mnist_encoder_from_flax(variables, img_size: int = 32) -> StateDict:
    """``eadgan_tpu.models.MnistEncoder`` -> the port's ``MnistEncoder``."""
    sd: StateDict = {}
    for i, seq in enumerate((0, 2, 5, 8)):
        _conv(sd, f"conv_blocks.{seq}", variables, f"SNConv_{i}", sn=True)
    for i, seq in enumerate((4, 7, 10)):
        _batch_norm(sd, f"conv_blocks.{seq}", variables, f"TorchBatchNorm_{i}")
    flat = _mnist_flat(img_size)
    for i, head in enumerate(("aux_layer", "latent_layer", "noise_layer")):
        _dense(sd, f"{head}.0", variables, f"SNDense_{i}", sn=True, flatten_chw=flat)
    return sd


def approximator_from_flax(variables) -> StateDict:
    """``eadgan_tpu.models.AffineApproximator`` -> the port's
    ``AffineApproximator``."""
    sd: StateDict = {}
    for i, seq in enumerate((0, 2, 4, 6, 8)):
        _dense(sd, f"fc_block.{seq}", variables, f"TorchDense_{i}")
    return sd
