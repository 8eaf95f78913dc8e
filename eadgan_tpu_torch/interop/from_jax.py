"""Carry weights from the JAX package's flax variables into the port.

Each function takes the flax variables of one model as nested dicts of
numpy arrays, ``{"params": ..., "batch_stats": ...}``, and returns the
port model's ``state_dict`` (torch tensors).  Layout inverses (as in
``eadgan_tpu/interop/torch_export.py``, re-implemented here):

* conv kernel: flax (kh, kw, in, out) -> torch (out, in, kh, kw);
* transposed-conv kernel: flax (kh, kw, in, out) with the taps flipped
  -> torch ConvTranspose2d (in, out, kh, kw);
* BatchNorm: scale/bias -> weight/bias, mean/var -> running_mean/var.

Spectral-norm layers carry the *raw* kernel plus flax's stored ``u``
(``(1, out)`` under ``.../Conv_0/kernel/u``) and ``sigma``: the port
takes flax's power step itself and must start from the same ``u``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["celeba_generator_from_flax", "celeba_discriminator_from_flax"]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, order="C"))  # a writable copy


def conv_kernel(k) -> torch.Tensor:
    """flax (kh, kw, in, out) -> torch Conv2d (out, in, kh, kw)."""
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def conv_transpose_kernel(k) -> torch.Tensor:
    """flax (kh, kw, in, out), taps flipped -> torch ConvTranspose2d
    (in, out, kh, kw)."""
    return _t(np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)))


def celeba_generator_from_flax(variables) -> Dict[str, torch.Tensor]:
    """``eadgan_tpu.models.CelebaGenerator`` variables -> the port's
    ``CelebaGenerator`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i, seq in enumerate((0, 1, 4, 7, 10)):
        leaf = params[f"TorchConvTranspose_{i}"]["ConvTranspose_0"]
        sd[f"conv_blocks.{seq}.weight"] = conv_transpose_kernel(leaf["kernel"])
        sd[f"conv_blocks.{seq}.bias"] = _t(leaf["bias"])
    for i, seq in enumerate((2, 5, 8)):
        leaf = params[f"TorchBatchNorm_{i}"]["BatchNorm_0"]
        st = stats[f"TorchBatchNorm_{i}"]["BatchNorm_0"]
        sd[f"conv_blocks.{seq}.weight"] = _t(leaf["scale"])
        sd[f"conv_blocks.{seq}.bias"] = _t(leaf["bias"])
        sd[f"conv_blocks.{seq}.running_mean"] = _t(st["mean"])
        sd[f"conv_blocks.{seq}.running_var"] = _t(st["var"])
        sd[f"conv_blocks.{seq}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def celeba_discriminator_from_flax(variables) -> Dict[str, torch.Tensor]:
    """``eadgan_tpu.models.CelebaDiscriminator`` variables -> the port's
    ``CelebaDiscriminator`` state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for i, seq in enumerate((0, 2, 4, 6)):
        leaf = params[f"SNConv_{i}"]["Conv_0"]
        sn = stats[f"SNConv_{i}"]["SpectralNorm_0"]
        sd[f"main.{seq}.weight"] = conv_kernel(leaf["kernel"])
        sd[f"main.{seq}.bias"] = _t(leaf["bias"])
        sd[f"main.{seq}.u"] = _t(sn["Conv_0/kernel/u"]).reshape(-1)
        sd[f"main.{seq}.sigma"] = _t(sn["Conv_0/kernel/sigma"]).reshape(())
    leaf = params["TorchConv_0"]["Conv_0"]
    sd["main.8.weight"] = conv_kernel(leaf["kernel"])
    sd["main.8.bias"] = _t(leaf["bias"])
    return sd
