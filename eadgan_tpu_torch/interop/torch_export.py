"""The port's modules -> reference PyTorch state_dicts.

PyTorch counterpart of ``eadgan_tpu/interop/torch_export.py`` and the
inverse of :mod:`eadgan_tpu_torch.interop.torch_import`, so the
reference's own consumers (``MNIST/generate_image.py:146-152``,
``celebA/gen_imgs.py:106-114``, ``dSprites/score/BetVAE.py:193-205``)
can load weights trained by the port.  Every tensor but the
spectral-norm state is carried as it is (the port keeps the reference's
layout and keys).

Spectral-norm layers: torch's eval-mode forward computes ``weight =
weight_orig / (u . W v)`` from the stored ``weight_u``/``weight_v`` with
no power iteration.  The export writes ``weight_orig = W_eff``, the
effective weight the port's forward uses (its weight divided by the
sigma of one flax power step from its stored ``u``,
:func:`flax_sn_effective`), with ``weight_u`` its top left-singular
vector and ``weight_v`` scaled by ``1 / sigma(W_eff)``
(:func:`torch_sn_uv`), so torch's eval sigma is exactly 1 and its
forward weight exactly ``W_eff``.

One function, :func:`export_state_dict`, serves every model (the JAX
package's ``export_*`` per model): it takes the port module's
``state_dict`` and returns ``{reference_key: np.ndarray}``, ready for
:func:`save_torch_state_dict`.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from eadgan_tpu_torch.interop.torch_import import as_numpy

__all__ = [
    "flax_sn_effective",
    "torch_sn_uv",
    "export_state_dict",
    "save_torch_state_dict",
]


def save_torch_state_dict(path: str, sd: Dict[str, np.ndarray]) -> None:
    """Write a reference-loadable checkpoint of numpy arrays."""
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


def _l2n(x: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    return x / np.sqrt(np.sum(x * x) + eps)


def flax_sn_effective(w: np.ndarray, u: Optional[np.ndarray]) -> np.ndarray:
    """The effective weight of the port's spectral-norm forward, for a
    weight with the outputs first: one power step from the stored ``u``
    over W viewed as (out, -1), then W divided by that sigma (flax's
    ``SpectralNorm`` step; with no ``u``, iterate to the stationary
    point)."""
    mat = w.reshape(w.shape[0], -1).astype(np.float64)
    if u is None:
        rng = np.random.default_rng(0)
        u_vec = _l2n(rng.normal(size=(1, mat.shape[0])))
        steps = 100
    else:
        u_vec = np.asarray(u, np.float64).reshape(1, -1)
        steps = 1
    for _ in range(steps):
        v_vec = _l2n(u_vec @ mat)
        u_vec = _l2n(v_vec @ mat.T)
    sigma = ((v_vec @ mat.T) @ u_vec.T).item()
    return (w / (sigma if sigma != 0 else 1.0)).astype(np.float32)


def torch_sn_uv(w_torch: np.ndarray) -> tuple:
    """``(weight_u, weight_v)`` buffers making torch's eval-mode sigma
    exactly 1 for ``weight_orig = w_torch``."""
    mat = w_torch.reshape(w_torch.shape[0], -1).astype(np.float64)
    rng = np.random.default_rng(0)
    u = _l2n(rng.normal(size=mat.shape[0]))
    for _ in range(200):
        v = _l2n(mat.T @ u)
        u = _l2n(mat @ v)
    sigma = float(u @ mat @ v)
    return u.astype(np.float32), (v / sigma).astype(np.float32)


def export_state_dict(sd) -> Dict[str, np.ndarray]:
    """A port state_dict in the reference's keys: each spectral-norm layer
    (``<layer>.u``) becomes ``<layer>.weight_orig``, ``.weight_u`` and
    ``.weight_v``; every other tensor is copied as it is."""
    out: Dict[str, np.ndarray] = {}
    sn_layers = {k[: -len(".u")] for k in sd if k.endswith(".u")}
    for key, value in sd.items():
        layer, _, name = key.rpartition(".")
        if layer in sn_layers and name in ("u", "sigma"):
            continue  # the port's own power-iteration state
        array = as_numpy(value).copy()
        if layer in sn_layers and name == "weight":
            w_eff = flax_sn_effective(array.astype(np.float32), as_numpy(sd[f"{layer}.u"]))
            out[f"{layer}.weight_orig"] = w_eff
            out[f"{layer}.weight_u"], out[f"{layer}.weight_v"] = torch_sn_uv(w_eff)
        else:
            out[key] = array
    return out
