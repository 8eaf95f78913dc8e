"""Layers whose state and compute types follow the JAX package (flax), not
torch's defaults.

PyTorch counterpart of ``eadgan_tpu/models/layers.py``.  Plain convs and
transposed convs (:class:`TorchConv`, :class:`TorchConvTranspose`) are
torch's own ``nn.Conv2d`` / ``nn.ConvTranspose2d`` with torch's default
init, which the JAX package's ``ops/init.py`` only re-creates, plus a
compute ``dtype`` as flax's: ``None`` computes in the parameters' float32;
``torch.bfloat16`` casts the input, the weight and the bias to bf16,
convolves without the bias, adds the bias in bf16 and returns bf16, as
flax's ``Conv(dtype=bf16)`` does (``promote_dtype``, then ``y += bias``).
:class:`TorchDense` is ``nn.Linear`` with the same compute ``dtype``.
Parameters stay float32 either way.  Three layers carry state that torch
would handle differently:

* :class:`SNConv` and :class:`SNDense` do flax's spectral normalization
  (one power step from a stored ``u`` per forward, ``sigma`` stored
  beside it), not ``torch.nn.utils.spectral_norm``'s
  ``weight_u``/``weight_v`` scheme.  The power step always runs in
  float32 on the float32 weight: the JAX package's ``nn.SpectralNorm``
  wraps the bf16 layer but takes no dtype itself, so it normalizes the
  float32 kernel and the layer casts the result.  An unsharded layer
  takes ``ops/sn_cuda.py::spectral_norm``, which writes the normalized
  weight in the compute type (on the card by its kernels, forward and
  backward), so the layer's own cast is a no-op;
* :class:`TorchBatchNorm` normalizes with the biased batch variance
  (E[x^2] - E[x]^2, as flax computes it) and also updates the running
  variance with the biased value, where torch's would use the unbiased.

They update their state in training mode only, and not inside
:func:`no_stat_updates` (a BatchNorm built with ``always_batch_stats``,
the MNIST encoder's, normalizes with batch statistics and updates them
in eval mode too).  :func:`upsample_nearest` is torch's
``nn.Upsample(scale_factor=2)``.  Layout is NCHW.

The five weight layers run column-parallel once
``parallel.shard_model_params`` has cut their weight over a model axis
(``model_shard`` set; ``out_dim`` is the weight's output dimension): the
input passes ``copy_to_model``, the conv or product runs on this rank's
output rows without the bias, ``gather_from_model`` puts the output
features back together, and the full, replicated bias is added after
(so in bf16 it is rounded where flax rounds it, and its gradient is the
replicated one with no collective).  Spectral norm on a sharded weight
takes its power step on the float32 shard with partial products summed
over the model group (:meth:`_SpectralNorm.normalized_weight`); ``u``
and ``sigma`` stay full and replicated.  Unsharded, no layer issues a
model collective.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from eadgan_tpu_torch.ops.sn_cuda import SN_EPS, l2n, spectral_norm
from eadgan_tpu_torch.parallel.mesh import (
    axis_size,
    copy_to_model,
    gather_from_model,
    global_mean,
    reduce_from_model,
)

__all__ = [
    "TorchConv",
    "TorchConvTranspose",
    "TorchDense",
    "SNConv",
    "SNDense",
    "TorchBatchNorm",
    "UpsampleNearest",
    "no_stat_updates",
    "upsample_nearest",
]

def _add_bias(y: torch.Tensor, bias, dtype) -> torch.Tensor:
    """flax's bias step under a compute dtype: ``y`` (conv output in
    ``dtype``) plus the bias rounded to ``dtype``, in ``dtype``."""
    if bias is None:
        return y
    return y + bias.to(dtype)[None, :, None, None]


def _column_parallel(x, weight, bias, dt, shard, op, dim: int) -> torch.Tensor:
    """``op(x, weight)`` with ``weight`` this rank's output rows of a
    model-sharded layer: ``x`` copied to the model group, ``op`` in the
    compute type ``dt`` without the bias, the outputs gathered along
    ``dim``, then the full bias added in ``dt``."""
    x = copy_to_model(x, shard.mesh)
    if dt is not None:
        x, weight = x.to(dt), weight.to(dt)
    y = gather_from_model(op(x, weight), dim, shard.mesh)
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + (bias if dt is None else bias.to(dt)).view(shape)


class TorchConv(nn.Conv2d):
    """``nn.Conv2d`` with a compute ``dtype`` (None: float32)."""

    out_dim = 0
    model_shard = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self.compute_dtype = dtype

    def conv(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.model_shard is not None:
            return _column_parallel(x, weight, self.bias, dt, self.model_shard,
                                    lambda a, w: self._conv_forward(a, w, None), 1)
        if dt is None:
            return self._conv_forward(x, weight, self.bias)
        y = self._conv_forward(x.to(dt), weight.to(dt), None)
        return _add_bias(y, self.bias, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.weight)


class TorchConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with a compute ``dtype`` (None: float32)."""

    out_dim = 1
    model_shard = None

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.model_shard is not None:
            return _column_parallel(
                x, self.weight, self.bias, dt, self.model_shard,
                lambda a, w: F.conv_transpose2d(a, w, None, self.stride, self.padding), 1)
        if dt is None:
            return super().forward(x)
        y = F.conv_transpose2d(
            x.to(dt), self.weight.to(dt), None, self.stride, self.padding
        )
        return _add_bias(y, self.bias, dt)


class TorchDense(nn.Linear):
    """``nn.Linear`` with a compute ``dtype`` (None: float32), rounded
    at flax ``Dense``'s points: input, weight and bias cast to ``dtype``,
    the product without the bias, then the bias added in ``dtype``."""

    out_dim = 0
    model_shard = None

    def __init__(self, in_features, out_features, dtype=None):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def linear(self, x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.model_shard is not None:
            return _column_parallel(x, weight, self.bias, dt, self.model_shard,
                                    F.linear, x.dim() - 1)
        if dt is None:
            return F.linear(x, weight, self.bias)
        return F.linear(x.to(dt), weight.to(dt)) + self.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, self.weight)


class _SpectralNorm:
    """flax ``SpectralNorm`` state and power step for a layer whose
    ``weight`` has the output features first (conv or linear).

    Each forward takes one power step over the weight viewed as
    (in_features..., out) (here as its transpose, (out, K): the same
    singular values, with ``v`` permuted):
    ``v = l2n(u W^T)``, ``u = l2n(v W)``, both detached, then
    ``sigma = v W u^T`` and the weight is divided by ``sigma`` (unless it
    is 0).  ``u`` (shape (out,)) and ``sigma`` are stored only in
    training mode; in eval mode the step is still taken, from the stored
    ``u``, and discarded.  Unsharded, :func:`spectral_norm` takes the
    step and returns the weight in the layer's compute type.

    On a model-sharded weight (this rank's rows of W) the same step in
    float32: ``v = l2n(sum over the group of u[rows] W_rows^T)``, this
    rank's ``W_rows v`` normalized by the group's sum of squares, ``sigma``
    the group's sum of the partial dot products (:func:`reduce_from_model`,
    whose backward is the identity) passed through :func:`copy_to_model`
    before it divides this rank's rows (each rank's share of the gradient
    by ``sigma`` is summed there), and the stored ``u`` gathered whole.
    """

    def _register_sn(self, out_features: int) -> None:
        self.register_buffer("u", torch.randn(out_features))
        self.register_buffer("sigma", torch.ones(()))
        self.update_stats = True

    def normalized_weight(self) -> torch.Tensor:
        """The weight over sigma: in the compute type unsharded, float32
        on a model-sharded weight (whose layer casts it)."""
        update = self.training and self.update_stats
        shard = self.model_shard
        if shard is None:
            return spectral_norm(self.weight, self.u, self.sigma, self.compute_dtype, update)
        w = self.weight
        w_mat = w.reshape(w.shape[0], -1)  # (out, K): this rank's rows
        mesh = shard.mesh
        with torch.no_grad():
            v = l2n(reduce_from_model(self.u[shard.rows] @ w_mat, mesh))
            u = w_mat @ v
            u = u * torch.rsqrt(reduce_from_model((u * u).sum(), mesh) + SN_EPS)
        sigma = reduce_from_model(torch.dot(w_mat @ v, u), mesh)
        if update:
            with torch.no_grad():
                self.u.copy_(gather_from_model(u, 0, mesh))
                self.sigma.copy_(sigma)
        # each rank divides only its rows by sigma, so the loss's gradient
        # by sigma is a sum over the group: copy's backward sums it
        sigma = copy_to_model(sigma, mesh)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv(_SpectralNorm, TorchConv):
    """Spectral-normalized ``nn.Conv2d`` with flax ``SpectralNorm`` state
    (:class:`_SpectralNorm`)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride, padding, dtype)
        self._register_sn(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x, self.normalized_weight())


class SNDense(_SpectralNorm, TorchDense):
    """Spectral-normalized ``nn.Linear`` with flax ``SpectralNorm`` state
    (:class:`_SpectralNorm`)."""

    def __init__(self, in_features, out_features, dtype=None):
        super().__init__(in_features, out_features, dtype)
        self._register_sn(out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, self.normalized_weight())


class TorchBatchNorm(nn.Module):
    """BatchNorm2d with flax semantics (momentum 0.9 on the running
    value, i.e. torch momentum 0.1; eps 1e-5).

    Training mode normalizes with the batch mean and the biased batch
    variance and updates ``running = 0.9 * running + 0.1 * batch`` with
    both (unless :func:`no_stat_updates` is active).  Eval mode uses the
    running statistics, like torch ``.eval()``, unless
    ``always_batch_stats``: then eval mode is training mode, as the JAX
    package's BatchNorm called without ``use_running_average`` is (the
    MNIST encoder's).  Statistics are float32; the output keeps the
    input's dtype.  ``state_dict`` keys are those of ``nn.BatchNorm2d``.
    Inside a data-parallel step (``parallel.data_axis``) the batch
    statistics are those of the global batch: the ranks' means of x and
    x^2 averaged over the data axis (the grid's data group) in one
    all-reduce, whose backward all-reduces their gradient, as the JAX
    package's means over a sharded batch are under SPMD.  A BatchNorm
    after a model-sharded layer sees its gathered, full channels.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9,
                 always_batch_stats: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.always_batch_stats = always_batch_stats
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training or self.always_batch_stats):
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                training=False, eps=self.eps,
            )
        xf = x.float()
        mean = xf.mean(dim=(0, 2, 3))
        mean2 = (xf * xf).mean(dim=(0, 2, 3))
        if axis_size():
            # inside a data-parallel step: statistics of the global batch
            mean, mean2 = global_mean(torch.stack([mean, mean2])).unbind(0)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
                self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None]
        return (y + self.bias[None, :, None, None]).to(x.dtype)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour upsampling of an NCHW batch by ``factor`` along H
    and W (each pixel repeated ``factor`` x ``factor`` times)."""
    return F.interpolate(x, scale_factor=factor, mode="nearest")


class UpsampleNearest(nn.Module):
    """:func:`upsample_nearest` as a module (no parameters)."""

    def __init__(self, factor: int = 2):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_nearest(x, self.factor)


@contextlib.contextmanager
def no_stat_updates(model: nn.Module):
    """Inside the block, training-mode forwards of ``model`` leave the
    BatchNorm running statistics and the spectral-norm ``u``/``sigma``
    (of :class:`SNConv` and :class:`SNDense`) untouched (the JAX package
    applies a model and discards the updated ``batch_stats``)."""
    layers = [m for m in model.modules() if isinstance(m, (_SpectralNorm, TorchBatchNorm))]
    saved = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield model
    finally:
        for m, s in zip(layers, saved):
            m.update_stats = s
