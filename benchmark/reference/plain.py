"""Plain PyTorch pieces the references share: layers with the stored
state EAD-GAN's models carry (spectral norm's ``u``/``sigma``, BatchNorm's
running statistics), the bilinear warp, the affine code algebra and the
losses.  Float32, TF32 off, no kernel of the program and nothing it made.

Semantics followed (each as the port documents it, from the JAX package,
which follows the published PyTorch scripts):

- spectral norm: one power step a forward from the stored ``u``:
  ``v = l2n(u W)``, ``u = l2n(W v)``, ``sigma = (W v) . u``, the weight
  divided by ``sigma``; ``u`` and ``sigma`` stored in training mode;
- BatchNorm: batch mean and biased batch variance in training mode, the
  running values moved by ``0.9 * old + 0.1 * batch``, eps 1e-5;
- the warp: ``F.affine_grid`` + ``F.grid_sample`` with
  ``align_corners=False``;
- BCE on probabilities clipped into [eps, 1 - eps] (eps float32's);
  cross entropy of a log-softmax taken over the softmax the head gives,
  as the published scripts feed softmax outputs to ``CrossEntropyLoss``.

``quant`` on a layer computes it in a lower precision, for the control.
``"fp8"`` is the fp8 counterpart of the program's bf16 compute: the
layer's input, its weight and its output (a BatchNorm's output too) are
rounded to float8 e4m3 under a per-tensor scale (amax to 448), and the
gradients flowing back through each of them to float8 e5m2 (amax to
57,344).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

_SN_EPS = 1e-12
_BCE_EPS = 1.1920929e-07


def no_tf32() -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fake_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale (amax to the
    format's largest value), back in float32."""
    scale = x.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX[dtype]
    return (x / scale).to(dtype).to(torch.float32) * scale


class _RoundFp8(torch.autograd.Function):
    """A tensor computed in fp8: e4m3 forward, its gradient e5m2 backward
    (the usual fp8 training recipe), each under a per-tensor scale."""

    @staticmethod
    def forward(ctx, x):
        return fake_fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, grad):
        return fake_fp8(grad, torch.float8_e5m2)


def round_output(y: torch.Tensor, quant) -> torch.Tensor:
    """A layer's output kept in the control's type (fp8: rounded, and its
    gradient rounded on the way back); the identity otherwise."""
    return _RoundFp8.apply(y) if quant == "fp8" else y


def lower(x: torch.Tensor, w: torch.Tensor, quant):
    """The product's operands rounded for ``quant`` (None: as they are)."""
    if quant is None:
        return x, w
    if quant == "fp8":
        return _RoundFp8.apply(x), _RoundFp8.apply(w)
    raise ValueError(f"unknown quant {quant!r}")


def torch_default_bound(fan_in: int) -> float:
    """torch's default init bound of a conv or linear weight and bias."""
    return 1.0 / math.sqrt(fan_in)


class Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        x, w = lower(x, self.weight, self.quant)
        return round_output(F.conv2d(x, w, self.bias, self.stride, self.padding), self.quant)

    def init_bound(self) -> float:
        return torch_default_bound(self.weight.shape[1] * self.weight[0, 0].numel())


class ConvT(nn.ConvTranspose2d):
    quant = None

    def forward(self, x):
        x, w = lower(x, self.weight, self.quant)
        return round_output(F.conv_transpose2d(x, w, self.bias, self.stride, self.padding), self.quant)

    def init_bound(self) -> float:
        # torch takes the fan-in of a transposed conv's weight from its dim 1
        return torch_default_bound(self.weight.shape[1] * self.weight[0, 0].numel())


class Dense(nn.Linear):
    quant = None

    def forward(self, x):
        x, w = lower(x, self.weight, self.quant)
        return round_output(F.linear(x, w, self.bias), self.quant)

    def init_bound(self) -> float:
        return torch_default_bound(self.weight.shape[1])


def _l2n(x):
    return x / torch.sqrt((x * x).sum() + _SN_EPS)


class _SN:
    def _sn_state(self, out: int) -> None:
        self.register_buffer("u", torch.zeros(out))
        self.register_buffer("sigma", torch.ones(()))

    def sn_weight(self):
        w = self.weight
        w_mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2n(self.u @ w_mat)
            u = _l2n(w_mat @ v)
        sigma = torch.dot(w_mat @ v, u)
        if self.training:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        return w / sigma


class SNConv(_SN, Conv):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._sn_state(self.out_channels)

    def forward(self, x):
        x, w = lower(x, self.sn_weight(), self.quant)
        return round_output(F.conv2d(x, w, self.bias, self.stride, self.padding), self.quant)


class SNDense(_SN, Dense):
    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._sn_state(self.out_features)

    def forward(self, x):
        x, w = lower(x, self.sn_weight(), self.quant)
        return round_output(F.linear(x, w, self.bias), self.quant)


class BatchNorm(nn.Module):
    quant = None

    def __init__(self, n: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
        with torch.no_grad():
            self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
            self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
            self.num_batches_tracked.add_(1)
        y = (x - mean[None, :, None, None]) / torch.sqrt(var[None, :, None, None] + self.eps)
        return round_output(y * self.weight[None, :, None, None] + self.bias[None, :, None, None],
                            self.quant)


def init_spec(model: nn.Module, prefix: str = ""):
    """``[(state_dict key, shape, kind, bound)]`` of ``model`` at torch's
    default init: ``uniform`` weights and biases within ``bound``,
    ``normal`` spectral-norm ``u``, and ``ones`` / ``zeros`` / ``count``
    for the rest."""
    spec = []
    for mname, m in model.named_modules():
        p = f"{prefix}{mname}." if mname else prefix
        if isinstance(m, (Conv, ConvT, Dense)):
            b = m.init_bound()
            spec.append((p + "weight", tuple(m.weight.shape), "uniform", b))
            spec.append((p + "bias", tuple(m.bias.shape), "uniform", b))
            if isinstance(m, _SN):
                spec.append((p + "u", tuple(m.u.shape), "normal", 1.0))
                spec.append((p + "sigma", (), "ones", 0.0))
        elif isinstance(m, BatchNorm):
            n = m.weight.shape
            spec += [(p + "weight", tuple(n), "ones", 0.0), (p + "bias", tuple(n), "zeros", 0.0),
                     (p + "running_mean", tuple(n), "zeros", 0.0),
                     (p + "running_var", tuple(n), "ones", 0.0),
                     (p + "num_batches_tracked", (), "count", 0.0)]
    return spec


def set_quant(model: nn.Module, quant) -> None:
    for m in model.modules():
        if isinstance(m, (Conv, ConvT, Dense, BatchNorm)):
            m.quant = quant


# --- the warp and the affine code algebra ------------------------------------

def warp(img_nhwc: torch.Tensor, matrix: torch.Tensor, padding_mode: str = "border") -> torch.Tensor:
    """Bilinear warp of an NHWC float32 batch by (N, 3, 3) matrices."""
    x = img_nhwc.permute(0, 3, 1, 2)
    grid = F.affine_grid(matrix[:, :2, :], list(x.shape), align_corners=False)
    out = F.grid_sample(x, grid, mode="bilinear", padding_mode=padding_mode, align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


def _mat(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_zoom_shift(theta, p, q, x, y):
    """R(theta) @ Z(p, q) @ T(x, y), (B, 3, 3)."""
    zero, one = torch.zeros_like(p), torch.ones_like(p)
    c, s = torch.cos(theta), torch.sin(theta)
    r = _mat([(c, -s, zero), (s, c, zero), (zero, zero, one)])
    z = _mat([(p, zero, zero), (zero, q, zero), (zero, zero, one)])
    t = _mat([(one, zero, x), (zero, one, y), (zero, zero, one)])
    return r @ z @ t


def inverse(m):
    """Inverse of affine (B, 3, 3) matrices (last row 0, 0, 1)."""
    a, b, c, d = m[:, 0, 0], m[:, 0, 1], m[:, 1, 0], m[:, 1, 1]
    tx, ty = m[:, 0, 2], m[:, 1, 2]
    det = safe_div(torch.ones_like(a), a * d - b * c)
    ia, ib, ic, id_ = d * det, -b * det, -c * det, a * det
    zero, one = torch.zeros_like(a), torch.ones_like(a)
    return _mat([(ia, ib, -(ia * tx + ib * ty)), (ic, id_, -(ic * tx + id_ * ty)), (zero, zero, one)])


def safe_div(a, b, eps: float = 1e-6):
    """a / b with |b| < eps taken as +-eps (+eps at 0)."""
    guarded = torch.where(b.abs() < eps, torch.where(b < 0, -torch.full_like(b, eps),
                                                     torch.full_like(b, eps)), b)
    return a / guarded


# --- losses --------------------------------------------------------------------

def bce(p, target):
    p = p.clamp(_BCE_EPS, 1.0 - _BCE_EPS)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def cross_entropy(x, labels):
    return F.nll_loss(F.log_softmax(x, dim=-1), labels)


def mse(a, b):
    return torch.mean((a - b) ** 2)


def mutual_info(c_given_x, c, eps: float = 1e-8):
    return (torch.mean(-torch.sum(torch.log(c_given_x + eps) * c, dim=-1))
            + torch.mean(-torch.sum(torch.log(c + eps) * c, dim=-1)))


def adam(params, lr: float, b1: float, b2: float):
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=1e-8)
