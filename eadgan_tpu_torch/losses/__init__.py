"""Objectives: adversarial, info and consistency losses.

PyTorch counterpart of ``eadgan_tpu/losses``.  The values match the JAX
package, not torch's own loss modules where the two differ:

* :func:`bce_loss` clips probabilities into [f32 eps, 1 - eps] before
  the logs.  ``nn.BCELoss`` clamps the *log* at -100 instead, which
  gives other values once a sigmoid saturates.
* :func:`torch_cross_entropy` applies log_softmax to whatever the model
  head emits, so the reference's double-softmax quirk (softmax outputs
  fed to ``CrossEntropyLoss``) is kept.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mse_loss", "bce_loss", "torch_cross_entropy", "mutual_info_loss"]

_BCE_EPS = 1.1920929e-07  # f32 machine epsilon


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error (mean reduction)."""
    return torch.mean((pred - target) ** 2)


def bce_loss(pred_prob: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities, clipped into [eps, 1-eps]:
    finite values and gradients (bounded by 1/eps) even where a sigmoid
    saturates to exactly 0 or 1."""
    p = pred_prob.clamp(_BCE_EPS, 1.0 - _BCE_EPS)
    return -torch.mean(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))


def torch_cross_entropy(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log_softmax over ``x`` then the mean NLL of integer ``labels``.
    ``x`` may be logits or already-softmaxed probabilities."""
    log_probs = F.log_softmax(x, dim=-1)
    picked = torch.gather(log_probs, -1, labels.long()[:, None])[:, 0]
    return -torch.mean(picked)


def mutual_info_loss(c_given_x: torch.Tensor, c: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Categorical mutual-information surrogate:
    E[-sum(log(c|x + eps) * c)] + E[-sum(log(c + eps) * c)]."""
    conditional_entropy = torch.mean(-torch.sum(torch.log(c_given_x + eps) * c, dim=-1))
    entropy = torch.mean(-torch.sum(torch.log(c + eps) * c, dim=-1))
    return conditional_entropy + entropy
