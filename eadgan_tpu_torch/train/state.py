"""Train-state containers and the optimizer factory.

PyTorch counterpart of ``eadgan_tpu/train/state.py``.  A state is a plain
object holding the models, Adam optimizers (:class:`FusedAdam`) over
overlapping parameter sets, the step count and a ``torch.Generator`` in
place of the JAX ``rng``.  An info optimizer runs over two models (G and
D for CelebA, G and E for dSprites and MNIST) with moments of its own, as
two torch optimizers over the same tensors do.  The step functions update
a state in place; ``train/checkpoint.py`` saves whatever fields it holds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from eadgan_tpu_torch.ops import adam_cuda

__all__ = ["adam", "FusedAdam", "GanTrainState", "EncoderTrainState"]


class FusedAdam(torch.optim.Adam):
    """``torch.optim.Adam`` whose ``step()`` is one hand-written kernel
    launch over all of a group's tensors on the card
    (``ops/adam_cuda.py``, ``csrc/adam_fused.cu``), and that kernel's
    plain version, tensor by tensor, on the CPU.

    Same update as torch's Adam without weight decay, in float32; a
    parameter whose grad is None is skipped.  The state keeps torch's
    layout (``step``, ``exp_avg``, ``exp_avg_sq``), so ``state_dict``,
    the checkpoints, the JAX interop and ``parallel/zero.py`` see a
    ``torch.optim.Adam``, and torch's global step hooks bracket the step.
    On the card the step counts live there (the group must be
    ``capturable``), the kernel advances them, and nothing is read back
    to the host, so a captured step replays.  What the kernel does not
    take (weight decay, AMSGrad, ``maximize``, tensor rates, tensors that
    are not contiguous float32) raises; nothing falls back to torch's
    Adam."""

    def _check_group(self, group: dict, on_card: bool) -> None:
        unsupported = [k for k in ("amsgrad", "maximize", "differentiable", "fused",
                                   "decoupled_weight_decay") if group.get(k)]
        if group.get("weight_decay"):
            unsupported.append("weight_decay")
        if any(torch.is_tensor(x) for x in (group["lr"], *group["betas"])):
            unsupported.append("tensor lr or betas")
        if unsupported:
            raise ValueError(f"FusedAdam does not take {', '.join(unsupported)}")
        if on_card and not group["capturable"]:
            raise ValueError("FusedAdam on the card keeps its step counts there: build it with "
                             "capturable=True, as train.state.adam does")

    def _counter(self, device: torch.device) -> torch.Tensor:
        """The kernel's block counter on ``device``: made zero at the first
        step there, and left zero by every launch."""
        done = self.__dict__.get("_done")
        if done is None or done.device != device:
            done = self._done = torch.zeros(1, dtype=torch.int32, device=device)
        return done

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("FusedAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            on_card = params[0].is_cuda
            self._check_group(group, on_card)
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                    state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                    state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            states = [self.state[p] for p in params]
            tensors = ([p.grad for p in params], [s["exp_avg"] for s in states],
                       [s["exp_avg_sq"] for s in states], [s["step"] for s in states])
            b1, b2 = group["betas"]
            if on_card:
                adam_cuda.adam_cuda(params, *tensors, group["lr"], b1, b2, group["eps"],
                                    self._counter(params[0].device))
            elif any(t.is_cuda for ts in (params, *tensors) for t in ts):
                raise ValueError("FusedAdam: a group's tensors lie on the CPU and on the card")
            else:
                adam_cuda.adam_plain(params, *tensors, group["lr"], b1, b2, group["eps"])
        return None


def adam(params, lr: float, b1: float = 0.5, b2: float = 0.999) -> FusedAdam:
    """:class:`FusedAdam` with the reference betas and eps 1e-8, over
    ``params`` (tensors on one device).  On the card it is
    ``capturable``: the step counts stay on the card, which CUDA-graph
    replay of a step needs (a host count would move once, at capture),
    and both engines, per-step and chained, run the same Adam, so a
    train state moves between them unchanged."""
    params = list(params)
    on_card = any(p.is_cuda for p in params)
    return FusedAdam(params, lr=lr, betas=(b1, b2), eps=1e-8, capturable=on_card)


@dataclasses.dataclass
class GanTrainState:
    """Adversarial-pipeline state.  ``e`` is the separate encoder
    (dSprites, MNIST), ``pxy`` the frozen alignment encoder (dSprites)
    and ``approx`` the frozen affine approximator (MNIST); ``opt_g`` is
    None for dSprites, whose G update lives in ``opt_info``."""

    g: nn.Module
    d: nn.Module
    opt_g: Optional[torch.optim.Optimizer]
    opt_d: torch.optim.Optimizer
    opt_info: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
    e: Optional[nn.Module] = None
    pxy: Optional[nn.Module] = None
    approx: Optional[nn.Module] = None


@dataclasses.dataclass
class EncoderTrainState:
    """Single-model pretraining state (the pxy alignment encoders, the
    affine approximator)."""

    model: nn.Module
    opt: torch.optim.Optimizer
    rng: torch.Generator
    step: int = 0
