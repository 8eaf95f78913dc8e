"""One Adam step over an optimizer's tensors: the CUDA kernel
(``csrc/adam_fused.cu``), its wrapper and its plain version.

Replaces torch's foreach capturable Adam, which the train steps ran
before (``torch.optim.Adam(capturable=True)``: about seven passes over
the moments and parameters, and a broadcasting kernel per tensor for
each division by a 0-d tensor).  It replaces no Pallas kernel: the JAX
package leaves Adam to XLA's fusion of optax's update.  Bound: bytes,
28 an element (p, g, m and v read once, p, m and v written once);
CelebA's three optimizers update 51.84 M elements a step, 0.433 ms at
3.35 TB/s.

:func:`adam_cuda` launches the kernel once, on PyTorch's current stream.
It checks what the kernel takes (at most :data:`MAX_TENSORS` contiguous
float32 tensors of matching shapes and 0-d float32 step counts, all on
one card, and an int32 counter there; the trainers' optimizers hold 10
to 34 tensors) and raises on anything else; it never falls back to the plain
version.  The tensors'
pointers and sizes travel by value in the launch's arguments, so a
CUDA graph that captures the launch holds them; the step counts stay on
the card, advanced there by the same launch, so a replay advances them
and the bias corrections with them.  :func:`adam_plain` is the same
arithmetic in PyTorch, tensor by tensor, which ``train/state.py::
FusedAdam`` takes for CPU tensors only.

``launch_count`` counts kernel launches, so a run can show that its main
path went through the kernel.  A call made while the stream is being
captured into a CUDA graph records the kernel and launches nothing: it
adds to ``captured_count`` instead, and whoever replays the graph counts
the launches of each replay with :func:`count_replayed`.  With tracing
on (``utils/trace.py``) both also add to the ``adam.launches`` counter.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.utils import trace

__all__ = ["adam_cuda", "adam_plain", "launch_count", "captured_count", "reset_launch_count",
           "count_replayed", "MAX_TENSORS", "CHUNK", "BYTES_PER_ELEMENT"]

MAX_TENSORS = 64  # tensors a launch (csrc/adam_fused.cu: kMaxTensors)
CHUNK = 4096  # elements a block (csrc/adam_fused.cu: kChunk)
BYTES_PER_ELEMENT = 28  # p, g, m, v read; p, m, v written; float32

launch_count = 0
captured_count = 0


class _Tensor(ctypes.Structure):
    _fields_ = [("param", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("exp_avg", ctypes.c_void_p), ("exp_avg_sq", ctypes.c_void_p),
                ("step", ctypes.c_void_p), ("numel", ctypes.c_longlong)]


class _Launch(ctypes.Structure):
    """``AdamLaunch`` of ``csrc/adam_fused.cu``, field for field."""

    _fields_ = [("tensors", _Tensor * MAX_TENSORS), ("first_chunk", ctypes.c_int * (MAX_TENSORS + 1)),
                ("count", ctypes.c_int), ("done", ctypes.c_void_p), ("lr", ctypes.c_double),
                ("beta1", ctypes.c_double), ("beta2", ctypes.c_double), ("eps", ctypes.c_float)]


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def count_replayed(launches: int) -> None:
    """Count ``launches`` kernel launches made by replaying CUDA graphs."""
    global launch_count
    launch_count += launches
    trace.count("adam.launches", launches)


@torch.no_grad()
def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
               steps: Sequence[torch.Tensor], lr: float, beta1: float, beta2: float,
               eps: float) -> None:
    """The kernel's arithmetic in PyTorch, in place: each step count
    advanced, the bias corrections computed from it in float64 and
    rounded to float32 once, then the moments and the parameter updated
    in float32 in the kernel's order."""
    for p, g, m, v, step in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        step += 1
        t = step.double()
        step_size = (lr / (1 - beta1 ** t)).float()
        bc2_sqrt = (1 - beta2 ** t).sqrt().float()
        m.mul_(beta1).add_(g, alpha=1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        p.sub_(m * step_size / (v.sqrt() / bc2_sqrt + eps))


def _check(params, grads, exp_avgs, exp_avg_sqs, steps, done) -> torch.device:
    n = len(params)
    if not n or any(len(x) != n for x in (grads, exp_avgs, exp_avg_sqs, steps)):
        raise ValueError("adam_cuda takes one grad, exp_avg, exp_avg_sq and step a parameter")
    if n > MAX_TENSORS:
        raise ValueError(f"adam_cuda takes at most {MAX_TENSORS} tensors a launch, got {n}")
    device = params[0].device
    if device.type != "cuda":
        raise ValueError(f"adam_cuda needs CUDA tensors, got one on {device}")
    for i, (p, g, m, v, s) in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs, steps)):
        for name, t in (("param", p), ("grad", g), ("exp_avg", m), ("exp_avg_sq", v), ("step", s)):
            if t.device != device:
                raise ValueError(f"adam_cuda: tensor {i}'s {name} is on {t.device}, not {device}")
            if t.dtype != torch.float32:
                raise TypeError(f"adam_cuda takes float32 tensors, tensor {i}'s {name} is {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"adam_cuda needs contiguous tensors, tensor {i}'s {name} is not")
        if not g.shape == m.shape == v.shape == p.shape:
            raise ValueError(f"adam_cuda: tensor {i}'s grad and moments do not match its shape "
                             f"{tuple(p.shape)}")
        if s.numel() != 1:
            raise ValueError(f"adam_cuda: tensor {i}'s step count has {s.numel()} elements, not 1")
    if done.device != device or done.dtype != torch.int32 or done.numel() < 1:
        raise ValueError("adam_cuda needs an int32 counter on the parameters' card")
    return device


def adam_cuda(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              exp_avgs: Sequence[torch.Tensor], exp_avg_sqs: Sequence[torch.Tensor],
              steps: Sequence[torch.Tensor], lr: float, beta1: float, beta2: float, eps: float,
              done: torch.Tensor) -> None:
    """One Adam step over the tensors, in place, by one launch of the
    kernel.  ``done`` is the kernel's counter, an int32 tensor on the same
    card, zero before the first launch (the kernel leaves it so); launches
    on one stream may share it."""
    global launch_count, captured_count
    device = _check(params, grads, exp_avgs, exp_avg_sqs, steps, done)
    lib = _build.load_library()
    if lib.eadgan_adam_launch_bytes() != ctypes.sizeof(_Launch):
        raise RuntimeError("ops/adam_cuda.py's _Launch does not match csrc/adam_fused.cu's AdamLaunch")
    n = len(params)
    args = _Launch(count=n, done=done.data_ptr(), lr=lr, beta1=beta1, beta2=beta2, eps=eps)
    chunks = 0
    for i, tensors in enumerate(zip(params, grads, exp_avgs, exp_avg_sqs, steps)):
        args.tensors[i] = _Tensor(*(t.data_ptr() for t in tensors), params[i].numel())
        args.first_chunk[i] = chunks
        chunks += -(-params[i].numel() // CHUNK)
    if chunks >= 2**31:
        raise ValueError(f"adam_cuda: {chunks} chunks exceed the kernel's grid")
    args.first_chunk[n] = chunks
    with torch.cuda.device(device):
        err = lib.eadgan_adam_fused(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"adam kernel launch failed: CUDA error {err}")
    if capturing:
        captured_count += 1
    else:
        launch_count += 1
        trace.count("adam.launches")
