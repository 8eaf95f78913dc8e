"""The spectral norm of a weight, forward and backward: the CUDA kernels
(``csrc/spectral_norm.cu``), their wrapper and their plain version.

flax's ``SpectralNorm`` as ``models/layers.py::SNConv`` and ``SNDense``
take it on an unsharded weight: one power step from the stored ``u``,
``v = l2n(u W)``, ``u' = l2n(W v)``, ``sigma = (W v) . u'``, then the
weight divided by ``sigma`` (by 1 where it is 0) and cast to the layer's
compute type; ``u'`` and ``sigma`` are stored only when the call
updates the layer's state.  It replaces no Pallas kernel: the JAX
package leaves flax's ``SpectralNorm`` to XLA's fusion.  In the port it
replaces ~22 torch kernels a forward and ~13 a backward.  Bound: bytes,
6 an element forward (W read, bf16 written) and 10 backward (G and W
read, dW written); CelebA's discriminator holds 11.02 M elements.

:func:`spectral_norm` is the layers' one entry: on a CPU tensor it takes
the plain version, :func:`spectral_norm_plain` (the expression the
layers held before the kernel, unchanged, so the CPU reads what it
read); on a CUDA tensor it launches the kernels through an autograd
function, or raises, never falling back.  A weight of at most
:data:`ONE_BLOCK_MAX` elements takes one launch forward and one
backward; a larger one three forward and two backward.  The kernels
allocate nothing: the wrapper allocates the output, ``v``, ``u'``,
``sigma`` and the scratch with ``torch.empty``, so a CUDA graph captures
the launches with their memory.  :func:`spectral_norm_grad_plain` is the
backward's closed form in torch, which the tests hold against autograd.

``launch_count`` counts kernel launches, so a run can show that its main
path went through the kernels.  A call made while the stream is being
captured into a CUDA graph records the kernels and launches nothing: it
adds to ``captured_count`` instead, and whoever replays the graph counts
the launches of each replay with :func:`count_replayed`.  With tracing
on (``utils/trace.py``) both also add to the ``sn.launches`` counter.
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.ops import _build
from eadgan_tpu_torch.utils import trace

__all__ = ["spectral_norm", "spectral_norm_plain", "spectral_norm_grad_plain", "l2n", "SN_EPS",
           "ONE_BLOCK_MAX", "MAX_PARTIALS", "launches_per_call", "launch_count", "captured_count",
           "reset_launch_count", "count_replayed"]

SN_EPS = 1e-12  # csrc/spectral_norm.cu: kEps
# weights of at most this many elements take one block and one launch each
# way: above it the large path (three launches forward, two backward) is faster
# (a forward and a backward: 9.70 against 10.32 µs at 8,192 elements, 12.00
# against 10.25 at 16,384; tools/sn_bench.py's sweep, NVIDIA H100 80GB HBM3)
ONE_BLOCK_MAX = 8192
MAX_PARTIALS = 1024  # blocks of an elementwise pass (csrc/spectral_norm.cu: kMaxBlocks)

launch_count = 0
captured_count = 0


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + SN_EPS)


def spectral_norm_plain(weight: torch.Tensor, u: torch.Tensor, sigma: torch.Tensor, dtype=None,
                        update: bool = False) -> torch.Tensor:
    """``weight`` divided by the sigma of one power step from ``u``, in
    ``dtype`` (None: float32); with ``update``, the new ``u`` and sigma
    stored into ``u`` and ``sigma``.  Gradients reach ``weight`` through
    the division and through sigma, ``u`` and ``v`` held constant."""
    w_mat = weight.reshape(weight.shape[0], -1)  # (out, K)
    with torch.no_grad():
        v = l2n(u @ w_mat)  # (K,)
        u_new = l2n(w_mat @ v)  # (out,)
    sig = torch.dot(w_mat @ v, u_new)
    if update:
        with torch.no_grad():
            u.copy_(u_new)
            sigma.copy_(sig)
    out = weight / torch.where(sig != 0, sig, torch.ones_like(sig))
    return out if dtype is None else out.to(dtype)


def spectral_norm_grad_plain(grad: torch.Tensor, weight: torch.Tensor, u_new: torch.Tensor,
                             v: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The backward's closed form, as the kernels compute it: the gradient
    of ``weight`` from ``grad`` (of the normalized weight) and the
    forward's ``u'``, ``v`` and sigma, ``grad / s + (c u') v^T`` with
    ``c = -(sum(grad * weight) / s) / s``, and ``grad`` where sigma is 0."""
    g = grad.to(weight.dtype)
    nonzero = sigma != 0
    s = torch.where(nonzero, sigma, torch.ones_like(sigma))
    c = torch.where(nonzero, -((g * weight).sum() / s) / s, torch.zeros_like(sigma))
    return g / s + torch.outer(c * u_new, v).view(weight.shape)


def launches_per_call(numel: int, single=None) -> tuple:
    """(forward, backward) kernel launches of a call on a weight of
    ``numel`` elements (``single``: the path, None to choose it by size)."""
    return (1, 1) if (numel <= ONE_BLOCK_MAX if single is None else single) else (3, 2)


def reset_launch_count() -> None:
    global launch_count
    launch_count = 0


def count_replayed(launches: int) -> None:
    """Count ``launches`` kernel launches made by replaying CUDA graphs."""
    global launch_count
    launch_count += launches
    trace.count("sn.launches", launches)


def _counted(launches: int) -> None:
    global launch_count, captured_count
    if torch.cuda.is_current_stream_capturing():
        captured_count += launches
    else:
        launch_count += launches
        trace.count("sn.launches", launches)


def _aligned_empty(sizes, device) -> list:
    """Float32 vectors of ``sizes`` cut from one allocation, each at a
    16-byte boundary (the kernels' vector loads)."""
    padded = [-(-n // 4) * 4 for n in sizes]
    buf = torch.empty(sum(padded), dtype=torch.float32, device=device)
    out, at = [], 0
    for n, p in zip(sizes, padded):
        out.append(buf[at:at + n])
        at += p
    return out


def _forward(weight, u, sigma, dtype, update: bool, single=None):
    """The forward's launches; ``single`` takes the one-block path (True)
    or the large one (False), None chooses by size."""
    rows = weight.shape[0]
    cols = weight.numel() // rows
    single = weight.numel() <= ONE_BLOCK_MAX if single is None else single
    out = torch.empty(weight.shape, dtype=dtype or torch.float32, device=weight.device)
    v, u_new, sig, x, wv = _aligned_empty((cols, rows, 1, 0 if single else cols,
                                           0 if single else rows), weight.device)
    lib = _build.load_library()
    with torch.cuda.device(weight.device):
        err = lib.eadgan_sn_forward(
            weight.data_ptr(), u.data_ptr(), sigma.data_ptr(), out.data_ptr(),
            int(out.dtype == torch.bfloat16), v.data_ptr(), u_new.data_ptr(), sig.data_ptr(),
            x.data_ptr(), wv.data_ptr(), rows, cols, int(update), int(single),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"spectral norm forward launch failed: CUDA error {err}")
        _counted(launches_per_call(weight.numel(), single)[0])
    return out, v, u_new, sig


def _backward(grad, weight, u_new, v, sig, single=None):
    """The backward's launches; ``single`` as :func:`_forward`'s."""
    if grad.dtype not in (torch.float32, torch.bfloat16) or grad.shape != weight.shape:
        raise ValueError(f"spectral norm backward: a {grad.dtype} gradient of shape "
                         f"{tuple(grad.shape)} for a weight of shape {tuple(weight.shape)}")
    grad = grad.contiguous()
    rows = weight.shape[0]
    single = weight.numel() <= ONE_BLOCK_MAX if single is None else single
    dw = torch.empty_like(weight)
    partials = torch.empty(0 if single else MAX_PARTIALS, dtype=torch.float32,
                           device=weight.device)
    lib = _build.load_library()
    with torch.cuda.device(weight.device):
        err = lib.eadgan_sn_backward(
            grad.data_ptr(), int(grad.dtype == torch.bfloat16), weight.data_ptr(), u_new.data_ptr(),
            v.data_ptr(), sig.data_ptr(), partials.data_ptr(), dw.data_ptr(), rows,
            weight.numel() // rows, int(single), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"spectral norm backward launch failed: CUDA error {err}")
        _counted(launches_per_call(weight.numel(), single)[1])
    return dw


class _SpectralNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weight, u, sigma, dtype, update):
        out, v, u_new, sig = _forward(weight, u, sigma, dtype, update)
        ctx.save_for_backward(weight, u_new, v, sig)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        return _backward(grad, *ctx.saved_tensors), None, None, None, None


def _check(weight, u, sigma, dtype) -> None:
    if weight.device.type != "cuda":
        raise ValueError(f"the spectral norm's kernels need a CUDA tensor, got one on {weight.device}")
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise TypeError(f"the spectral norm writes float32 or bfloat16, not {dtype}")
    if weight.dtype != torch.float32 or weight.dim() < 2 or not weight.is_contiguous():
        raise ValueError(f"the spectral norm takes a contiguous float32 weight of two or more "
                         f"dimensions, got {weight.dtype} {tuple(weight.shape)}")
    if not 0 < weight.numel() < 2**31:
        raise ValueError(f"the spectral norm's kernels take 1 to 2**31 - 1 elements, "
                         f"got {weight.numel()}")
    for name, t, n in (("u", u, weight.shape[0]), ("sigma", sigma, 1)):
        if t.device != weight.device or t.dtype != torch.float32 or t.numel() != n \
                or not t.is_contiguous():
            raise ValueError(f"the spectral norm's {name} must be {n} contiguous float32 elements "
                             f"on {weight.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def spectral_norm(weight: torch.Tensor, u: torch.Tensor, sigma: torch.Tensor, dtype=None,
                  update: bool = False) -> torch.Tensor:
    """``weight`` (out features first) divided by the sigma of one power
    step from ``u``, in ``dtype`` (None: float32), differentiable in
    ``weight``; with ``update``, the new ``u`` and sigma stored into ``u``
    (out,) and ``sigma`` (0-d).  The plain version on the CPU, the kernels
    on the card."""
    if weight.device.type == "cpu":
        return spectral_norm_plain(weight, u, sigma, dtype, update)
    _check(weight, u, sigma, dtype)
    return _SpectralNorm.apply(weight, u, sigma, dtype, update)
