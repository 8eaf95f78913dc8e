"""MNIST adversarial train step (LSGAN + neural affine regularizer).

PyTorch counterpart of ``eadgan_tpu/train/gan_mnist.py``, with the same
phase order:

1. G phase against the pre-update D (D takes no gradient here, but its
   spectral-norm ``u`` moves): least squares of D's logits on the fakes
   against 1, one step of ``opt_g``;
2. D phase on the real batch warped by the step's rpqmnxy code
   (``border`` padding, one warp) against the G phase's fakes, detached:
   least squares against 1 and 0, one step of ``opt_d``;
3. info phase, one backward through G and E with ``opt_info`` over both:
   G (updated, from the G phase's BatchNorm statistics) re-generates,
   E reads the fakes (categorical cross-entropy on the sampled labels,
   0.1 x code MSE), then the warped and the real batch, and the frozen
   approximator recovers the relative code between those two readings
   (0.1 x MSE against the step's code).

Per step D runs three times (G phase, real, fake) and E three times
(fakes, warped, real), each forward advancing the spectral-norm ``u``
and BatchNorm statistics in the JAX step's order; G runs twice.  The
approximator takes no gradient and has no optimizer: its parameters do
not require one, and gradients flow through it to E's codes only.  The
dataset labels feed nothing (the losses use freshly sampled labels, as
in the reference).  The step updates the state in place and returns it,
with the metrics as 0-d device tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eadgan_tpu_torch.losses import mse_loss, torch_cross_entropy
from eadgan_tpu_torch.models import MnistDiscriminator, MnistEncoder, MnistGenerator
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel.mesh import global_batch, local_rows
from eadgan_tpu_torch.train.config import MnistConfig
from eadgan_tpu_torch.train.state import GanTrainState, adam
from eadgan_tpu_torch.transforms import RPQMNXY, code_to_matrix, regularize_neural
from eadgan_tpu_torch.utils.device import resolve_device

__all__ = ["init_mnist_gan_state", "make_mnist_gan_step", "METRIC_KEYS"]

METRIC_KEYS = ("d_loss", "g_loss", "info_loss")


def init_mnist_gan_state(
    config: MnistConfig, approximator, device=None, seed: int = 0, dtype=None
) -> GanTrainState:
    """Fresh G, D and E (the reference's ``weights_init_normal``, drawn
    from ``seed`` without touching the global generator) and their three
    Adams on ``device`` (the CUDA card when None), with ``approximator``,
    the stage-1 MLP, frozen beside them.  ``dtype`` is the compute type
    of G, D and E (None: float32; ``torch.bfloat16``); the approximator
    stays float32.  ``opt_info`` steps G and E together."""
    device = resolve_device(device)
    kw = dict(img_size=config.img_size, channels=config.channels, dtype=dtype)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = MnistGenerator(config.latent_dim, config.n_classes, config.code_dim, **kw)
        d = MnistDiscriminator(**kw)
        e = MnistEncoder(config.latent_dim, config.n_classes, config.code_dim, **kw)
    for m in (g, d, e):
        m.to(device).train()
    approximator.to(device).eval().requires_grad_(False)
    return GanTrainState(
        g=g,
        d=d,
        e=e,
        approx=approximator,
        opt_g=adam(g.parameters(), config.lr, config.b1, config.b2),
        opt_d=adam(d.parameters(), config.d_lr, config.b1, config.b2),
        opt_info=adam([*g.parameters(), *e.parameters()], config.lr, config.b1, config.b2),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def make_mnist_gan_step(config: MnistConfig):
    def step(state: GanTrainState, real_imgs: torch.Tensor, labels=None, fixed=None):
        """``real_imgs``: contiguous (B, 32, 32, 1) NHWC in [-1, 1];
        ``labels`` (the dataset's) are unused.  ``fixed`` (parity tests)
        injects the draws: {"z", "sampled_labels", "code"}, at the global
        batch in a data-parallel step (``parallel.local_rows``)."""
        del labels
        g, d, e = state.g, state.d, state.e
        dev = real_imgs.device
        batch = real_imgs.shape[0]
        if fixed is not None:
            z = torch.as_tensor(fixed["z"], dtype=torch.float32, device=dev)
            sampled_labels = torch.as_tensor(fixed["sampled_labels"], dtype=torch.long, device=dev)
            code = torch.as_tensor(fixed["code"], dtype=torch.float32, device=dev)
        else:
            n = global_batch(batch)
            z = torch.randn(n, config.latent_dim, generator=state.rng, device=dev)
            sampled_labels = torch.randint(0, config.n_classes, (n,), generator=state.rng, device=dev)
            code = torch.rand(n, config.code_dim, generator=state.rng, device=dev) * 2.0 - 1.0
        z, sampled_labels, code = (local_rows(t, batch) for t in (z, sampled_labels, code))
        label_input = F.one_hot(sampled_labels, config.n_classes).to(torch.float32)

        scaled_img = warp_affine(real_imgs, code_to_matrix(RPQMNXY, code), padding_mode="border")
        # channels_last NCHW views of the NHWC batches, no copy
        real_nchw = real_imgs.permute(0, 3, 1, 2)
        scaled_nchw = scaled_img.permute(0, 3, 1, 2)

        # --- G phase (D's weights take no gradient here) -------------------
        d.requires_grad_(False)
        gen_imgs = g(z, label_input, code)
        validity = d(gen_imgs)
        g_loss = mse_loss(validity, torch.ones_like(validity))
        state.opt_g.zero_grad(set_to_none=True)
        g_loss.backward()
        d.requires_grad_(True)
        state.opt_g.step()

        # --- D phase (the G phase's fakes, detached) -----------------------
        real_pred = d(scaled_nchw)
        fake_pred = d(gen_imgs.detach())
        d_loss = (
            mse_loss(real_pred, torch.ones_like(real_pred))
            + mse_loss(fake_pred, torch.zeros_like(fake_pred))
        ) / 2.0
        state.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        state.opt_d.step()

        # --- info phase (updated G and E; frozen approximator) -------------
        gen = g(z, label_input, code)
        pred_label, pred_code, _ = e(gen)
        info_1 = config.lambda_cat * torch_cross_entropy(
            pred_label, sampled_labels
        ) + config.lambda_con * mse_loss(pred_code, code)
        _, transform_code, _ = e(scaled_nchw)
        _, real_code, _ = e(real_nchw)
        pred_affine = regularize_neural(state.approx, real_code, transform_code)
        info_loss = info_1 + config.lambda_affine * mse_loss(pred_affine, code)
        state.opt_info.zero_grad(set_to_none=True)
        info_loss.backward()
        state.opt_info.step()

        state.step += 1
        losses = (d_loss, g_loss, info_loss)
        return state, {k: v.detach() for k, v in zip(METRIC_KEYS, losses)}

    return step
