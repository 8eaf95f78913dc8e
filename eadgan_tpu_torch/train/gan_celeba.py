"""CelebA adversarial train step (shared-info-head discriminator).

PyTorch counterpart of ``eadgan_tpu/train/gan_celeba.py``, with the same
phase order: the G phase against the pre-update D; the D phase on the
warped reals and the detached G-phase fakes; then the info phase, which
re-generates, reads D three times and steps ``opt_info`` over G *and* D.
Per step D runs six times and G twice, each forward advancing the
spectral-norm ``u`` and the BatchNorm running statistics in that order.

The step updates the state in place (models, optimizers, generator,
step count) and returns it, with the metrics as 0-d device tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eadgan_tpu_torch.losses import bce_loss, mse_loss, torch_cross_entropy
from eadgan_tpu_torch.models import CelebaDiscriminator, CelebaGenerator
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel.mesh import global_batch, local_rows
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.state import GanTrainState, adam
from eadgan_tpu_torch.transforms import RPQXY, code_to_matrix, regularize
from eadgan_tpu_torch.utils.device import resolve_device

__all__ = ["init_celeba_gan_state", "make_celeba_gan_step"]


def init_celeba_gan_state(
    config: CelebaConfig, device=None, seed: int = 0, dtype=None
) -> GanTrainState:
    """Fresh models (torch default init, drawn from ``seed`` without
    touching the global generator) and optimizers on ``device`` (the
    CUDA card when None).  ``dtype`` is the models' compute type (None:
    float32; ``torch.bfloat16``); parameters are float32 either way, and
    the warp runs on the float32 real batch, as in the JAX package."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = CelebaGenerator(
            latent_dim=config.latent_dim, n_classes=config.n_classes,
            code_dim=config.code_dim, channels=config.channels, dtype=dtype,
        )
        d = CelebaDiscriminator(
            n_classes=config.n_classes, code_dim=config.code_dim, channels=config.channels,
            dtype=dtype,
        )
    g.to(device).train()
    d.to(device).train()
    return GanTrainState(
        g=g,
        d=d,
        opt_g=adam(g.parameters(), config.g_lr, config.b1, config.b2),
        opt_d=adam(d.parameters(), config.d_lr, config.b1, config.b2),
        opt_info=adam([*g.parameters(), *d.parameters()], config.info_lr, config.b1, config.b2),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def make_celeba_gan_step(config: CelebaConfig):
    def step(state: GanTrainState, real_imgs: torch.Tensor, fixed=None):
        """``real_imgs``: contiguous (B, 64, 64, 3) NHWC in [-1, 1].
        ``fixed`` (parity tests) injects the random draws:
        {"z", "sampled_labels", "code"}.  In a data-parallel step the
        draws are made (or given) at the global batch and this rank keeps
        its rows (``parallel.local_rows``)."""
        g, d = state.g, state.d
        dev = real_imgs.device
        batch = real_imgs.shape[0]
        if fixed is not None:
            z = torch.as_tensor(fixed["z"], dtype=torch.float32, device=dev)
            sampled_labels = torch.as_tensor(fixed["sampled_labels"], dtype=torch.long, device=dev)
            code = torch.as_tensor(fixed["code"], dtype=torch.float32, device=dev)
        else:
            n = global_batch(batch)
            z = torch.randn(n, config.latent_dim, generator=state.rng, device=dev)
            code = torch.rand(n, config.code_dim, generator=state.rng, device=dev) * 2.0 - 1.0
            sampled_labels = torch.randint(0, config.n_classes, (n,), generator=state.rng, device=dev)
        z, code, sampled_labels = (local_rows(t, batch) for t in (z, code, sampled_labels))
        label_input = F.one_hot(sampled_labels, config.n_classes).to(torch.float32)

        matrix = code_to_matrix(RPQXY, code[:, :5])
        scaled_img = warp_affine(real_imgs, matrix, padding_mode="border")
        # channels_last NCHW views of the NHWC batches, no copy
        real_nchw = real_imgs.permute(0, 3, 1, 2)
        scaled_nchw = scaled_img.permute(0, 3, 1, 2)

        # --- G phase (D's weights take no gradient here) -------------------
        d.requires_grad_(False)
        gen_imgs = g(z, label_input, code)
        _, _, validity = d(gen_imgs)
        g_loss = bce_loss(validity, torch.ones_like(validity))
        state.opt_g.zero_grad(set_to_none=True)
        g_loss.backward()
        d.requires_grad_(True)
        state.opt_g.step()

        # --- D phase --------------------------------------------------------
        _, _, real_pred = d(scaled_nchw)
        _, _, fake_pred = d(gen_imgs.detach())
        d_loss = (
            bce_loss(real_pred, torch.ones_like(real_pred))
            + bce_loss(fake_pred, torch.zeros_like(fake_pred))
        ) / 2.0
        state.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        state.opt_d.step()

        # --- info phase (updates G and D's shared trunk) --------------------
        gen_imgs = g(z, label_input, code)
        pred_label, pred_code, _ = d(gen_imgs)
        info_1 = config.lambda_cat * torch_cross_entropy(
            pred_label, sampled_labels
        ) + config.lambda_con * mse_loss(pred_code, code)
        _, transform_code, _ = d(scaled_nchw)
        _, real_code, _ = d(real_nchw)
        pred_affine = regularize(RPQXY, real_code[:, :5], transform_code[:, :5])
        affine = config.lambda_affine * mse_loss(pred_affine, code[:, :5])
        info_loss = info_1 + affine
        state.opt_info.zero_grad(set_to_none=True)
        info_loss.backward()
        state.opt_info.step()

        state.step += 1
        return state, {
            "d_loss": d_loss.detach(),
            "g_loss": g_loss.detach(),
            "info_loss": info_loss.detach(),
        }

    return step
