"""dSprites / colored-dSprites adversarial train step (the rp step).

PyTorch counterpart of ``eadgan_tpu/train/gan_dsprites.py``, with the same
phase order:

A. align the real batch with the frozen pxy encoder (translation-only
   inverse warp; colored also divides out the predicted colour gains).
   The aligner stays out of autograd: its parameters take no gradient
   and ``align_img`` is computed without a graph;
B. D phase: distort the aligned reals by a sampled code (one warp), run
   G once without a graph (its BatchNorm statistics still move), and
   step D on BCE over distorted reals against the fakes;
C. info phase: one backward through G and E, with D frozen (it takes no
   gradient, but its spectral-norm state still advances): categorical
   mutual information and code MSE on new fakes, G's adversarial term
   against the updated D, the closed-form affine (+ colour) consistency
   of E on the aligned and re-distorted reals (a second distort warp),
   and the relative-category term against the detached aligned
   category.

Per step D runs three times (distorted reals, detached fakes, new
fakes), E three times (fakes, aligned, re-distorted), G twice, each
forward advancing the spectral-norm ``u`` and BatchNorm statistics in
the JAX step's order; the warp runs three times.  The gray D learning
rate is the config's ``d_lr``; the CLIs set it (2e-4 gray, ``--lr``
colored).  The step updates the state in place and returns it, with the
metrics as 0-d device tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from eadgan_tpu_torch.losses import bce_loss, mse_loss, mutual_info_loss
from eadgan_tpu_torch.models import SpritesDiscriminator, SpritesEncoder, SpritesGenerator
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel.mesh import global_batch, local_rows
from eadgan_tpu_torch.train.config import SpritesGanConfig
from eadgan_tpu_torch.train.pretrain import colorize, draw_color
from eadgan_tpu_torch.train.state import GanTrainState, adam
from eadgan_tpu_torch.transforms import (
    RP,
    apply_color,
    code_to_matrix,
    color_code_to_gain,
    inverse_affine,
    pxy_align_matrix,
    regularize,
    regularize_color,
    remove_color,
)
from eadgan_tpu_torch.utils.device import resolve_device

__all__ = [
    "init_sprites_gan_state",
    "make_sprites_gan_step",
    "align_images",
    "distort_images",
    "METRIC_KEYS",
]

METRIC_KEYS = ("d_loss", "g_loss", "cat_loss", "cont_loss", "affine_loss", "relative_cat_loss")


def init_sprites_gan_state(
    config: SpritesGanConfig, pxy, device=None, seed: int = 0, dtype=None
) -> GanTrainState:
    """Fresh G, D and E (torch default init, drawn from ``seed`` without
    touching the global generator) and their optimizers on ``device`` (the
    CUDA card when None), with ``pxy``, the stage-1 aligner, frozen
    beside them.  ``dtype`` is the compute type of G, D and E (None:
    float32; ``torch.bfloat16``); the aligner stays float32.  No G
    optimizer: G's adversarial update lives in ``opt_info`` over G and E."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        g = SpritesGenerator(
            in_dim=config.n_classes + config.code_dim, channels=config.channels, dtype=dtype
        )
        d = SpritesDiscriminator(channels=config.channels, dtype=dtype)
        e = SpritesEncoder(
            n_classes=config.n_classes, code_dim=config.code_dim, channels=config.channels,
            dtype=dtype,
        )
    for m in (g, d, e):
        m.to(device).train()
    pxy.to(device).eval().requires_grad_(False)
    return GanTrainState(
        g=g,
        d=d,
        e=e,
        pxy=pxy,
        opt_g=None,
        opt_d=adam(d.parameters(), config.d_lr, config.b1, config.b2),
        opt_info=adam([*g.parameters(), *e.parameters()], config.lr, config.b1, config.b2),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


@torch.no_grad()
def align_images(pxy, img: torch.Tensor, colored: bool, rgb_factor: float) -> torch.Tensor:
    """The aligner's translation-only inverse warp of a contiguous NHWC
    batch (colored: then its predicted gains, at ``rgb_factor``, divided
    out); no graph."""
    align_code = pxy(img.permute(0, 3, 1, 2))
    matrix = inverse_affine(pxy_align_matrix(align_code[:, :3]))
    align_img = warp_affine(img, matrix, padding_mode="border")
    if colored:
        align_img = remove_color(align_img, color_code_to_gain(align_code[:, 3:], rgb_factor))
    return align_img


def distort_images(align_img: torch.Tensor, code: torch.Tensor, config: SpritesGanConfig):
    """Warp aligned reals by an rp code (colored: then tint by its gains)."""
    out = warp_affine(align_img, code_to_matrix(RP, code[:, :4]), padding_mode="border")
    if config.colored:
        out = apply_color(out, color_code_to_gain(code[:, 4:], config.rgb_factor))
    return out


def make_sprites_gan_step(config: SpritesGanConfig):
    def sample_inputs(rng, batch, dev):
        code = torch.rand(batch, config.code_dim, generator=rng, device=dev) * 2.0 - 1.0
        labels = torch.randint(0, config.n_classes, (batch,), generator=rng, device=dev)
        return code, F.one_hot(labels, config.n_classes).to(torch.float32)

    def step(state: GanTrainState, img: torch.Tensor, fixed=None):
        """``img``: contiguous (B, 64, 64, 1) NHWC in {0, 1}.  ``fixed``
        (parity tests) injects the draws: {"code_d", "onehot_d",
        "code_i", "onehot_i"} and, colored, {"color"} ((B, 3) or
        (B, 1, 1, 3)), at the global batch in a data-parallel step: the
        draws are made there and this rank keeps its rows
        (``parallel.local_rows``)."""
        g, d, e = state.g, state.d, state.e
        dev = img.device
        batch = img.shape[0]
        if fixed is not None:
            f32 = {k: torch.as_tensor(v, dtype=torch.float32, device=dev) for k, v in fixed.items()}
            color = f32.get("color")
            code_d, onehot_d = f32["code_d"], f32["onehot_d"]
            code_i, onehot_i = f32["code_i"], f32["onehot_i"]
        else:
            n = global_batch(batch)
            color = draw_color(n, state.rng, dev) if config.colored else None
            code_d, onehot_d = sample_inputs(state.rng, n, dev)
            code_i, onehot_i = sample_inputs(state.rng, n, dev)
        code_d, onehot_d, code_i, onehot_i = (
            local_rows(t, batch) for t in (code_d, onehot_d, code_i, onehot_i))
        if config.colored:
            color = local_rows(color, batch)
            img = colorize(img, color)

        # --- A. alignment (frozen encoder, no graph) ----------------------
        align_img = align_images(state.pxy, img, config.colored, config.align_rgb_factor)
        align_nchw = align_img.permute(0, 3, 1, 2)

        # --- B. D phase -----------------------------------------------------
        trans_img = distort_images(align_img, code_d, config)
        with torch.no_grad():
            gen_imgs = g(torch.cat([onehot_d, code_d], dim=-1))
        d_real = d(trans_img.permute(0, 3, 1, 2))
        d_fake = d(gen_imgs)
        d_loss = (
            bce_loss(d_real, torch.ones_like(d_real)) + bce_loss(d_fake, torch.zeros_like(d_fake))
        ) / 2.0
        state.opt_d.zero_grad(set_to_none=True)
        d_loss.backward()
        state.opt_d.step()

        # --- C. info phase (one backward through G and E; D frozen) ------
        trans_img_i = distort_images(align_img, code_i, config)
        d.requires_grad_(False)
        gen = g(torch.cat([onehot_i, code_i], dim=-1))
        rec_cat, rec_cont = e(gen)
        g_fake = d(gen)
        g_loss = bce_loss(g_fake, torch.ones_like(g_fake))
        cat_loss = mutual_info_loss(rec_cat, onehot_i)
        cont_loss = mse_loss(rec_cont, code_i)
        align_cat, align_cont = e(align_nchw)
        trans_cat, trans_cont = e(trans_img_i.permute(0, 3, 1, 2))
        rec = regularize(RP, align_cont[:, :4], trans_cont[:, :4])
        if config.colored:
            rec_color = regularize_color(align_cont[:, 4:], trans_cont[:, 4:], config.rgb_factor)
            rec = torch.cat([rec, rec_color], dim=-1)
        affine_loss = mse_loss(rec, code_i)
        relative_cat_loss = mutual_info_loss(trans_cat, align_cat.detach())
        total = cat_loss + cont_loss + affine_loss + g_loss + relative_cat_loss
        state.opt_info.zero_grad(set_to_none=True)
        total.backward()
        d.requires_grad_(True)
        state.opt_info.step()

        state.step += 1
        losses = (d_loss, g_loss, cat_loss, cont_loss, affine_loss, relative_cat_loss)
        return state, {k: v.detach() for k, v in zip(METRIC_KEYS, losses)}

    return step
