"""Stage-1 pretraining: the affine approximator (MNIST) and the pxy
alignment encoders (dSprites, gray and colored).

PyTorch counterpart of ``eadgan_tpu/train/pretrain.py``.  Two steps:

* :func:`make_approximator_step`: random rpqmnxy codes, their matrices
  built analytically and flattened to 2x3, and the MLP regressed on the
  *physical parameters* of the codes (not the codes) with an MSE; one
  Adam;
* :func:`make_pxy_step`: a self-supervised step that warps the real
  batch by a sampled (p, x, y) code (colored: also tints it by sampled
  RGB gains), encodes both images, recovers the relative code in closed
  form and regresses it on the sampled code with an MSE.  The warp pads
  with ``zeros`` when colored and ``border`` when gray, as the JAX step
  does.
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.losses import mse_loss
from eadgan_tpu_torch.models import AffineApproximator, SpritesEncoderPxy
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel.mesh import global_batch, local_rows
from eadgan_tpu_torch.train.config import ApproximatorConfig, PxyConfig
from eadgan_tpu_torch.train.state import EncoderTrainState, adam
from eadgan_tpu_torch.transforms import (
    PXY,
    RPQMNXY,
    apply_color,
    code_to_matrix,
    code_to_params,
    color_code_to_gain,
    flatten_matrix_2x3,
    regularize,
    regularize_color,
)
from eadgan_tpu_torch.utils.device import resolve_device

__all__ = [
    "approximator_model",
    "init_approximator_state",
    "make_approximator_step",
    "colorize",
    "draw_color",
    "init_pxy_state",
    "make_pxy_step",
    "pxy_encoder",
]


def approximator_model(seed: int) -> AffineApproximator:
    """A fresh approximator (torch default init drawn from ``seed``
    without touching the global generator), on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return AffineApproximator()


def init_approximator_state(config: ApproximatorConfig, device=None, seed: int = 0) -> EncoderTrainState:
    """A fresh approximator and its Adam on ``device`` (the CUDA card when
    None)."""
    device = resolve_device(device)
    model = approximator_model(seed).to(device).train()
    return EncoderTrainState(
        model=model,
        opt=adam(model.parameters(), config.lr, config.b1, config.b2),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def make_approximator_step(config: ApproximatorConfig):
    def step(state: EncoderTrainState, fixed=None):
        """One regression step on ``config.batch_size`` codes drawn
        uniform in [-1, 1) from ``state.rng``.  ``fixed`` (parity tests)
        injects them: {"code"} (B, 7)."""
        dev = state.rng.device
        if fixed is not None:
            code = torch.as_tensor(fixed["code"], dtype=torch.float32, device=dev)
        else:
            code = torch.rand(config.batch_size, 7, generator=state.rng, device=dev) * 2.0 - 1.0
        target = code_to_params(RPQMNXY, code)
        flat = flatten_matrix_2x3(code_to_matrix(RPQMNXY, code))
        loss = mse_loss(state.model(flat), target)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"affine_loss": loss.detach()}

    return step


def pxy_encoder(colored: bool, seed: int) -> SpritesEncoderPxy:
    """A fresh aligner (torch default init drawn from ``seed`` without
    touching the global generator), on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return SpritesEncoderPxy(out_dim=6 if colored else 3, channels=3 if colored else 1)


def init_pxy_state(config: PxyConfig, device=None, seed: int = 0) -> EncoderTrainState:
    """A fresh aligner and its Adam on ``device`` (the CUDA card when
    None)."""
    device = resolve_device(device)
    model = pxy_encoder(config.colored, seed).to(device).train()
    return EncoderTrainState(
        model=model,
        opt=adam(model.parameters(), config.lr, config.b1, config.b2),
        rng=torch.Generator(device=device).manual_seed(seed),
    )


def draw_color(batch: int, gen: torch.Generator, device) -> torch.Tensor:
    """Per-image RGB colours, uniform in [0.5, 1): (B, 3)."""
    return torch.rand(batch, 3, generator=gen, device=device) * 0.5 + 0.5


def colorize(img: torch.Tensor, color: torch.Tensor) -> torch.Tensor:
    """Tile a (B, H, W, 1) gray batch to RGB and multiply by per-image
    colours (B, 3); the result is a new contiguous NHWC tensor."""
    return img.repeat(1, 1, 1, 3) * color.reshape(-1, 1, 1, 3)


def make_pxy_step(config: PxyConfig):
    padding = "zeros" if config.colored else "border"

    def step(state: EncoderTrainState, img: torch.Tensor, fixed=None):
        """``img``: contiguous (B, 64, 64, 1) NHWC in {0, 1}.  ``fixed``
        (parity tests) injects the draws: {"code"} and, colored,
        {"color"} ((B, 3) or (B, 1, 1, 3)), at the global batch in a
        data-parallel step (``parallel.local_rows``)."""
        dev = img.device
        batch = img.shape[0]
        if fixed is not None:
            code = torch.as_tensor(fixed["code"], dtype=torch.float32, device=dev)
            color = fixed.get("color")
            if color is not None:
                color = torch.as_tensor(color, dtype=torch.float32, device=dev)
        else:
            n = global_batch(batch)
            color = draw_color(n, state.rng, dev) if config.colored else None
            code = torch.rand(n, config.code_dim, generator=state.rng, device=dev) * 2.0 - 1.0
        code = local_rows(code, batch)
        if config.colored:
            img = colorize(img, local_rows(color, batch))

        trans_img = warp_affine(img, code_to_matrix(PXY, code[:, :3]), padding_mode=padding)
        if config.colored:
            trans_img = apply_color(trans_img, color_code_to_gain(code[:, 3:], config.rgb_factor))

        model = state.model
        real_code = model(img.permute(0, 3, 1, 2))
        trans_code = model(trans_img.permute(0, 3, 1, 2))
        rec = regularize(PXY, real_code[:, :3], trans_code[:, :3])
        if config.colored:
            rec_color = regularize_color(real_code[:, 3:], trans_code[:, 3:], config.rgb_factor)
            rec = torch.cat([rec, rec_color], dim=-1)
        loss = mse_loss(rec, code)
        state.opt.zero_grad(set_to_none=True)
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"affine_loss": loss.detach()}

    return step
