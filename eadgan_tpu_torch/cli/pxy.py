"""dSprites stage-1 pxy alignment-encoder trainer CLI (PyTorch/CUDA).

``python -m eadgan_tpu_torch.cli.pxy`` — counterpart of ``python -m
eadgan_tpu.cli.pxy``; ``cli.pxy_color`` is the colored variant.  Reads the
dSprites archive (the synthetic stand-in when it is absent), trains the
aligner on the CUDA card (``EADGAN_PLATFORM=cpu`` for the CPU), writes
original/align grids every ``sample_interval`` steps and, every
``50 * sample_interval`` (colored: ``10 *``), the model file
``encoder_pxy_%d.pt`` (``encoder_pxy_color_%d.pt``) that stage 2 loads
with ``--encoder_pxy``, and beside it the train state
``encoder_pxy[_color]_train_state_%d.ckpt`` for ``--resume``.  The
aligner computes in float32 whatever ``--compute`` says, as in the JAX
package.  ``--data_parallel`` / ``--zero_opt``: data-parallel training
over a gang's ranks (``parallel/``), as ``cli.celeba``.
"""

from __future__ import annotations

import argparse
import os

import torch

from eadgan_tpu_torch.cli.common import (
    add_adam_args,
    add_run_args,
    disable_tf32,
    exit_if_preempted,
    init_multiprocess,
    maybe_resume,
    setup_preemption,
)
from eadgan_tpu_torch.data import load_dsprites
from eadgan_tpu_torch.parallel import is_coordinator
from eadgan_tpu_torch.sample.figures import pxy_grids
from eadgan_tpu_torch.train.checkpoint import save_model, save_train_state, save_train_state_sync
from eadgan_tpu_torch.train.config import PxyConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.gan_dsprites import align_images
from eadgan_tpu_torch.train.pretrain import colorize, draw_color, init_pxy_state, make_pxy_step
from eadgan_tpu_torch.utils import MetricLogger, platform_device


def build_parser(colored: bool) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_epochs", type=int, default=10, help="number of epochs of training")
    parser.add_argument("--batch_size", type=int, default=128, help="size of the batches")
    add_adam_args(parser, lr=2e-4)
    parser.add_argument("--code_dim", type=int, default=PxyConfig.for_dataset(colored).code_dim, help="latent code")
    parser.add_argument("--img_size", type=int, default=64, help="size of each image dimension")
    parser.add_argument("--sample_interval", type=int, default=1000, help="interval between image sampling")
    add_run_args(parser)
    return parser


def align_sample(model, img: torch.Tensor, seed: int, config: PxyConfig):
    """(real, aligned) NHWC batches for the grids; colored draws its
    colours from ``seed``."""
    if config.colored:
        gen = torch.Generator(device=img.device).manual_seed(seed)
        img = colorize(img, draw_color(img.shape[0], gen, img.device))
    return img, align_images(model, img, config.colored, config.rgb_factor)


def main(argv=None, colored: bool = False) -> None:
    opt = build_parser(colored).parse_args(argv)
    print(opt)
    disable_tf32()
    device = init_multiprocess(opt, platform_device)

    config = PxyConfig.for_dataset(
        colored,
        n_epochs=opt.n_epochs,
        batch_size=opt.batch_size,
        lr=opt.lr,
        b1=opt.b1,
        b2=opt.b2,
        code_dim=opt.code_dim,
        img_size=opt.img_size,
        sample_interval=opt.sample_interval,
    )
    images = load_dsprites(opt.data_dir).imgs  # (N, 64, 64) uint8

    stem = "encoder_pxy_color" if colored else "encoder_pxy"
    state = init_pxy_state(config, device=device, seed=opt.seed)
    state = maybe_resume(state, opt.resume, opt.ckpt_dir, f"{stem}_train_state")
    step = make_pxy_step(config)
    logger = MetricLogger((opt.jsonl or None) if is_coordinator() else None)
    save_every = config.sample_interval * (10 if colored else 50)

    def on_batch(batches_done, state, metrics, batch):
        if batches_done % config.sample_interval == 0:
            real, aligned = align_sample(state.model, batch[0], batches_done, config)
            pxy_grids(real[:100].cpu().numpy(), aligned[:100].cpu().numpy(), opt.out_dir, batches_done)
        if batches_done % save_every == 0:
            save_model(os.path.join(opt.ckpt_dir, f"{stem}_{batches_done}.pt"), state.model)
            save_train_state(
                opt.ckpt_dir, f"{stem}_train_state", batches_done, state, keep=opt.keep_states
            )

    # SIGTERM: finish the window, save the train state at the exact step,
    # exit 86 (utils/preempt.py; --resume auto continues with no lost step)
    guard = setup_preemption(opt)

    def on_shutdown(step_now, state):
        save_train_state_sync(
            opt.ckpt_dir, f"{stem}_train_state", step_now, state, keep=opt.keep_states
        )

    run_epochs(
        n_epochs=config.n_epochs,
        data=images,
        batch_size=config.batch_size,
        state=state,
        step_fn=step,
        on_batch=on_batch,
        device=device,
        seed=opt.seed,
        max_steps=opt.max_steps,
        logger=logger,
        metric_keys=["affine_loss"],
        chain=opt.chain,
        chain_periods=(config.sample_interval, save_every),
        watchdog=opt.watchdog,
        profile_dir=opt.profile_dir,
        stop_event=guard.requested if guard else None,
        on_shutdown=on_shutdown,
        data_parallel=opt.data_parallel,
        zero_opt=opt.zero_opt,
    )
    exit_if_preempted(guard)


if __name__ == "__main__":
    main()
