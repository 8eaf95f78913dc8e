"""dSprites stage-2 EAD-GAN trainer CLI (PyTorch/CUDA).

``python -m eadgan_tpu_torch.cli.rp`` — counterpart of ``python -m
eadgan_tpu.cli.rp``; ``cli.rp_color`` is the colored variant.  Loads the
frozen stage-1 aligner from ``--encoder_pxy`` (default
``<ckpt_dir>/encoder_pxy_50000.pt``, colored
``encoder_pxy_color_50000.pt``, files written by ``cli.pxy`` /
``cli.pxy_color``, or by the JAX package's in its format) and exits
without it unless ``--allow_fresh_pxy``.
Trains the three-phase rp step on the CUDA card (``EADGAN_PLATFORM=cpu``
for the CPU), writes original/trans/varying_c* grids every
``2 * sample_interval`` steps and, every ``500 * sample_interval``
(colored: ``50 *``), ``encoder_%d.pt`` and ``generator_%d.pt`` with the
train state ``rp_train_state_%d.ckpt`` beside them.  ``--compute bf16``
(the default on the card) runs G, D and E in bf16; the aligner stays
float32.  ``--data_parallel`` / ``--zero_opt``: data-parallel training
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
    resolve_compute_dtype,
    setup_preemption,
)
from eadgan_tpu_torch.data import load_dsprites
from eadgan_tpu_torch.parallel import is_coordinator
from eadgan_tpu_torch.sample.figures import sprites_training_grids
from eadgan_tpu_torch.train.checkpoint import restore_model, save_model, save_train_state, save_train_state_sync
from eadgan_tpu_torch.train.config import SpritesGanConfig
from eadgan_tpu_torch.train.engine import generator_apply, run_epochs
from eadgan_tpu_torch.train.gan_dsprites import (
    METRIC_KEYS,
    align_images,
    distort_images,
    init_sprites_gan_state,
    make_sprites_gan_step,
)
from eadgan_tpu_torch.train.pretrain import colorize, draw_color, pxy_encoder
from eadgan_tpu_torch.utils import MetricLogger, platform_device

STATE_STEM = "rp_train_state"


def build_parser(colored: bool) -> argparse.ArgumentParser:
    defaults = SpritesGanConfig.for_dataset(colored)
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_epochs", type=int, default=100, help="number of epochs of training")
    parser.add_argument("--batch_size", type=int, default=128, help="size of the batches")
    add_adam_args(parser, lr=defaults.lr)
    parser.add_argument("--latent_dim", type=int, default=200, help="dimensionality of the latent space (unused, reference parity)")
    parser.add_argument("--code_dim", type=int, default=defaults.code_dim, help="latent code")
    parser.add_argument("--n_classes", type=int, default=3, help="number of classes for dataset")
    parser.add_argument("--img_size", type=int, default=64, help="size of each image dimension")
    parser.add_argument("--channels", type=int, default=defaults.channels, help="number of image channels")
    parser.add_argument("--sample_interval", type=int, default=1000, help="interval between image sampling")
    parser.add_argument("--encoder_pxy", type=str, default="", help="frozen stage-1 encoder file (.pt)")
    parser.add_argument("--allow_fresh_pxy", action="store_true", help="run with a randomly-initialized aligner if no file exists (smoke runs)")
    add_run_args(parser)
    return parser


@torch.no_grad()
def render_pair(pxy, img: torch.Tensor, seed: int, config: SpritesGanConfig):
    """Aligned reals and one distortion of them for the original/trans
    grids (one align and one distort warp), drawn from ``seed``."""
    gen = torch.Generator(device=img.device).manual_seed(seed)
    if config.colored:
        img = colorize(img, draw_color(img.shape[0], gen, img.device))
    align = align_images(pxy, img, config.colored, config.align_rgb_factor)
    code = torch.rand(img.shape[0], config.code_dim, generator=gen, device=img.device) * 2.0 - 1.0
    return align, distort_images(align, code, config)


def main(argv=None, colored: bool = False) -> None:
    opt = build_parser(colored).parse_args(argv)
    print(opt)
    disable_tf32()
    device = init_multiprocess(opt, platform_device)

    # colored: D follows --lr (colored_dSprites/rp_color.py:275); gray
    # hard-codes 2e-4 (dSprites/rp.py:277)
    config = SpritesGanConfig.for_dataset(
        colored,
        n_epochs=opt.n_epochs,
        batch_size=opt.batch_size,
        lr=opt.lr,
        b1=opt.b1,
        b2=opt.b2,
        code_dim=opt.code_dim,
        n_classes=opt.n_classes,
        img_size=opt.img_size,
        channels=opt.channels,
        sample_interval=opt.sample_interval,
    )
    images = load_dsprites(opt.data_dir).imgs  # (N, 64, 64) uint8

    pxy = pxy_encoder(colored, seed=1)
    pxy_default = "encoder_pxy_color_50000.pt" if colored else "encoder_pxy_50000.pt"
    pxy_path = opt.encoder_pxy or os.path.join(opt.ckpt_dir, pxy_default)
    if os.path.exists(pxy_path):
        restore_model(pxy_path, pxy)
        print(f"loaded frozen aligner from {pxy_path}")
    elif not opt.allow_fresh_pxy:
        raise SystemExit(
            f"missing frozen aligner checkpoint {pxy_path}; train stage 1 first "
            "(python -m eadgan_tpu_torch.cli.pxy) or pass --allow_fresh_pxy"
        )

    state = init_sprites_gan_state(
        config, pxy, device=device, seed=opt.seed, dtype=resolve_compute_dtype(opt, device)
    )
    state = maybe_resume(state, opt.resume, opt.ckpt_dir, STATE_STEM)
    step = make_sprites_gan_step(config)
    logger = MetricLogger((opt.jsonl or None) if is_coordinator() else None)
    save_every = config.sample_interval * (50 if colored else 500)

    def on_batch(batches_done, state, metrics, batch):
        if batches_done % (config.sample_interval * 2) == 0:
            # the state handed in: on the chained engine's worker, a snapshot
            apply_g = generator_apply(lambda: state.g)
            align, trans = render_pair(state.pxy, batch[0][:100], batches_done, config)
            sprites_training_grids(
                apply_g, align.cpu().numpy(), trans.cpu().numpy(), opt.out_dir, batches_done,
                code_dim=config.code_dim,
            )
        if batches_done % save_every == 0:
            save_model(os.path.join(opt.ckpt_dir, f"encoder_{batches_done}.pt"), state.e)
            save_model(os.path.join(opt.ckpt_dir, f"generator_{batches_done}.pt"), state.g)
            save_train_state(opt.ckpt_dir, STATE_STEM, batches_done, state, keep=opt.keep_states)

    # SIGTERM: finish the window, save the train state at the exact step,
    # exit 86 (utils/preempt.py; --resume auto continues with no lost step)
    guard = setup_preemption(opt)

    def on_shutdown(step_now, state):
        save_train_state_sync(opt.ckpt_dir, STATE_STEM, step_now, state, keep=opt.keep_states)

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
        metric_keys=list(METRIC_KEYS),
        chain=opt.chain,
        chain_periods=(config.sample_interval * 2, save_every),
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
