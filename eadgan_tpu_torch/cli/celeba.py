"""CelebA EAD-GAN trainer CLI (PyTorch/CUDA).

``python -m eadgan_tpu_torch.cli.celeba`` — counterpart of
``python -m eadgan_tpu.cli.celeba``.  Reads an image folder (synthetic
stand-in faces when it is empty), trains the shared-info-head step on
the CUDA card (``EADGAN_PLATFORM=cpu`` for the CPU), writes sample grids
every ``sample_interval`` steps and, every ``15 * sample_interval``, an
atomic ``checkpoint_%d.tar`` with both models plus epoch/batches_done and
beside it the full train state ``celeba_train_state_%d.ckpt``, which
``--resume`` restores (``--keep_states N`` keeps the N newest).
``--compute bf16`` runs the models in bf16 with float32 parameters (the
default on the card; f32 on the CPU).  On SIGTERM it saves the train
state at the window's end and exits 86 (``--preempt_save``);
``--watchdog S`` exits 87 on a stall, for ``cli.supervise`` to relaunch.
``--data_parallel`` trains over the ranks of a gang (``cli.supervise
--ranks N``, ``torchrun``; in one process, a gang of one), each rank on
its slice of every batch of ``--batch_size``; ``--zero_opt`` shards the
Adam moments over them (``parallel/``).
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
from eadgan_tpu_torch.data import load_image_folder
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel import is_coordinator
from eadgan_tpu_torch.sample.figures import celeba_training_grids
from eadgan_tpu_torch.train.checkpoint import cpu_state_dict, save_checkpoint, save_train_state, save_train_state_sync
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.engine import generator_apply, run_epochs
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step
from eadgan_tpu_torch.transforms import RPQXY, code_to_matrix
from eadgan_tpu_torch.utils import MetricLogger, platform_device

STATE_STEM = "celeba_train_state"


def warp_batch(img: torch.Tensor, seed: int, code_dim: int) -> torch.Tensor:
    """Warp an NHWC batch by rpqxy codes drawn from ``seed`` (the "scaled"
    sample grid)."""
    gen = torch.Generator(device=img.device).manual_seed(seed)
    code = torch.rand(img.shape[0], code_dim, generator=gen, device=img.device) * 2.0 - 1.0
    return warp_affine(img, code_to_matrix(RPQXY, code[:, :5]), padding_mode="border")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_epochs", type=int, default=50, help="number of epochs of training")
    parser.add_argument("--batch_size", type=int, default=16, help="size of the batches")
    add_adam_args(parser, lr=2e-4)
    parser.add_argument("--latent_dim", type=int, default=200, help="dimensionality of the latent space")
    parser.add_argument("--code_dim", type=int, default=8, help="latent code")
    parser.add_argument("--n_classes", type=int, default=10, help="number of classes for dataset")
    parser.add_argument("--img_size", type=int, default=64, help="size of each image dimension")
    parser.add_argument("--channels", type=int, default=3, help="number of image channels")
    parser.add_argument("--sample_interval", type=int, default=4000, help="interval between image sampling")
    parser.add_argument("--max_images", type=int, default=0, help="cap dataset size (0 = all)")
    add_run_args(parser)
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = init_multiprocess(opt, platform_device)

    config = CelebaConfig(
        n_epochs=opt.n_epochs,
        batch_size=opt.batch_size,
        b1=opt.b1,
        b2=opt.b2,
        latent_dim=opt.latent_dim,
        code_dim=opt.code_dim,
        n_classes=opt.n_classes,
        img_size=opt.img_size,
        channels=opt.channels,
        sample_interval=opt.sample_interval,
    )
    # flips are re-drawn per batch in run_epochs (random_flip=True)
    images = load_image_folder(
        os.path.join(opt.data_dir, "data"),
        config.img_size,
        max_images=opt.max_images or None,
        flip=False,
        seed=opt.seed,
    )

    state = init_celeba_gan_state(
        config, device=device, seed=opt.seed, dtype=resolve_compute_dtype(opt, device)
    )
    state = maybe_resume(state, opt.resume, opt.ckpt_dir, STATE_STEM)
    step = make_celeba_gan_step(config)
    logger = MetricLogger((opt.jsonl or None) if is_coordinator() else None, print_every=10)

    def on_batch(batches_done, state, metrics, batch):
        if batches_done % config.sample_interval == 0:
            # the state handed in: on the chained engine's worker, a snapshot
            apply_g = generator_apply(lambda: state.g)
            real = batch[0][:100]
            scaled = warp_batch(real, batches_done, config.code_dim)
            celeba_training_grids(
                apply_g, real.cpu().numpy(), scaled.cpu().numpy(), opt.out_dir,
                batches_done, latent_dim=config.latent_dim,
                n_classes=config.n_classes, code_dim=config.code_dim,
            )
        if batches_done % (config.sample_interval * 15) == 0:
            n_batches = max(images.shape[0] // config.batch_size, 1)
            save_checkpoint(
                os.path.join(opt.ckpt_dir, f"checkpoint_{batches_done}.tar"),
                {
                    "discriminator_state_dict": cpu_state_dict(state.d),
                    "generator_state_dict": cpu_state_dict(state.g),
                    "epoch": batches_done // n_batches,
                    "batches_done": batches_done,
                },
            )
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
        metric_keys=["d_loss", "g_loss"],
        scale=1.0 / 127.5,
        shift=-1.0,
        random_flip=True,
        chain=opt.chain,
        chain_periods=(config.sample_interval, config.sample_interval * 15),
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
