"""MNIST EAD-GAN trainer CLI (PyTorch/CUDA).

``python -m eadgan_tpu_torch.cli.mnist`` — counterpart of ``python -m
eadgan_tpu.cli.mnist``.  Loads the frozen affine approximator from
``--approximator`` (default ``<ckpt_dir>/rpqmnxy_approximator.pt``, the
file ``cli.approximate_rpqmnxy`` writes, or the JAX package's in its
format) and exits without it unless
``--allow_fresh_approximator``.  Reads the MNIST idx archives from
``<data_dir>/data/mnist`` (the synthetic stand-in when they are absent:
the port never downloads), trains the LSGAN step on the CUDA card
(``EADGAN_PLATFORM=cpu`` for the CPU), writes static/original/scaled/
varying_c1..7 grids every ``sample_interval`` steps and, every
``10 * sample_interval``, ``generator_%d.pt`` and ``encoder_%d.pt`` with
the train state ``mnist_train_state_%d.ckpt`` beside them, which
``--resume`` restores.  ``--compute bf16`` (the default on the card)
runs G, D and E in bf16; the approximator stays float32.
``--data_parallel`` / ``--zero_opt``: data-parallel training over a
gang's ranks (``parallel/``), as ``cli.celeba``.
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
from eadgan_tpu_torch.data.mnist import load_mnist, mnist_archive_present
from eadgan_tpu_torch.ops import warp_affine
from eadgan_tpu_torch.parallel import is_coordinator
from eadgan_tpu_torch.sample.figures import mnist_training_grids
from eadgan_tpu_torch.train.checkpoint import restore_model, save_model, save_train_state, save_train_state_sync
from eadgan_tpu_torch.train.config import MnistConfig
from eadgan_tpu_torch.train.engine import generator_apply, run_epochs
from eadgan_tpu_torch.train.gan_mnist import METRIC_KEYS, init_mnist_gan_state, make_mnist_gan_step
from eadgan_tpu_torch.train.pretrain import approximator_model
from eadgan_tpu_torch.transforms import RPQMNXY, code_to_matrix
from eadgan_tpu_torch.utils import MetricLogger, platform_device

STATE_STEM = "mnist_train_state"


def warp_batch(img: torch.Tensor, seed: int, code_dim: int) -> torch.Tensor:
    """Warp an NHWC batch by rpqmnxy codes drawn from ``seed`` (the
    "scaled" sample grid)."""
    gen = torch.Generator(device=img.device).manual_seed(seed)
    code = torch.rand(img.shape[0], code_dim, generator=gen, device=img.device) * 2.0 - 1.0
    return warp_affine(img, code_to_matrix(RPQMNXY, code), padding_mode="border")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_epochs", type=int, default=200, help="number of epochs of training")
    parser.add_argument("--batch_size", type=int, default=128, help="size of the batches")
    add_adam_args(parser, lr=1e-4)
    parser.add_argument("--latent_dim", type=int, default=62, help="dimensionality of the latent space")
    parser.add_argument("--code_dim", type=int, default=7, help="latent code")
    parser.add_argument("--n_classes", type=int, default=10, help="number of classes for dataset")
    parser.add_argument("--img_size", type=int, default=32, help="size of each image dimension")
    parser.add_argument("--channels", type=int, default=1, help="number of image channels")
    parser.add_argument("--sample_interval", type=int, default=4000, help="interval between image sampling")
    parser.add_argument("--approximator", type=str, default="", help="frozen rpqmnxy approximator file (.pt)")
    parser.add_argument("--allow_fresh_approximator", action="store_true",
                        help="run with a randomly-initialized approximator if no file exists (smoke runs)")
    add_run_args(parser)
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = init_multiprocess(opt, platform_device)

    config = MnistConfig(
        n_epochs=opt.n_epochs,
        batch_size=opt.batch_size,
        lr=opt.lr,
        b1=opt.b1,
        b2=opt.b2,
        latent_dim=opt.latent_dim,
        code_dim=opt.code_dim,
        n_classes=opt.n_classes,
        img_size=opt.img_size,
        channels=opt.channels,
        sample_interval=opt.sample_interval,
    )
    mnist_dir = os.path.join(opt.data_dir, "data/mnist")
    if not mnist_archive_present(mnist_dir):
        print(f"no MNIST idx archives in {mnist_dir}: training on the synthetic stand-in "
              "(this trainer never downloads; put train-images-idx3-ubyte[.gz] and "
              "train-labels-idx1-ubyte[.gz] there)")
    # (N, 32, 32, 1) float32 in [-1, 1]; the labels feed nothing (the step
    # samples its own)
    images, _ = load_mnist(mnist_dir, config.img_size)

    approx = approximator_model(seed=1)
    approx_path = opt.approximator or os.path.join(opt.ckpt_dir, "rpqmnxy_approximator.pt")
    if os.path.exists(approx_path):
        restore_model(approx_path, approx)
        print(f"loaded frozen approximator from {approx_path}")
    elif not opt.allow_fresh_approximator:
        raise SystemExit(
            f"missing {approx_path}; run python -m eadgan_tpu_torch.cli.approximate_rpqmnxy "
            "first or pass --allow_fresh_approximator"
        )

    state = init_mnist_gan_state(
        config, approx, device=device, seed=opt.seed, dtype=resolve_compute_dtype(opt, device)
    )
    state = maybe_resume(state, opt.resume, opt.ckpt_dir, STATE_STEM)
    step = make_mnist_gan_step(config)
    logger = MetricLogger((opt.jsonl or None) if is_coordinator() else None)
    save_every = config.sample_interval * 10

    def on_batch(batches_done, state, metrics, batch):
        if batches_done % config.sample_interval == 0:
            # the state handed in: on the chained engine's worker, a snapshot
            apply_g = generator_apply(lambda: state.g)
            real = batch[0][:100]
            scaled = warp_batch(real, batches_done, config.code_dim)
            mnist_training_grids(
                apply_g, real.cpu().numpy(), scaled.cpu().numpy(), opt.out_dir, batches_done,
                latent_dim=config.latent_dim, n_classes=config.n_classes,
                code_dim=config.code_dim,
            )
        if batches_done % save_every == 0:
            save_model(os.path.join(opt.ckpt_dir, f"generator_{batches_done}.pt"), state.g)
            save_model(os.path.join(opt.ckpt_dir, f"encoder_{batches_done}.pt"), state.e)
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
