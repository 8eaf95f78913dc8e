"""The program's side of the ``celeba`` configuration: the port's CelebA
train state and step built as ``cli/celeba.py`` builds them, loaded with
the benchmark's weights, and the CLI's grid and save callback at its
cadence."""

from __future__ import annotations

import os

import torch

from eadgan_tpu_torch.cli.celeba import STATE_STEM, warp_batch
from eadgan_tpu_torch.sample.figures import celeba_training_grids
from eadgan_tpu_torch.train.checkpoint import cpu_state_dict, save_checkpoint, save_train_state
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.engine import generator_apply
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

from harness.weights import part

COMPUTE = {"bf16": torch.bfloat16, "f32": None}


def port_config(cfg: dict, batch: int) -> CelebaConfig:
    m, o, cli = cfg["model"], cfg["optimizer"], cfg["cli"]
    return CelebaConfig(
        batch_size=batch, g_lr=o["g_lr"], d_lr=o["d_lr"], info_lr=o["info_lr"], b1=o["b1"],
        b2=o["b2"], latent_dim=m["latent_dim"], code_dim=m["code_dim"], n_classes=m["n_classes"],
        img_size=m["img_size"], channels=m["channels"], sample_interval=cli["sample_interval"],
        lambda_cat=cfg["loss"]["lambda_cat"], lambda_con=cfg["loss"]["lambda_con"],
        lambda_affine=cfg["loss"]["lambda_affine"],
    )


class TrainProgram:
    """``state``, ``step`` and what ``run_epochs`` takes besides, as the
    CLI passes it.  A state's trained models and its Adams are its
    attributes ``MODELS`` and ``OPTIMIZERS``."""

    MODELS = ("g", "d")
    OPTIMIZERS = ("opt_g", "opt_d", "opt_info")

    def __init__(self, cfg: dict, batch: int, weights, rng_seed: int, device):
        self.config = port_config(cfg, batch)
        self.state = init_celeba_gan_state(self.config, device=device, seed=rng_seed,
                                           dtype=COMPUTE[cfg["compute"]])
        for name in ("g", "d"):
            getattr(self.state, name).load_state_dict(part(weights, name))
        self.step = make_celeba_gan_step(self.config)
        self.models = {"g": self.state.g, "d": self.state.d}
        self.optimizers = {"opt_g": self.state.opt_g, "opt_d": self.state.opt_d,
                           "opt_info": self.state.opt_info}
        cli = cfg["cli"]
        self.run_kwargs = dict(
            metric_keys=list(cli["metric_keys"]), scale=cfg["data"]["scale"],
            shift=cfg["data"]["shift"], random_flip=cfg["data"]["flip"],
            chain_periods=(cli["sample_interval"], cli["sample_interval"] * cli["save_every_samples"]),
        )
        self.print_every = cli["print_every"]

    def cli_on_batch(self, out_dir: str, n_rows: int):
        """``cli/celeba.py``'s callback: grids every ``sample_interval``
        steps, a checkpoint and the train state every 15 of them."""
        config = self.config

        def on_batch(batches_done, state, metrics, batch):
            if batches_done % config.sample_interval == 0:
                apply_g = generator_apply(lambda: state.g)
                real = batch[0][:100]
                scaled = warp_batch(real, batches_done, config.code_dim)
                celeba_training_grids(
                    apply_g, real.cpu().numpy(), scaled.cpu().numpy(), out_dir, batches_done,
                    latent_dim=config.latent_dim, n_classes=config.n_classes,
                    code_dim=config.code_dim,
                )
            if batches_done % (config.sample_interval * 15) == 0:
                n_batches = max(n_rows // config.batch_size, 1)
                save_checkpoint(
                    os.path.join(out_dir, f"checkpoint_{batches_done}.tar"),
                    {"discriminator_state_dict": cpu_state_dict(state.d),
                     "generator_state_dict": cpu_state_dict(state.g),
                     "epoch": batches_done // n_batches, "batches_done": batches_done},
                )
                save_train_state(out_dir, STATE_STEM, batches_done, state, keep=1)

        return on_batch

