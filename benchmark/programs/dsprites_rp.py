"""The program's side of the ``dsprites_rp`` configuration: the port's gray
rp train state and step built as ``cli/rp.py`` builds them (the aligner
frozen beside G, D and E), loaded with the benchmark's weights, and the
CLI's grid and save callback at its cadence."""

from __future__ import annotations

import os

import torch

from eadgan_tpu_torch.cli.rp import STATE_STEM, render_pair
from eadgan_tpu_torch.sample.figures import sprites_training_grids
from eadgan_tpu_torch.train.checkpoint import save_model, save_train_state
from eadgan_tpu_torch.train.config import SpritesGanConfig
from eadgan_tpu_torch.train.engine import generator_apply
from eadgan_tpu_torch.train.gan_dsprites import METRIC_KEYS, init_sprites_gan_state, make_sprites_gan_step
from eadgan_tpu_torch.train.pretrain import pxy_encoder

from harness.weights import part

COMPUTE = {"bf16": torch.bfloat16, "f32": None}


def port_config(cfg: dict, batch: int) -> SpritesGanConfig:
    m, o, cli = cfg["model"], cfg["optimizer"], cfg["cli"]
    return SpritesGanConfig.for_dataset(
        False, batch_size=batch, lr=o["lr"], d_lr=o["d_lr"], b1=o["b1"], b2=o["b2"],
        code_dim=m["code_dim"], n_classes=m["n_classes"], img_size=m["img_size"],
        channels=m["channels"], sample_interval=cli["sample_interval"],
    )


class TrainProgram:
    """``state``, ``step`` and what ``run_epochs`` takes besides, as the
    CLI passes it.  A state's trained models and its Adams are its
    attributes ``MODELS`` and ``OPTIMIZERS``."""

    MODELS = ("g", "d", "e")
    OPTIMIZERS = ("opt_d", "opt_info")

    def __init__(self, cfg: dict, batch: int, weights, rng_seed: int, device):
        self.config = port_config(cfg, batch)
        pxy = pxy_encoder(False, seed=1)
        pxy.load_state_dict(part(weights, "pxy"))
        self.state = init_sprites_gan_state(self.config, pxy, device=device, seed=rng_seed,
                                            dtype=COMPUTE[cfg["compute"]])
        for name in ("g", "d", "e"):
            getattr(self.state, name).load_state_dict(part(weights, name))
        self.step = make_sprites_gan_step(self.config)
        self.models = {"g": self.state.g, "d": self.state.d, "e": self.state.e}
        cli = cfg["cli"]
        self.save_every = cli["sample_interval"] * cli["save_every_samples"]
        self.run_kwargs = dict(
            metric_keys=list(METRIC_KEYS), scale=cfg["data"]["scale"], shift=cfg["data"]["shift"],
            random_flip=cfg["data"]["flip"],
            chain_periods=(cli["sample_interval"] * cli["grid_every_samples"], self.save_every),
        )
        self.grid_every = cli["sample_interval"] * cli["grid_every_samples"]
        self.print_every = cli["print_every"]

    def cli_on_batch(self, out_dir: str, n_rows: int):
        """``cli/rp.py``'s callback: the original/trans/varying grids every
        ``2 * sample_interval`` steps, the model files and the train state
        every ``500 * sample_interval``."""
        config, grid_every, save_every = self.config, self.grid_every, self.save_every

        def on_batch(batches_done, state, metrics, batch):
            if batches_done % grid_every == 0:
                apply_g = generator_apply(lambda: state.g)
                align, trans = render_pair(state.pxy, batch[0][:100], batches_done, config)
                sprites_training_grids(apply_g, align.cpu().numpy(), trans.cpu().numpy(), out_dir,
                                       batches_done, code_dim=config.code_dim)
            if batches_done % save_every == 0:
                save_model(os.path.join(out_dir, f"encoder_{batches_done}.pt"), state.e)
                save_model(os.path.join(out_dir, f"generator_{batches_done}.pt"), state.g)
                save_train_state(out_dir, STATE_STEM, batches_done, state, keep=1)

        return on_batch
