"""Disentanglement-score CLI (PyTorch/CUDA): the twelve reference score
scripts (``python dSprites/score/<Metric>.py`` and the colored variants)
behind one entry point.

``python -m eadgan_tpu_torch.cli.score`` — counterpart of ``python -m
eadgan_tpu.cli.score``, with its flags and defaults:

    python -m eadgan_tpu_torch.cli.score --metric BetVAE [--colored]
    python -m eadgan_tpu_torch.cli.score --metric all --json_out scores.json

Loads the frozen stage-1 aligner and the trained category/continuous
encoder, model files under the reference names
(``encoder_pxy_50000.pt`` / ``encoder_pxy_color_50000.pt`` +
``encoder_500000.pt``, written by ``cli.pxy`` / ``cli.pxy_color`` and
``cli.rp`` / ``cli.rp_color``, or by the JAX package's CLIs in their
format; a reference-trained file goes through ``cli.import_torch``
first), and exits without them unless
``--allow_fresh``.  The encoders and the warp run on the CUDA card
(``EADGAN_PLATFORM=cpu`` for the CPU); the metric heads run on the host
in numpy/scipy (``eval/heads.py``), so no metric needs scikit-learn;
DCI's random forests (``--dci_regressor RandomForest*``) draw from
``--seed``.  MIG is skipped when the dataset has no
``latents_values``.  The last line printed is ``score timing (s):``
and a JSON object: dataset rendering or loading, metric data, and per
metric its wall time, the Representer's device and host-preparation
time, and the rest (the heads).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.data import load_dsprites
from eadgan_tpu_torch.eval import (
    Representer,
    betavae_score,
    dci_score,
    factorvae_score,
    fstat_score,
    make_metric_data,
    mig_score,
    sap_score,
)
from eadgan_tpu_torch.models import SpritesEncoder
from eadgan_tpu_torch.train.checkpoint import restore_model
from eadgan_tpu_torch.train.pretrain import pxy_encoder
from eadgan_tpu_torch.utils import platform_device

_METRICS = ["BetVAE", "FactorVAE", "MIG", "SAP", "DCI", "F_score"]


def fresh_encoders(colored: bool):
    """A fresh aligner and category/continuous encoder at the published
    widths, torch's default init drawn from seeds 1 and 2 (the JAX CLI
    draws from ``PRNGKey(1)`` and ``(2)``) without touching the global
    generator, on the CPU."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(2)
        encoder = SpritesEncoder(n_classes=3, code_dim=7 if colored else 4,
                                 channels=3 if colored else 1)
    return pxy_encoder(colored, seed=1), encoder


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--metric", type=str, default="all", choices=_METRICS + ["all"])
    parser.add_argument("--colored", action="store_true")
    parser.add_argument("--encoder_pxy", type=str, default="")
    parser.add_argument("--encoder", type=str, default="")
    parser.add_argument("--data_dir", type=str, default="..")
    parser.add_argument("--ckpt_dir", type=str, default=".")
    parser.add_argument("--dci_regressor", type=str, default="Lasso")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--n_groups", type=int, default=500)
    parser.add_argument("--allow_fresh", action="store_true",
                        help="random encoders when checkpoints are absent (plumbing tests)")
    parser.add_argument("--json_out", type=str, default="")
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = platform_device()

    colored = opt.colored
    aligner, cat_encoder = fresh_encoders(colored)
    pxy_default = "encoder_pxy_color_50000.pt" if colored else "encoder_pxy_50000.pt"
    pxy_path = opt.encoder_pxy or os.path.join(opt.ckpt_dir, pxy_default)
    enc_path = opt.encoder or os.path.join(opt.ckpt_dir, "encoder_500000.pt")
    for path, model, what in ((pxy_path, aligner, "aligner"), (enc_path, cat_encoder, "encoder")):
        if os.path.exists(path):
            restore_model(path, model)
            print(f"loaded {what} {path}")
        elif not opt.allow_fresh:
            raise SystemExit(f"missing {path} (pass --allow_fresh for plumbing tests)")

    timing = {}
    t0 = time.perf_counter()
    rng = np.random.default_rng(opt.seed)
    data = load_dsprites(opt.data_dir)
    t1 = time.perf_counter()
    metric_data = make_metric_data(data, rng, n_groups=opt.n_groups)
    timing.update(dataset=t1 - t0, metric_data=time.perf_counter() - t1)
    representer = Representer(aligner, cat_encoder, colored=colored, seed=opt.seed,
                              device=device)

    wanted = _METRICS if opt.metric == "all" else [opt.metric]
    results = {}
    for name in wanted:
        t0 = time.perf_counter()
        before = dict(representer.seconds, images=representer.images)
        if name == "BetVAE":
            results.update(betavae_score(metric_data, representer))
        elif name == "FactorVAE":
            results.update(factorvae_score(metric_data, representer))
        elif name == "MIG":
            if data.latents_values is None:
                print("skipping MIG: dataset has no latents_values")
                continue
            results.update(
                mig_score(data.imgs, data.latents_values[:, 1:], representer, rng=rng)
            )
        elif name == "SAP":
            results.update(sap_score(metric_data, representer))
        elif name == "DCI":
            results.update(dci_score(metric_data, representer, opt.dci_regressor, opt.seed))
        elif name == "F_score":
            results.update(fstat_score(metric_data, representer))
        wall = time.perf_counter() - t0
        spent = {k: representer.seconds[k] - before[k] for k in representer.seconds}
        timing[name] = {"wall": wall, **spent, "heads": wall - sum(spent.values()),
                        "images": representer.images - before["images"]}

    scalars = {k: float(v) for k, v in results.items()
               if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
    for k, v in scalars.items():
        print(f"{k}: {v:.6f}")
    if opt.json_out:
        with open(opt.json_out, "w") as f:
            json.dump(scalars, f, indent=2)
    print("score timing (s): " + json.dumps(timing), flush=True)


if __name__ == "__main__":
    main()
