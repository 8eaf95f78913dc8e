"""Metric dataset preparation (shared by all six metrics).

PyTorch-side counterpart of ``eadgan_tpu/eval/data.py`` (numpy only),
over the port's ``DspritesData``.  It draws from the caller's numpy
``Generator`` in the JAX package's order, so one seed gives the same
groups, split and factor sample in both packages:

* ``n_groups`` groups of ``group_size`` images with one non-color factor
  held fixed per group (label = fixed factor index - 1);
* a 10% random split for the eval-std normalizer;
* a 10%-sized random factor sample with ground-truth latent values
  (``latents_values`` lookup) and ids for SAP/DCI/F-stat, with the color
  factor dropped and the shape factor shifted to 0-base.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from eadgan_tpu_torch.data.dsprites import DspritesData

__all__ = ["make_metric_data"]


def make_metric_data(
    data: DspritesData,
    rng: np.random.Generator,
    n_groups: int = 500,
    group_size: int = 100,
) -> Dict:
    imgs = data.imgs
    sizes = np.asarray(data.latents_sizes)
    n_factors = sizes.size
    bases = np.concatenate([sizes[::-1].cumprod()[::-1][1:], [1]])

    def sample_latent(size):
        out = np.zeros((size, n_factors), np.int64)
        for i, s in enumerate(sizes):
            out[:, i] = rng.integers(0, s, size)
        return out

    groups = []
    for i in range(n_groups):
        fixed = i % (n_factors - 1) + 1  # skip the singleton color factor
        latents = sample_latent(group_size)
        latents[:, fixed] = rng.integers(0, sizes[fixed])
        groups.append({"img": imgs[latents @ bases], "label": fixed - 1})

    n_eval = imgs.shape[0] // 10
    eval_ids = rng.permutation(imgs.shape[0])[:n_eval]

    random_latent_ids = sample_latent(n_eval)
    random_imgs = imgs[random_latent_ids @ bases]
    if data.latents_values is not None:
        # ground-truth values via the dataset's own latent table
        random_values = data.latents_values[random_latent_ids @ bases].astype(np.float64)
    else:
        random_values = random_latent_ids.astype(np.float64)
    random_values = np.array(random_values[:, 1:])  # drop color factor
    random_values[:, 0] -= 1.0 if random_values[:, 0].min() >= 1 else 0.0

    return {
        "groups": groups,
        "img_eval_std": imgs[eval_ids],
        "img_with_latent": {
            "img": random_imgs,
            "latent": random_values,
            "latent_id": random_latent_ids[:, 1:],
            "is_continuous": [False] + [True] * (n_factors - 2),
        },
    }
