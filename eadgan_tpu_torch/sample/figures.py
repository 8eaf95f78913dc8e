"""Sample grids: copies of the JAX package's ``sample/figures.py`` (numpy
and PIL only), the training grids of every pipeline
(``mnist_training_grids``, ``celeba_training_grids``,
``sprites_training_grids``, ``pxy_grids``) and the inference sweeps
(``mnist_inference_grids``, ``celeba_inference_grids``), with the
reference's quirks: the MNIST c5-c7 training sweeps vary their own dims
but the dSprites c5-c7 ones all re-vary code 0; the inference sweeps
pair code dims.

The generator is passed as an ``apply`` callable mapping numpy latent
inputs to NHWC images, so any weights snapshot works.
"""

from __future__ import annotations

import functools

import numpy as np

from eadgan_tpu_torch.sample.grid import save_image
from eadgan_tpu_torch.utils import trace

__all__ = [
    "mnist_training_grids",
    "mnist_inference_grids",
    "celeba_training_grids",
    "celeba_inference_grids",
    "sprites_training_grids",
    "pxy_grids",
]


def _traced_grid(fn):
    """A training grid's render and write as a ``sample.grid`` span,
    counted in ``sample.grids`` (``utils/trace.py``)."""

    @functools.wraps(fn)
    def grids(*args, **kwargs):
        trace.count("sample.grids")
        with trace.span("sample.grid"):
            return fn(*args, **kwargs)

    return grids


def _sweep(code_dim, dims, values):
    """(len(values), code_dim) codes with ``values`` written into the
    given dims; everything else zero."""
    c = np.zeros((values.shape[0], code_dim), np.float32)
    for d in dims:
        c[:, d] = values
    return c


@_traced_grid
def mnist_training_grids(
    apply_g, real_img, scaled_img, out_dir, batches_done, n_row=10,
    latent_dim=62, n_classes=10, code_dim=7,
):
    """MNIST/EAD-GAN_rpqmnxy.py:276-330: static digits grid + original +
    scaled + varying_c1..c7 (column-wise ramp -2..2, zero z)."""
    rng = np.random.default_rng(batches_done)
    n = n_row * n_row
    static_label = np.eye(n_classes, dtype=np.float32)[
        np.repeat(np.arange(n_row), n_row) % n_classes
    ]
    z_random = rng.normal(0, 1, (n, latent_dim)).astype(np.float32)
    zeros_z = np.zeros((n, latent_dim), np.float32)
    zeros_c = np.zeros((n, code_dim), np.float32)

    static = apply_g(z_random, static_label, zeros_c)
    save_image(np.asarray(static), f"{out_dir}/static/{batches_done}.png", nrow=n_row)
    save_image(np.asarray(real_img), f"{out_dir}/original/{batches_done}.png", nrow=n_row)
    save_image(np.asarray(scaled_img), f"{out_dir}/scaled/{batches_done}.png", nrow=n_row)

    ramp = np.tile(np.linspace(-2, 2, n_row), n_row).astype(np.float32)
    for k in range(code_dim):
        c = _sweep(code_dim, [k], ramp)
        sample = apply_g(zeros_z, static_label, c)
        save_image(
            np.asarray(sample), f"{out_dir}/varying_c{k+1}/{batches_done}.png", nrow=n_row
        )


def mnist_inference_grids(apply_g, out_dir, batches_done=0, n_row=10):
    """MNIST/generate_image.py:98-141: negated column ramp; c2 sweep
    varies code dims 1 and 2 jointly."""
    n = n_row * n_row
    static_label = np.eye(10, dtype=np.float32)[
        np.repeat(np.arange(n_row), n_row) % 10
    ]
    zeros_z = np.zeros((n, 62), np.float32)
    ramp = -np.tile(np.linspace(-1, 1, n_row), n_row).astype(np.float32)
    sweeps = [[0], [1, 2], [2], [3], [4], [5], [6]]
    for k, dims in enumerate(sweeps):
        c = _sweep(7, dims, ramp)
        sample = apply_g(zeros_z, static_label, c)
        save_image(
            np.asarray(sample), f"{out_dir}/varying_c{k+1}/{batches_done}.png", nrow=n_row
        )


@_traced_grid
def celeba_training_grids(
    apply_g, real_img, scaled_img, out_dir, batches_done, n_row=10,
    latent_dim=200, n_classes=10, code_dim=8,
):
    """celebA/EAD-GAN_celebA.py:233-285: static + original + scaled +
    varying_c1..c8 with a row-wise ramp."""
    rng = np.random.default_rng(batches_done)
    n = n_row * n_row
    static_label = np.eye(n_classes, dtype=np.float32)[
        np.tile(np.arange(n_row), n_row) % n_classes
    ]
    z_random = rng.normal(0, 1, (n, latent_dim)).astype(np.float32)
    zeros_z = np.zeros((n, latent_dim), np.float32)
    zeros_c = np.zeros((n, code_dim), np.float32)

    static = apply_g(z_random, static_label, zeros_c)
    save_image(np.asarray(static), f"{out_dir}/static/{batches_done}.png", nrow=n_row)
    save_image(np.asarray(real_img), f"{out_dir}/original/{batches_done}.png", nrow=n_row)
    save_image(np.asarray(scaled_img), f"{out_dir}/scaled/{batches_done}.png", nrow=n_row)

    ramp = np.repeat(np.linspace(-1, 1, n_row), n_row).astype(np.float32)
    for k in range(code_dim):
        c = _sweep(code_dim, [k], ramp)
        sample = apply_g(zeros_z, static_label, c)
        save_image(
            np.asarray(sample), f"{out_dir}/varying_c{k+1}/{batches_done}.png", nrow=n_row
        )


def celeba_inference_grids(apply_g, out_dir, batches_done=0, n_row=10):
    """celebA/gen_imgs.py:157-198: row-wise ramp; c2 varies dims 1+2 and
    c4 varies dims 3+4 jointly."""
    n = n_row * n_row
    static_label = np.eye(10, dtype=np.float32)[np.tile(np.arange(n_row), n_row) % 10]
    zeros_z = np.zeros((n, 200), np.float32)
    ramp = np.repeat(np.linspace(-1.0, 1.0, n_row), n_row).astype(np.float32)
    sweeps = [[0], [1, 2], [2], [3, 4], [4], [5], [6], [7]]
    for k, dims in enumerate(sweeps):
        c = _sweep(8, dims, ramp)
        sample = apply_g(zeros_z, static_label, c)
        save_image(
            np.asarray(sample), f"{out_dir}/varying_c{k+1}/{batches_done}.png", nrow=n_row
        )


@_traced_grid
def sprites_training_grids(
    apply_g, align_img, trans_img, out_dir, batches_done, code_dim=4, n_cols=10
):
    """dSprites/rp.py:293-353 (colored the same with code_dim=7):
    original + trans grids rescaled to [-1, 1], then 7 sweeps over a
    70-row label pattern [0,1,2,0,1,2,0]; sweeps 5-7 repeat the code-0
    sweep (a reference quirk, rp.py:319-321)."""
    save_image(
        (np.asarray(align_img) - 0.5) * 2, f"{out_dir}/original/{batches_done}.png", nrow=n_cols
    )
    save_image(
        (np.asarray(trans_img) - 0.5) * 2, f"{out_dir}/trans/{batches_done}.png", nrow=n_cols
    )

    labels = np.repeat(np.array([0, 1, 2, 0, 1, 2, 0]), n_cols)
    onehot = np.eye(3, dtype=np.float32)[labels]
    ramp = np.tile(np.linspace(-1, 1, n_cols), 7).astype(np.float32)
    sweep_dims = [[0], [1], [2], [3], [0], [0], [0]]
    for k, dims in enumerate(sweep_dims):
        dims = [d for d in dims if d < code_dim]
        c = _sweep(code_dim, dims, ramp)
        z_c = np.concatenate([onehot, c], axis=-1)
        sample = (np.asarray(apply_g(z_c)) - 0.5) * 2
        save_image(sample, f"{out_dir}/varying_c{k+1}/{batches_done}.png", nrow=n_cols)


def pxy_grids(real_img, align_img, out_dir, batches_done, n_row=10):
    """dSprites/pxy.py:130-148: original + aligned grids in [-1, 1]."""
    save_image(
        (np.asarray(real_img) - 0.5) * 2, f"{out_dir}/original/{batches_done}.png", nrow=n_row
    )
    save_image(
        (np.asarray(align_img) - 0.5) * 2, f"{out_dir}/align/{batches_done}.png", nrow=n_row
    )
