"""Neural affine regularizer for the rpqmnxy family.

PyTorch counterpart of ``eadgan_tpu/transforms/neural.py``.  The full
rotation + anisotropic zoom + skew + translation composition has no
closed-form least-squares inverse, so the MNIST pipeline trains an MLP
(``models/approximator.py``) to invert flattened 2x3 matrices and applies
it, frozen, inside the info loss.
"""

from __future__ import annotations

import torch

from eadgan_tpu_torch.transforms.affine import (
    RPQMNXY,
    AffineFamily,
    code_to_matrix,
    compose_relative,
    params_to_code,
)

__all__ = ["flatten_matrix_2x3", "regularize_neural"]


def flatten_matrix_2x3(matrix: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) -> (B, 6): rows 0 and 1 concatenated."""
    return torch.cat([matrix[:, 0, :], matrix[:, 1, :]], dim=-1)


def regularize_neural(
    approximator,
    real_code: torch.Tensor,
    trans_code: torch.Tensor,
    family: AffineFamily = RPQMNXY,
) -> torch.Tensor:
    """The relative latent code between two coded transforms, recovered by
    the approximator: both matrices from the codes, ``trans @ real^-1``,
    flattened, through the MLP (which emits physical parameters), then
    unscaled to code units.  ``approximator`` is the model; gradients
    flow through it to the codes (freeze its parameters to keep it
    fixed)."""
    real_matrix = code_to_matrix(family, real_code[..., : family.n_affine])
    trans_matrix = code_to_matrix(family, trans_code[..., : family.n_affine])
    rel = compose_relative(real_matrix, trans_matrix)
    return params_to_code(family, approximator(flatten_matrix_2x3(rel)))
