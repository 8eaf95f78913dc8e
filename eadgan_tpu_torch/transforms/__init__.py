"""Affine and colour code algebra (PyTorch counterpart of
``eadgan_tpu.transforms``)."""

from eadgan_tpu_torch.transforms.affine import (
    FAMILIES,
    PXY,
    RP,
    RPQMNXY,
    RPQXY,
    AffineFamily,
    build_affine_matrix,
    code_to_matrix,
    code_to_params,
    compose_relative,
    inverse_affine,
    params_to_code,
    pxy_align_matrix,
    regularize,
    regularize_matrix,
)
from eadgan_tpu_torch.transforms.color import (
    apply_color,
    color_code_to_gain,
    gain_to_color_code,
    regularize_color,
    remove_color,
)
from eadgan_tpu_torch.transforms.neural import flatten_matrix_2x3, regularize_neural

__all__ = [
    "AffineFamily",
    "PXY",
    "RP",
    "RPQXY",
    "RPQMNXY",
    "FAMILIES",
    "code_to_params",
    "params_to_code",
    "build_affine_matrix",
    "code_to_matrix",
    "inverse_affine",
    "compose_relative",
    "regularize_matrix",
    "regularize",
    "pxy_align_matrix",
    "color_code_to_gain",
    "gain_to_color_code",
    "regularize_color",
    "apply_color",
    "remove_color",
    "flatten_matrix_2x3",
    "regularize_neural",
]
