"""Affine code algebra: latent code <-> physical parameters <-> 3x3 matrices.

PyTorch counterpart of ``eadgan_tpu/transforms/affine.py``; the family
factors, the composition order R(theta) @ Z(p, q) @ S(m, n) @ T(x, y) and
the closed-form recoveries are the same.

Precision: every 3x3 product here is expanded by hand into elementwise
multiplies and sums (:func:`_matmul3`), so it runs in full float32 on
any device whatever ``torch.backends.cuda.matmul.allow_tf32`` says.  The
JAX package pins ``Precision.HIGHEST`` for the same reason: a reduced-
precision pass loses ~1e-2 here, which the code unscaling amplifies 10x.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

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
]


@dataclasses.dataclass(frozen=True)
class AffineFamily:
    """Static description of one affine code parameterization."""

    name: str
    n_affine: int
    has_rotation: bool
    anisotropic: bool
    has_skew: bool
    r_factor: float = 9.0
    pq_factor: float = 0.2
    mn_factor: float = 0.2
    xy_factor: float = 0.1


PXY = AffineFamily(
    name="pxy", n_affine=3, has_rotation=False, anisotropic=False,
    has_skew=False, pq_factor=0.1, xy_factor=0.1,
)
RP = AffineFamily(
    name="rp", n_affine=4, has_rotation=True, anisotropic=False,
    has_skew=False, pq_factor=0.2, xy_factor=0.1,
)
RPQXY = AffineFamily(
    name="rpqxy", n_affine=5, has_rotation=True, anisotropic=True,
    has_skew=False, pq_factor=0.2, xy_factor=0.1,
)
RPQMNXY = AffineFamily(
    name="rpqmnxy", n_affine=7, has_rotation=True, anisotropic=True,
    has_skew=True, pq_factor=0.2, mn_factor=0.2, xy_factor=0.1,
)

FAMILIES = {f.name: f for f in (PXY, RP, RPQXY, RPQMNXY)}


def _split_code(family: AffineFamily, code: torch.Tensor):
    """Split a (B, n_affine) code into named components, filling defaults."""
    if code.shape[-1] < family.n_affine:
        raise ValueError(
            f"family {family.name!r} expects at least {family.n_affine} code "
            f"columns, got {code.shape[-1]}"
        )
    cols = iter(range(code.shape[-1]))
    zero = torch.zeros_like(code[..., 0])
    theta_c = code[..., next(cols)] if family.has_rotation else zero
    p_c = code[..., next(cols)]
    q_c = code[..., next(cols)] if family.anisotropic else p_c
    m_c = code[..., next(cols)] if family.has_skew else zero
    n_c = code[..., next(cols)] if family.has_skew else zero
    x_c = code[..., next(cols)]
    y_c = code[..., next(cols)]
    return theta_c, p_c, q_c, m_c, n_c, x_c, y_c


def code_to_params(family: AffineFamily, code: torch.Tensor) -> torch.Tensor:
    """Latent code in [-1,1] -> physical affine parameters:
    theta = c * pi / r_factor, p/q = c * pq_factor + 1,
    m/n = c * mn_factor, x/y = c * xy_factor."""
    theta_c, p_c, q_c, m_c, n_c, x_c, y_c = _split_code(family, code)
    out = [p_c * family.pq_factor + 1.0]
    if family.has_rotation:
        out.insert(0, theta_c * (math.pi / family.r_factor))
    if family.anisotropic:
        out.append(q_c * family.pq_factor + 1.0)
    if family.has_skew:
        out.append(m_c * family.mn_factor)
        out.append(n_c * family.mn_factor)
    out.append(x_c * family.xy_factor)
    out.append(y_c * family.xy_factor)
    return torch.stack(out, dim=-1)


def params_to_code(family: AffineFamily, params: torch.Tensor) -> torch.Tensor:
    """Physical affine parameters -> latent code; inverse of
    :func:`code_to_params`."""
    cols = iter(range(params.shape[-1]))
    out = []
    if family.has_rotation:
        out.append(params[..., next(cols)] * (family.r_factor / math.pi))
    out.append((params[..., next(cols)] - 1.0) / family.pq_factor)
    if family.anisotropic:
        out.append((params[..., next(cols)] - 1.0) / family.pq_factor)
    if family.has_skew:
        out.append(params[..., next(cols)] / family.mn_factor)
        out.append(params[..., next(cols)] / family.mn_factor)
    out.append(params[..., next(cols)] / family.xy_factor)
    out.append(params[..., next(cols)] / family.xy_factor)
    return torch.stack(out, dim=-1)


def _rows(row0, row1, row2) -> torch.Tensor:
    return torch.stack(
        [torch.stack(row0, dim=-1), torch.stack(row1, dim=-1), torch.stack(row2, dim=-1)],
        dim=-2,
    )


def build_affine_matrix(
    theta: torch.Tensor,
    p: torch.Tensor,
    q: Optional[torch.Tensor] = None,
    m: Optional[torch.Tensor] = None,
    n: Optional[torch.Tensor] = None,
    x: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Compose R(theta) @ Z(p, q) @ S(m, n) @ T(x, y) analytically.

    With c = cos(theta), s = sin(theta) the product expands to::

        [[c*p - s*q*n,  c*p*m - s*q,  a00*x + a01*y],
         [s*p + c*q*n,  s*p*m + c*q,  a10*x + a11*y],
         [0,            0,            1            ]]

    Returns a (B, 3, 3) batch.
    """
    q = p if q is None else q
    zero = torch.zeros_like(p)
    m = zero if m is None else m
    n = zero if n is None else n
    x = zero if x is None else x
    y = zero if y is None else y

    c = torch.cos(theta)
    s = torch.sin(theta)
    a00 = c * p - s * q * n
    a01 = c * p * m - s * q
    a10 = s * p + c * q * n
    a11 = s * p * m + c * q
    tx = a00 * x + a01 * y
    ty = a10 * x + a11 * y
    one = torch.ones_like(p)
    return _rows((a00, a01, tx), (a10, a11, ty), (zero, zero, one))


def code_to_matrix(family: AffineFamily, code: torch.Tensor) -> torch.Tensor:
    """Latent code -> (B, 3, 3) affine matrix."""
    params = code_to_params(family, code)
    # params share the code's column layout (theta in radians)
    theta, p, q, m, n, x, y = _split_code(family, params)
    return build_affine_matrix(theta, p, q, m, n, x, y)


def inverse_affine(matrix: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of affine matrices with last row [0,0,1]:
    for M = [[A, t], [0, 1]], M^-1 = [[A^-1, -A^-1 t], [0, 1]] with the
    2x2 adjugate inverse and a guarded determinant (see :func:`_safe_div`)."""
    a00 = matrix[..., 0, 0]
    a01 = matrix[..., 0, 1]
    a10 = matrix[..., 1, 0]
    a11 = matrix[..., 1, 1]
    tx = matrix[..., 0, 2]
    ty = matrix[..., 1, 2]
    det = a00 * a11 - a01 * a10
    inv_det = _safe_div(torch.ones_like(det), det)
    i00 = a11 * inv_det
    i01 = -a01 * inv_det
    i10 = -a10 * inv_det
    i11 = a00 * inv_det
    itx = -(i00 * tx + i01 * ty)
    ity = -(i10 * tx + i11 * ty)
    zero = torch.zeros_like(a00)
    one = torch.ones_like(a00)
    return _rows((i00, i01, itx), (i10, i11, ity), (zero, zero, one))


def _matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3) as elementwise products and a sum:
    full float32 on every device, never a TF32 matrix unit."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def compose_relative(real_matrix: torch.Tensor, trans_matrix: torch.Tensor) -> torch.Tensor:
    """Relative transform ``trans @ real^-1``."""
    return _matmul3(trans_matrix, inverse_affine(real_matrix))


_RECOVERY_EPS = 1e-6


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a / b with the denominator nudged away from zero.

    The closed-form recoveries divide by terms that come from *predicted*
    (unbounded) codes during training; |b| < eps is replaced by +-eps (the
    sign of b, +eps at b == 0).  In the normal regime |b| ~ 1 >> eps, so
    values equal the plain division.
    """
    eps = torch.full_like(b, _RECOVERY_EPS)
    guarded = torch.where(
        b.abs() < _RECOVERY_EPS, torch.where(b < 0, -eps, eps), b
    )
    return a / guarded


def _matrix_to_params_pxy(rel: torch.Tensor) -> torch.Tensor:
    """Closed-form (p, x, y) recovery."""
    p = (rel[..., 0, 0] + rel[..., 1, 1]) / 2.0
    x = _safe_div(rel[..., 0, 2], p)
    y = _safe_div(rel[..., 1, 2], p)
    return torch.stack([p, x, y], dim=-1)


def _matrix_to_params_rp(rel: torch.Tensor) -> torch.Tensor:
    """Closed-form (theta, p, x, y) recovery via least squares."""
    m00, m01 = rel[..., 0, 0], rel[..., 0, 1]
    m10, m11 = rel[..., 1, 0], rel[..., 1, 1]
    m02, m12 = rel[..., 0, 2], rel[..., 1, 2]
    theta = torch.atan(_safe_div(m10 - m01, m00 + m11))
    ct, st = torch.cos(theta), torch.sin(theta)
    p = 0.5 * (ct * (m00 + m11) + st * (m10 - m01))
    x = _safe_div(m02 * ct + m12 * st, p)
    y = _safe_div(m12 * ct - m02 * st, p)
    return torch.stack([theta, p, x, y], dim=-1)


def _matrix_to_params_rpqxy(rel: torch.Tensor) -> torch.Tensor:
    """Closed-form (theta, p, q, x, y) recovery for the anisotropic-zoom
    family."""
    m00, m01 = rel[..., 0, 0], rel[..., 0, 1]
    m10, m11 = rel[..., 1, 0], rel[..., 1, 1]
    m02, m12 = rel[..., 0, 2], rel[..., 1, 2]
    num = m00 * m10 - m01 * m11
    den = m00**2 + m11**2 - m01**2 - m10**2
    theta = 0.5 * torch.atan(_safe_div(2.0 * num, den))
    ct, st = torch.cos(theta), torch.sin(theta)
    p = m00 * ct + m10 * st
    q = -m01 * st + m11 * ct
    x = _safe_div(m02 * ct + m12 * st, p)
    y = _safe_div(m12 * ct - m02 * st, q)
    return torch.stack([theta, p, q, x, y], dim=-1)


_CLOSED_FORM = {
    "pxy": _matrix_to_params_pxy,
    "rp": _matrix_to_params_rp,
    "rpqxy": _matrix_to_params_rpqxy,
}


def regularize_matrix(family: AffineFamily, rel: torch.Tensor) -> torch.Tensor:
    """Recover physical parameters from a relative affine matrix."""
    try:
        fn = _CLOSED_FORM[family.name]
    except KeyError:
        raise ValueError(
            f"family {family.name!r} has no closed-form recovery: use "
            "transforms.neural.regularize_neural with a trained approximator"
        ) from None
    return fn(rel)


def regularize(
    family: AffineFamily, real_code: torch.Tensor, trans_code: torch.Tensor
) -> torch.Tensor:
    """Affine-consistency regularizer: recover the *relative* latent code
    between two coded transforms.  Builds both matrices, composes
    ``trans @ real^-1``, recovers parameters with the family's closed form
    and unscales back to code units.  Only the first ``family.n_affine``
    columns of each code are used."""
    real_matrix = code_to_matrix(family, real_code[..., : family.n_affine])
    trans_matrix = code_to_matrix(family, trans_code[..., : family.n_affine])
    rel = compose_relative(real_matrix, trans_matrix)
    return params_to_code(family, regularize_matrix(family, rel))


def pxy_align_matrix(code: torch.Tensor) -> torch.Tensor:
    """Translation-only alignment matrix T(x, y) from a pxy code (the
    reference drops the zoom when aligning)."""
    params = code_to_params(PXY, code[..., :3])
    zero = torch.zeros_like(params[..., 0])
    one = torch.ones_like(zero)
    x = params[..., 1]
    y = params[..., 2]
    return _rows((one, zero, x), (zero, one, y), (zero, zero, one))
