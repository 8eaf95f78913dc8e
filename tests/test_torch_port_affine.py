"""Port affine code algebra vs ``eadgan_tpu.transforms.affine``.

Every function, all four families, on the same numpy codes.  Tolerance
atol 1e-5 (float32 on both sides; the JAX side pins HIGHEST precision
for its 3x3 products, the port expands them elementwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.transforms import affine as ja
from eadgan_tpu_torch.transforms import affine as ta

FAMILIES = ["pxy", "rp", "rpqxy", "rpqmnxy"]
CLOSED_FORM = ["pxy", "rp", "rpqxy"]
ATOL = 1e-5


def _close(got, ref, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


def _code(rng, family, n=16, width=None):
    return rng.uniform(-1, 1, (n, width or ta.FAMILIES[family].n_affine)).astype(np.float32)


def _fields(f):
    return {k: getattr(f, k) for k in f.__dataclass_fields__}


def test_families_match():
    assert set(ta.FAMILIES) == set(ja.FAMILIES)
    for name, fam in ta.FAMILIES.items():
        assert _fields(fam) == _fields(ja.FAMILIES[name])


@pytest.mark.parametrize("family", FAMILIES)
def test_code_params_roundtrip(rng, family):
    code = _code(rng, family)
    params = ta.code_to_params(ta.FAMILIES[family], torch.from_numpy(code))
    _close(params, ja.code_to_params(ja.FAMILIES[family], jnp.asarray(code)))
    back = ta.params_to_code(ta.FAMILIES[family], params)
    _close(back, ja.params_to_code(ja.FAMILIES[family], jnp.asarray(params.numpy())))
    _close(back, code)


@pytest.mark.parametrize("family", FAMILIES)
def test_code_to_matrix(rng, family):
    # extra trailing columns are ignored by both sides
    code = _code(rng, family, width=ta.FAMILIES[family].n_affine + 2)
    code = code[:, : ta.FAMILIES[family].n_affine]
    got = ta.code_to_matrix(ta.FAMILIES[family], torch.from_numpy(code))
    _close(got, ja.code_to_matrix(ja.FAMILIES[family], jnp.asarray(code)))


def test_build_affine_matrix_all_components(rng):
    parts = [rng.uniform(-1, 1, 8).astype(np.float32) for _ in range(7)]
    got = ta.build_affine_matrix(*map(torch.from_numpy, parts))
    _close(got, ja.build_affine_matrix(*map(jnp.asarray, parts)))
    got = ta.build_affine_matrix(torch.from_numpy(parts[0]), torch.from_numpy(parts[1]))
    _close(got, ja.build_affine_matrix(jnp.asarray(parts[0]), jnp.asarray(parts[1])))


@pytest.mark.parametrize("family", FAMILIES)
def test_inverse_and_compose(rng, family):
    fam_t = ta.FAMILIES[family]
    a, b = _code(rng, family), _code(rng, family)
    ma = ta.code_to_matrix(fam_t, torch.from_numpy(a))
    mb = ta.code_to_matrix(fam_t, torch.from_numpy(b))
    inv = ta.inverse_affine(ma)
    _close(inv, ja.inverse_affine(jnp.asarray(ma.numpy())))
    eye = torch.eye(3).expand_as(ma)
    _close(ta.compose_relative(ma, ma), eye.numpy())
    rel = ta.compose_relative(ma, mb)
    _close(rel, ja.compose_relative(jnp.asarray(ma.numpy()), jnp.asarray(mb.numpy())))


@pytest.mark.parametrize("family", CLOSED_FORM)
def test_regularize(rng, family):
    fam_t, fam_j = ta.FAMILIES[family], ja.FAMILIES[family]
    real, trans = _code(rng, family, width=8), _code(rng, family, width=8)
    got = ta.regularize(fam_t, torch.from_numpy(real), torch.from_numpy(trans))
    ref = ja.regularize(fam_j, jnp.asarray(real), jnp.asarray(trans))
    _close(got, ref, rtol=1e-5)
    # identity relative transform recovers a zero code
    same = ta.regularize(fam_t, torch.from_numpy(real), torch.from_numpy(real))
    _close(same, np.zeros_like(ref), atol=1e-4)


def test_regularize_matrix_rejects_rpqmnxy(rng):
    rel = torch.eye(3).expand(2, 3, 3)
    with pytest.raises(ValueError):
        ta.regularize_matrix(ta.RPQMNXY, rel)
    with pytest.raises(ValueError):
        ja.regularize_matrix(ja.RPQMNXY, jnp.asarray(rel.numpy()))


def test_pxy_align_matrix(rng):
    code = _code(rng, "pxy", width=6)
    _close(ta.pxy_align_matrix(torch.from_numpy(code)), ja.pxy_align_matrix(jnp.asarray(code)))


def test_split_code_too_narrow():
    with pytest.raises(ValueError):
        ta.code_to_params(ta.RPQXY, torch.zeros(2, 4))


@pytest.mark.parametrize(
    "b", [0.0, -0.0, 1e-7, -1e-7, 5e-7, -9.99e-7, 1e-6, -1e-6, 2.0, -3.0]
)
def test_safe_div(b):
    a = np.array([1.0, -2.5], np.float32)
    bb = np.full(2, b, np.float32)
    got = ta._safe_div(torch.from_numpy(a), torch.from_numpy(bb))
    ref = ja._safe_div(jnp.asarray(a), jnp.asarray(bb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert np.all(np.isfinite(got.numpy()))


def test_inverse_affine_degenerate_det_stays_finite():
    """det ~ 0 (a predicted code can collapse a zoom) gives a finite,
    guarded inverse equal to the JAX package's."""
    m = np.array(
        [
            [[1.0, 2.0, 0.3], [0.5, 1.0, -0.2], [0.0, 0.0, 1.0]],  # det = 0
            [[1e-4, 0.0, 0.1], [0.0, 1e-4, 0.1], [0.0, 0.0, 1.0]],  # det = 1e-8
            [[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
        ],
        np.float32,
    )
    got = ta.inverse_affine(torch.from_numpy(m))
    ref = ja.inverse_affine(jnp.asarray(m))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_regularize_degenerate_prediction_finite():
    """A predicted code that zeroes the zoom (p = q = 0: code -5) keeps
    the regularizer finite in both packages, with the same values."""
    real = np.array([[0.1, -5.0, -5.0, 0.2, 0.3]], np.float32)
    trans = np.array([[0.3, 0.2, 0.1, -0.2, 0.4]], np.float32)
    got = ta.regularize(ta.RPQXY, torch.from_numpy(real), torch.from_numpy(trans))
    ref = ja.regularize(ja.RPQXY, jnp.asarray(real), jnp.asarray(trans))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4)


def test_regularize_gradients_match(rng):
    """The affine loss is differentiated through in the info phase."""
    real, trans = _code(rng, "rpqxy", n=4), _code(rng, "rpqxy", n=4)
    target = _code(rng, "rpqxy", n=4)

    def jloss(r, t):
        return jnp.mean((ja.regularize(ja.RPQXY, r, t) - target) ** 2)

    jr, jt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(real), jnp.asarray(trans))
    r = torch.from_numpy(real).requires_grad_(True)
    t = torch.from_numpy(trans).requires_grad_(True)
    torch.mean((ta.regularize(ta.RPQXY, r, t) - torch.from_numpy(target)) ** 2).backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-5)
