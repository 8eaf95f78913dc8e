"""Port colour-code algebra vs ``eadgan_tpu.transforms.color``.

Same numpy inputs through both packages, float32 on the CPU.  Tolerance
1e-6 relative and absolute: the functions are a few elementwise float32
operations on each side, in the same order.  The regularizer is checked
where its guard acts (real gains within 1e-6 of zero, and exactly zero)
and the alignment's gain floor where it acts (|gain| < 1e-2, both signs
and zero), with inputs placed so the floor changes the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eadgan_tpu.transforms import color as jax_color
from eadgan_tpu_torch.transforms import (
    apply_color,
    color_code_to_gain,
    gain_to_color_code,
    regularize_color,
    remove_color,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(fn_port, fn_jax, *arrays, **kw):
    got = fn_port(*map(torch.from_numpy, arrays), **kw).numpy()
    ref = np.asarray(fn_jax(*map(jnp.asarray, arrays), **kw))
    return got, ref


@pytest.mark.parametrize("rgb_factor", [0.1, 0.5])
def test_gain_code_round_trip_matches_jax(rng, rgb_factor):
    code = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    got, ref = _both(color_code_to_gain, jax_color.color_code_to_gain, code, rgb_factor=rgb_factor)
    np.testing.assert_allclose(got, ref, **TOL)
    back, ref_back = _both(gain_to_color_code, jax_color.gain_to_color_code, got, rgb_factor=rgb_factor)
    np.testing.assert_allclose(back, ref_back, **TOL)
    np.testing.assert_allclose(back, code, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rgb_factor", [0.1, 0.5])
def test_regularize_color_matches_jax(rng, rgb_factor):
    real = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    trans = rng.uniform(-1, 1, (32, 3)).astype(np.float32)
    # real gains at 0, just above and below it (the guarded ratio)
    zero_code = np.float32(-1.0 / rgb_factor)
    real[0] = zero_code
    real[1] = zero_code + np.float32(1e-7 / rgb_factor)
    real[2] = zero_code - np.float32(1e-7 / rgb_factor)
    got, ref = _both(regularize_color, jax_color.regularize_color, real, trans, rgb_factor=rgb_factor)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, **TOL)
    # the relative code composes: gain(real) * gain(rel) = gain(trans)
    rel = torch.from_numpy(got[3:])
    composed = color_code_to_gain(torch.from_numpy(real[3:]), rgb_factor) * color_code_to_gain(rel, rgb_factor)
    np.testing.assert_allclose(
        composed.numpy(), color_code_to_gain(torch.from_numpy(trans[3:]), rgb_factor).numpy(),
        rtol=1e-5, atol=1e-5,
    )


def test_apply_and_remove_color_match_jax(rng):
    img = rng.uniform(0, 1, (4, 8, 8, 3)).astype(np.float32)
    gain = rng.uniform(0.4, 1.6, (4, 3)).astype(np.float32)
    tinted, ref = _both(apply_color, jax_color.apply_color, img, gain)
    np.testing.assert_allclose(tinted, ref, **TOL)
    back, ref_back = _both(remove_color, jax_color.remove_color, tinted, gain)
    np.testing.assert_allclose(back, ref_back, **TOL)
    np.testing.assert_allclose(back, img, rtol=1e-5, atol=1e-6)


def test_remove_color_gain_floor_matches_jax(rng):
    """|gain| below 1e-2 divides by +-1e-2 (the sign kept, + at zero):
    the aligned image stays finite and at most 100x the input."""
    img = rng.uniform(0, 1, (2, 4, 4, 3)).astype(np.float32)
    gain = np.array([[0.0, 1e-3, -1e-3], [5e-3, -0.5, 1e-2]], np.float32)
    got, ref = _both(remove_color, jax_color.remove_color, img, gain)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, ref, **TOL)
    floored = np.array([[1e-2, 1e-2, -1e-2], [1e-2, -0.5, 1e-2]], np.float32)
    np.testing.assert_allclose(got, img / floored[:, None, None, :], **TOL)
    assert np.abs(got).max() <= 100 * img.max() * (1 + 1e-6)
