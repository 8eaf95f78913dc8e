"""Port warp (plain version) vs the JAX package's warp.

The port's ``warp_affine`` on CPU tensors runs ``warp_affine_plain``; it
is held against ``eadgan_tpu.ops.warp_affine(impl="xla")`` and against
the Pallas kernel ``warp_affine_pallas`` in interpret mode, over the
cases of ``tests/test_stn_pallas.py``.  Tolerance atol 2e-5, the bar the
Pallas kernel itself meets against the XLA path (float32 coordinates may
land an ulp apart and pick the neighbouring texel's weights).

The CUDA kernel is held against this plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eadgan_tpu.ops import warp_affine as jax_warp
from eadgan_tpu.ops.stn_pallas import warp_affine_pallas
from eadgan_tpu.transforms import RP, RPQMNXY, code_to_matrix
from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.ops import warp_affine, warp_affine_plain

ATOL = 2e-5

# (shape, family, code scale, padding modes) — the test_stn_pallas.py cases
CASES = {
    "c1": ((4, 64, 64, 1), RP, 1.0, ("border", "zeros")),
    "c3": ((4, 64, 64, 3), RP, 1.0, ("border", "zeros")),
    "extreme": ((2, 16, 16, 1), RPQMNXY, 3.0, ("border", "zeros")),
    "non_square": ((2, 32, 64, 3), RP, 1.0, ("border", "zeros")),
    "odd_height": ((2, 17, 16, 1), RP, 1.0, ("border",)),
    "even_n_pair": ((6, 64, 64, 1), RP, 1.0, ("border",)),
}
PARAMS = [
    pytest.param(name, pad, id=f"{name}-{pad}")
    for name, (_, _, _, pads) in CASES.items()
    for pad in pads
]


def _inputs(rng, name):
    shape, family, scale, _ = CASES[name]
    img = rng.uniform(0, 1, shape).astype(np.float32)
    code = (rng.uniform(-1, 1, (shape[0], family.n_affine)) * scale).astype(np.float32)
    matrix = np.array(code_to_matrix(family, jnp.asarray(code)))  # writable copy
    return img, matrix


@pytest.mark.parametrize("name,pad", PARAMS)
def test_plain_matches_jax_xla(rng, name, pad):
    img, matrix = _inputs(rng, name)
    ref = jax_warp(jnp.asarray(img), jnp.asarray(matrix), padding_mode=pad, impl="xla")
    got = warp_affine(torch.from_numpy(img), torch.from_numpy(matrix), pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name,pad", PARAMS)
def test_plain_matches_pallas_interpret(rng, name, pad):
    img, matrix = _inputs(rng, name)
    ref = warp_affine_pallas(jnp.asarray(img), jnp.asarray(matrix), pad)
    got = warp_affine(torch.from_numpy(img), torch.from_numpy(matrix), pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("pad", ["border", "zeros"])
def test_plain_matches_torch_grid_sample(rng, pad):
    """The function torch's own affine_grid + grid_sample compute
    (align_corners=False), on the NCHW view."""
    img, matrix = _inputs(rng, "c3")
    x = torch.from_numpy(img)
    theta = torch.from_numpy(matrix)[:, :2]
    grid = F.affine_grid(theta, (4, 3, 64, 64), align_corners=False)
    ref = F.grid_sample(x.permute(0, 3, 1, 2), grid, padding_mode=pad, align_corners=False)
    got = warp_affine(x, torch.from_numpy(matrix), pad)
    np.testing.assert_allclose(got.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=ATOL)


def test_two_by_three_matrix_and_bf16(rng):
    img, matrix = _inputs(rng, "c3")
    full = warp_affine(torch.from_numpy(img), torch.from_numpy(matrix))
    top = warp_affine(torch.from_numpy(img), torch.from_numpy(matrix[:, :2]))
    torch.testing.assert_close(top, full, rtol=0, atol=0)
    out = warp_affine(torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(matrix))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), full.numpy(), atol=1e-2)


def test_gradients_match_jax(rng):
    img = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    code = rng.uniform(-1, 1, (2, 4)).astype(np.float32)

    def jloss(i, c):
        return jnp.sum(jax_warp(i, code_to_matrix(RP, c), impl="xla") ** 2)

    g_img, g_code = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(img), jnp.asarray(code))

    from eadgan_tpu_torch.transforms import RP as TRP
    from eadgan_tpu_torch.transforms import code_to_matrix as t_code_to_matrix

    ti = torch.from_numpy(img).requires_grad_(True)
    tc = torch.from_numpy(code).requires_grad_(True)
    torch.sum(warp_affine(ti, t_code_to_matrix(TRP, tc)) ** 2).backward()
    np.testing.assert_allclose(ti.grad.numpy(), np.asarray(g_img), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(g_code), rtol=1e-4, atol=1e-5)


def test_cpu_tensor_takes_plain_path(rng):
    """A CPU tensor never reaches the kernel: the launch count stays put
    and the result is the plain version's, bit for bit."""
    img, matrix = _inputs(rng, "c3")
    before = stn_cuda.launch_count
    got = warp_affine(torch.from_numpy(img), torch.from_numpy(matrix), "zeros")
    assert stn_cuda.launch_count == before
    ref = warp_affine_plain(torch.from_numpy(img), torch.from_numpy(matrix), "zeros")
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(rng):
    img, matrix = _inputs(rng, "c3")
    x, m = torch.from_numpy(img), torch.from_numpy(matrix)
    with pytest.raises(ValueError, match="CUDA tensor"):
        stn_cuda.warp_affine_cuda(x, m)
    with pytest.raises(ValueError, match="padding_mode"):
        stn_cuda.warp_affine_cuda(x, m, "reflection")
    with pytest.raises(ValueError, match="padding_mode"):
        warp_affine(x, m, "reflection")
