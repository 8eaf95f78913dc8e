"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without a CUDA card these tests skip (the
decision is taken inside the fixture, never at import).  On the card:
``python -m pytest -m cuda tests/test_torch_port_cuda.py``.

Tolerances: float32 2e-5 (nvcc contracts multiply-adds into FMA, so a
coordinate can land an ulp apart and pick the neighbouring texel's
weights; bilinear output is continuous, so the error stays ~1e-6), bf16
1e-2 (one bf16 rounding of the output, against the plain version on the
same bf16 input).
"""

import pytest
import torch

from eadgan_tpu_torch.ops import stn_cuda, warp_affine, warp_affine_plain
from eadgan_tpu_torch.transforms import RP, RPQMNXY, RPQXY, code_to_matrix

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = [
    ((4, 64, 64, 1), RP, 1.0),
    ((4, 64, 64, 3), RP, 1.0),
    ((2, 32, 64, 3), RP, 1.0),
    ((2, 17, 16, 1), RP, 1.0),
    ((2, 16, 16, 1), RPQMNXY, 3.0),
    ((6, 64, 64, 1), RP, 1.0),
    ((128, 64, 64, 3), RPQXY, 1.0),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("shape,family,scale", CASES)
def test_warp_kernel_matches_plain(cuda, shape, family, scale, pad, dtype, tol):
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(shape, generator=gen).to(cuda, dtype)
    code = (torch.rand(shape[0], family.n_affine, generator=gen) * 2 - 1) * scale
    matrix = code_to_matrix(family, code.to(cuda))
    before = stn_cuda.launch_count
    got = warp_affine(img, matrix, pad)
    assert stn_cuda.launch_count == before + 1
    ref = warp_affine_plain(img, matrix, pad)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_warp_kernel_rejects_non_contiguous(cuda):
    img = torch.rand(2, 3, 16, 16, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        stn_cuda.warp_affine_cuda(img, torch.eye(3, device=cuda).expand(2, 3, 3))
