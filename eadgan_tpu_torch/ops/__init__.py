"""Device ops: the affine warp and the fused conv + LeakyReLU, each with
its CUDA kernel."""

from eadgan_tpu_torch.ops.fused_conv import fused_conv_lrelu, fused_conv_lrelu_plain
from eadgan_tpu_torch.ops.stn import affine_grid, grid_sample, warp_affine, warp_affine_plain

__all__ = [
    "affine_grid",
    "grid_sample",
    "warp_affine",
    "warp_affine_plain",
    "fused_conv_lrelu",
    "fused_conv_lrelu_plain",
]
