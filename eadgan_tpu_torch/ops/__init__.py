"""Device ops: the affine warp and its CUDA kernel."""

from eadgan_tpu_torch.ops.stn import affine_grid, grid_sample, warp_affine, warp_affine_plain

__all__ = ["affine_grid", "grid_sample", "warp_affine", "warp_affine_plain"]
