"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit), the table every
roofline share and ``mfu`` metric is taken against."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12

# a configuration's ``compute`` -> the peak of its convolutions
COMPUTE_PEAK = {"bf16": BF16_TENSOR_FLOPS_PER_S, "f32": F32_FLOPS_PER_S}


def bound_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the bytes at the
    memory rate and the operations at ``ops_per_s``."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)
