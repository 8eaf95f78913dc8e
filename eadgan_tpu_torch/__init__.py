"""PyTorch/CUDA port of ``eadgan_tpu`` for NVIDIA Hopper (H100).

The JAX package beside it is the reference each module is held against.
Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"``, or ``EADGAN_PLATFORM=cpu`` for the command-line
entry points).  Hand-written kernels live in ``csrc/`` and are built
with ``nvcc`` at first use into ``_build/``.
"""
