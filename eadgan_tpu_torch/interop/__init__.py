"""Weight interop with the JAX package."""

from eadgan_tpu_torch.interop.from_jax import (
    approximator_from_flax,
    celeba_discriminator_from_flax,
    celeba_generator_from_flax,
    mnist_discriminator_from_flax,
    mnist_encoder_from_flax,
    mnist_generator_from_flax,
    sprites_discriminator_from_flax,
    sprites_encoder_from_flax,
    sprites_encoder_pxy_from_flax,
    sprites_generator_from_flax,
)

__all__ = [
    "celeba_generator_from_flax",
    "celeba_discriminator_from_flax",
    "sprites_encoder_pxy_from_flax",
    "sprites_generator_from_flax",
    "sprites_discriminator_from_flax",
    "sprites_encoder_from_flax",
    "mnist_generator_from_flax",
    "mnist_discriminator_from_flax",
    "mnist_encoder_from_flax",
    "approximator_from_flax",
]
