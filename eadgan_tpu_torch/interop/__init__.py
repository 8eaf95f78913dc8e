"""Weight interop: the reference's PyTorch checkpoints in both directions
(``torch_import``, ``torch_export``), and the JAX package's files both
ways: its flax variables (``from_jax``, ``to_jax``), train states
(``jax_state``) and msgpack format (``flax_msgpack``)."""

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
from eadgan_tpu_torch.interop.torch_export import export_state_dict, save_torch_state_dict
from eadgan_tpu_torch.interop.torch_import import (
    import_approximator,
    import_celeba_discriminator,
    import_celeba_generator,
    import_mnist_discriminator,
    import_mnist_encoder,
    import_mnist_generator,
    import_sprites_discriminator,
    import_sprites_encoder,
    import_sprites_encoder_pxy,
    import_sprites_generator,
    load_torch_state_dict,
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
    "import_approximator",
    "import_mnist_generator",
    "import_mnist_encoder",
    "import_mnist_discriminator",
    "import_sprites_encoder_pxy",
    "import_sprites_generator",
    "import_sprites_discriminator",
    "import_sprites_encoder",
    "import_celeba_generator",
    "import_celeba_discriminator",
    "load_torch_state_dict",
    "export_state_dict",
    "save_torch_state_dict",
]
