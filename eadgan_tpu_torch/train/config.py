"""Per-pipeline configuration dataclasses.

Flag names and defaults mirror the reference argparse blocks so the CLI
surface stays drop-in compatible (MNIST/EAD-GAN_rpqmnxy.py:35-48,
dSprites/pxy.py:34-47, dSprites/rp.py:39-52,
colored_dSprites/rp_color.py:39-52, celebA/EAD-GAN_celebA.py:39-52).
Hard-coded values that bypass the reference flags (D learning rates,
loss lambdas, scale factors) are explicit fields with the hard-coded
defaults.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "ApproximatorConfig",
    "PxyConfig",
    "SpritesGanConfig",
    "MnistConfig",
    "CelebaConfig",
]


@dataclasses.dataclass(frozen=True)
class ApproximatorConfig:
    """MNIST/approximate_rpqmnxy.py:111-153."""

    iterations: int = 20001
    batch_size: int = 128
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999


@dataclasses.dataclass(frozen=True)
class PxyConfig:
    """dSprites/pxy.py:34-47 (colored: colored_dSprites/pxy_color.py,
    n_epochs=10, lr 2e-4; code_dim 3 gray / 6 colored)."""

    n_epochs: int = 10
    batch_size: int = 128
    lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    code_dim: int = 3
    img_size: int = 64
    channels: int = 1
    sample_interval: int = 1000
    colored: bool = False
    rgb_factor: float = 0.1  # colored_dSprites/utils_pxy.py:50

    def __post_init__(self):
        expected = 6 if self.colored else 3
        if self.code_dim != expected:
            raise ValueError(
                f"pxy code_dim must be {expected} for colored={self.colored}, "
                f"got {self.code_dim}"
            )

    @classmethod
    def for_dataset(cls, colored: bool, **overrides) -> "PxyConfig":
        """The gray or colored aligner's defaults (code_dim 3 / 6), then
        ``overrides``."""
        return cls(**{"code_dim": 6 if colored else 3, "colored": colored, **overrides})


@dataclasses.dataclass(frozen=True)
class SpritesGanConfig:
    """dSprites/rp.py:39-52 / colored_dSprites/rp_color.py:39-52.

    d_lr is the hard-coded 2e-4 override (dSprites/rp.py:277); the gray
    pipeline keeps lr=1e-4 for G/info, the colored one 2e-4 (:42).
    """

    n_epochs: int = 100
    batch_size: int = 128
    lr: float = 1e-4
    d_lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    code_dim: int = 4
    n_classes: int = 3
    img_size: int = 64
    channels: int = 1
    sample_interval: int = 1000
    colored: bool = False
    rgb_factor: float = 0.5  # GAN-stage color factor (utils_rp_color.py:40)
    align_rgb_factor: float = 0.1  # align-stage factor (utils_pxy.py:50)

    def __post_init__(self):
        expected = 7 if self.colored else 4
        if self.code_dim != expected:
            raise ValueError(
                f"sprites GAN code_dim must be {expected} for "
                f"colored={self.colored}, got {self.code_dim}"
            )
        expected_ch = 3 if self.colored else 1
        if self.channels != expected_ch:
            raise ValueError(
                f"channels must be {expected_ch} for colored={self.colored}, "
                f"got {self.channels}"
            )

    @classmethod
    def for_dataset(cls, colored: bool, **overrides) -> "SpritesGanConfig":
        """The gray or colored step's defaults, then ``overrides``: code_dim
        4 / 7, channels 1 / 3, lr 1e-4 / 2e-4 (dSprites/rp.py:42,
        colored_dSprites/rp_color.py:42); D's rate is the hard-coded 2e-4
        when gray and follows ``lr`` when colored
        (colored_dSprites/rp_color.py:275) unless ``d_lr`` is given."""
        lr = overrides.pop("lr", 2e-4 if colored else 1e-4)
        return cls(**{
            "code_dim": 7 if colored else 4,
            "channels": 3 if colored else 1,
            "lr": lr,
            "d_lr": lr if colored else 2e-4,
            "colored": colored,
            **overrides,
        })


@dataclasses.dataclass(frozen=True)
class MnistConfig:
    """MNIST/EAD-GAN_rpqmnxy.py:35-48 + lambdas :201-203 and the D lr
    doubling :250."""

    n_epochs: int = 200
    batch_size: int = 128
    lr: float = 1e-4
    b1: float = 0.5
    b2: float = 0.999
    latent_dim: int = 62
    code_dim: int = 7
    n_classes: int = 10
    img_size: int = 32
    channels: int = 1
    sample_interval: int = 4000
    lambda_cat: float = 1.0
    lambda_con: float = 0.1
    lambda_affine: float = 0.1

    def __post_init__(self):
        if self.code_dim != 7:
            raise ValueError(
                "MNIST requires code_dim=7: the rpqmnxy affine regularizer "
                f"recovers exactly 7 parameters (got {self.code_dim})"
            )
        if self.img_size % 16 != 0:
            raise ValueError(
                f"img_size must be divisible by 16 (4 stride-2 stages), got {self.img_size}"
            )

    @property
    def d_lr(self) -> float:
        return self.lr * 2.0


@dataclasses.dataclass(frozen=True)
class CelebaConfig:
    """celebA/EAD-GAN_celebA.py:39-52 + hard-coded optimizer lrs
    :211-217 and unit lambdas :167-169."""

    n_epochs: int = 50
    batch_size: int = 16
    g_lr: float = 1e-3
    d_lr: float = 2e-4
    info_lr: float = 2e-4
    b1: float = 0.5
    b2: float = 0.999
    latent_dim: int = 200
    code_dim: int = 8
    n_classes: int = 10
    img_size: int = 64
    channels: int = 3
    sample_interval: int = 4000
    lambda_cat: float = 1.0
    lambda_con: float = 1.0
    lambda_affine: float = 1.0

    def __post_init__(self):
        if self.code_dim < 5:
            raise ValueError(
                "CelebA requires code_dim >= 5: the rpqxy affine regularizer "
                f"consumes the first five codes (got {self.code_dim})"
            )
        if self.img_size % 16 != 0:
            raise ValueError(
                f"img_size must be divisible by 16 (4 stride-2 stages), got {self.img_size}"
            )
