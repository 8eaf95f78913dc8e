"""Colored-dSprites EAD-GAN trainer CLI (PyTorch/CUDA):
``python -m eadgan_tpu_torch.cli.rp_color``, the colored variant of
``cli.rp``."""

from eadgan_tpu_torch.cli.rp import main as _main


def main(argv=None) -> None:
    _main(argv, colored=True)


if __name__ == "__main__":
    main()
