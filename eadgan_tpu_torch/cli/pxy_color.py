"""Colored-dSprites stage-1 pretrainer CLI (PyTorch/CUDA):
``python -m eadgan_tpu_torch.cli.pxy_color``, the colored variant of
``cli.pxy``."""

from eadgan_tpu_torch.cli.pxy import main as _main


def main(argv=None) -> None:
    _main(argv, colored=True)


if __name__ == "__main__":
    main()
