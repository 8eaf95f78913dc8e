"""Convert the port's model files to reference PyTorch checkpoints.

``python -m eadgan_tpu_torch.cli.export_torch`` — counterpart of
``python -m eadgan_tpu.cli.export_torch``:

    python -m eadgan_tpu_torch.cli.export_torch --kind mnist_generator \\
        --input generator_40000.pt --output generator_40000.torch.pt

The inverse of ``cli.import_torch``: the output loads directly into the
reference's module definitions, so its own inference and score scripts
(``MNIST/generate_image.py:146-152``, ``celebA/gen_imgs.py:106-114``,
``dSprites/score/BetVAE.py:193-205``) can consume weights trained by
the port.  ``celeba_checkpoint`` maps a ``checkpoint_%d.tar`` (written by
``cli.celeba``) to the reference's combined dict (generator +
discriminator + epoch/batches_done, celebA/EAD-GAN_celebA.py:414-423).
The input is a file of the port's format or the JAX package's (the file
of the same name ``eadgan_tpu``'s CLIs write), told apart by content.
It is loaded (strictly) into the port's module on the CUDA card
(``EADGAN_PLATFORM=cpu`` for the CPU), which refuses a file of another
kind.
"""

from __future__ import annotations

import argparse

import torch

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.cli.import_torch import CELEBA_PARTS, KINDS, load_into
from eadgan_tpu_torch.interop.torch_export import export_state_dict, save_torch_state_dict
from eadgan_tpu_torch.train.checkpoint import load_celeba_checkpoint, load_model_file
from eadgan_tpu_torch.utils import platform_device


def exported(kind: str, state_dict, colored: bool, device, source: str):
    """The port's ``kind`` state_dict in the reference's keys, after a
    strict load into the port's module."""
    return export_state_dict(load_into(kind, state_dict, colored, device, source).state_dict())


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True, choices=sorted(KINDS) + ["celeba_checkpoint"])
    parser.add_argument("--input", required=True, help="the port's model file / checkpoint_%%d.tar")
    parser.add_argument("--output", required=True, help="reference-format torch file")
    parser.add_argument("--colored", action="store_true", help="colored-dSprites variants")
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = platform_device()

    if opt.kind == "celeba_checkpoint":
        try:
            raw = load_celeba_checkpoint(opt.input)
        except ValueError as e:
            raise SystemExit(f"{opt.input!r}: {e}") from None
        if not isinstance(raw, dict) or "generator_state_dict" not in raw:
            raise SystemExit(f"{opt.input!r} is not the port's CelebA checkpoint_%d.tar")
        out = {
            f"{part}_state_dict": {
                k: torch.from_numpy(v) for k, v in
                exported(kind, raw[f"{part}_state_dict"], False, device, opt.input).items()
            }
            for part, kind in CELEBA_PARTS
        }
        out.update(epoch=int(raw["epoch"]), batches_done=int(raw["batches_done"]))
        torch.save(out, opt.output)
    else:
        try:
            raw = load_model_file(opt.input, KINDS[opt.kind][0](opt.colored))
        except ValueError as e:
            raise SystemExit(f"{opt.input!r} does not fit the port's {opt.kind!r} model: {e}") from None
        save_torch_state_dict(opt.output, exported(opt.kind, raw, opt.colored, device, opt.input))
    print(f"wrote {opt.output}")


if __name__ == "__main__":
    main()
