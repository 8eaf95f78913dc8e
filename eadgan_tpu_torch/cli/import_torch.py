"""Convert reference PyTorch checkpoints to the port's model files.

``python -m eadgan_tpu_torch.cli.import_torch`` — counterpart of
``python -m eadgan_tpu.cli.import_torch``:

    python -m eadgan_tpu_torch.cli.import_torch --kind sprites_encoder \\
        --input encoder_500000.pt --output encoder_500000.port.pt

Covers every checkpoint the reference saves.  The output is the port's
own model file (``train/checkpoint.py::save_model``), which the port's
CLIs load (``cli.score``, ``cli.rp --encoder_pxy``, ``cli.mnist
--approximator``, ``cli.generate_image``); ``celeba_checkpoint`` maps a
reference ``checkpoint_%d.tar`` to the port's ``checkpoint_%d.tar``
(both models plus epoch/batches_done), which ``cli.gen_imgs`` reads.
Spectral-norm layers are imported as the torch eval forward sees them
(``interop/torch_import.py``).  The imported model is loaded (strictly)
into the port's module on the CUDA card (``EADGAN_PLATFORM=cpu`` for
the CPU), which refuses a checkpoint of another kind.
"""

from __future__ import annotations

import argparse

import torch

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.interop import torch_import as ti
from eadgan_tpu_torch.models import (
    AffineApproximator,
    CelebaDiscriminator,
    CelebaGenerator,
    MnistDiscriminator,
    MnistEncoder,
    MnistGenerator,
    SpritesDiscriminator,
    SpritesEncoder,
    SpritesEncoderPxy,
    SpritesGenerator,
)
from eadgan_tpu_torch.train.checkpoint import cpu_state_dict, save_checkpoint, save_model
from eadgan_tpu_torch.utils import platform_device

# kind: (the port's module for --colored, the reference importer)
KINDS = {
    "approximator": (lambda c: AffineApproximator(), ti.import_approximator),
    "mnist_generator": (lambda c: MnistGenerator(), ti.import_mnist_generator),
    "mnist_encoder": (lambda c: MnistEncoder(), ti.import_mnist_encoder),
    "mnist_discriminator": (lambda c: MnistDiscriminator(), ti.import_mnist_discriminator),
    "sprites_encoder_pxy": (
        lambda c: SpritesEncoderPxy(out_dim=6 if c else 3, channels=3 if c else 1),
        ti.import_sprites_encoder_pxy,
    ),
    "sprites_generator": (
        lambda c: SpritesGenerator(in_dim=10 if c else 7, channels=3 if c else 1),
        ti.import_sprites_generator,
    ),
    "sprites_discriminator": (
        lambda c: SpritesDiscriminator(channels=3 if c else 1), ti.import_sprites_discriminator,
    ),
    "sprites_encoder": (
        lambda c: SpritesEncoder(code_dim=7 if c else 4, channels=3 if c else 1),
        ti.import_sprites_encoder,
    ),
    "celeba_generator": (lambda c: CelebaGenerator(), ti.import_celeba_generator),
    "celeba_discriminator": (lambda c: CelebaDiscriminator(), ti.import_celeba_discriminator),
}
CELEBA_PARTS = (("generator", "celeba_generator"), ("discriminator", "celeba_discriminator"))


def load_into(kind: str, state_dict, colored: bool, device, source: str) -> torch.nn.Module:
    """The port's ``kind`` module on ``device`` with ``state_dict`` loaded
    strictly; a state_dict of another kind exits with a message."""
    model = KINDS[kind][0](colored).to(device)
    try:
        model.load_state_dict(state_dict)
    except RuntimeError as e:
        raise SystemExit(f"{source!r} does not fit the port's {kind!r} model: {e}") from None
    return model


def convert(kind: str, sd, colored: bool, device, source: str) -> torch.nn.Module:
    """A reference state_dict of ``kind`` as the port's module."""
    try:
        port_sd = KINDS[kind][1](sd)
    except KeyError as e:
        raise SystemExit(
            f"state_dict is missing key {e} — is {source!r} really a {kind!r} checkpoint? "
            f"(its keys start with: {sorted(sd)[:3]})"
        ) from None
    return load_into(kind, port_sd, colored, device, source)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kind", required=True, choices=sorted(KINDS) + ["celeba_checkpoint"])
    parser.add_argument("--input", required=True, help="reference .pt / .tar file")
    parser.add_argument("--output", required=True, help="the port's model file")
    parser.add_argument("--colored", action="store_true", help="colored-dSprites variants")
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = platform_device()

    if opt.kind == "celeba_checkpoint":
        raw = torch.load(opt.input, map_location="cpu", weights_only=True)
        if not isinstance(raw, dict) or "generator_state_dict" not in raw:
            raise SystemExit(
                f"{opt.input!r} is not a reference CelebA checkpoint_%d.tar (expected a dict "
                "with 'generator_state_dict'/'discriminator_state_dict'); for plain "
                "state_dicts use --kind celeba_generator / celeba_discriminator"
            )
        out = {
            f"{part}_state_dict": cpu_state_dict(
                convert(kind, raw[f"{part}_state_dict"], False, device, opt.input))
            for part, kind in CELEBA_PARTS
        }
        out.update(epoch=int(raw.get("epoch", 0)), batches_done=int(raw.get("batches_done", 0)))
        save_checkpoint(opt.output, out)
    else:
        sd = ti.load_torch_state_dict(opt.input)
        save_model(opt.output, convert(opt.kind, sd, opt.colored, device, opt.input))
    print(f"wrote {opt.output}")


if __name__ == "__main__":
    main()
