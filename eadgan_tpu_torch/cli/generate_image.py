"""MNIST inference CLI (PyTorch/CUDA): render the c1..c7 sweep grids
from a trained generator file.

``python -m eadgan_tpu_torch.cli.generate_image`` — counterpart of
``python -m eadgan_tpu.cli.generate_image``.  Loads a
``generator_%d.pt`` (``--checkpoint``, ``generator_40000.pt`` by
default; written by ``cli.mnist``, or by the JAX package's CLI in its
format), runs the generator in eval mode
(BatchNorm on its running statistics, as the reference's
``generator.eval()``) on the CUDA card (``EADGAN_PLATFORM=cpu`` for the
CPU) and writes 10x10 grids into ``<out_dir>/varying_c1..7/``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.models import MnistGenerator
from eadgan_tpu_torch.sample.figures import mnist_inference_grids
from eadgan_tpu_torch.train.checkpoint import restore_model
from eadgan_tpu_torch.utils import platform_device


def eval_apply(model: torch.nn.Module, device):
    """Numpy (z, labels, code) in, NHWC numpy images out: ``model`` in
    eval mode on ``device``, without gradients."""
    model = model.to(device).eval()

    @torch.no_grad()
    def apply(*inputs):
        out = model(*[torch.as_tensor(np.asarray(x), device=device) for x in inputs])
        return out.permute(0, 2, 3, 1).cpu().numpy()

    return apply


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, default="generator_40000.pt")
    parser.add_argument("--out_dir", type=str, default="test")
    parser.add_argument("--batches_done", type=int, default=0)
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = platform_device()

    model = restore_model(opt.checkpoint, MnistGenerator())
    mnist_inference_grids(eval_apply(model, device), opt.out_dir, opt.batches_done)
    print(f"wrote grids under {opt.out_dir}/varying_c1..7/")


if __name__ == "__main__":
    main()
