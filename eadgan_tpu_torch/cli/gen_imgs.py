"""CelebA inference CLI (PyTorch/CUDA): render the c1..c8 sweep grids
from a trained checkpoint.

``python -m eadgan_tpu_torch.cli.gen_imgs`` — counterpart of ``python -m
eadgan_tpu.cli.gen_imgs``.  Reads ``generator_state_dict`` from a
``checkpoint_%d.tar`` (``--checkpoint``, ``checkpoint_600000.tar`` by
default; written by ``cli.celeba`` in the port's format, or by the JAX
package's CLI in its own: only its generator's subtree is read) and
writes 10x10 grids into ``<out_dir>/varying_c1..8/`` on the CUDA card
(``EADGAN_PLATFORM=cpu`` for the CPU).  ``--quant none`` runs the
generator's eval-mode forward in float32; ``--quant bf16`` the
BatchNorm-folded bf16 forward; ``--quant int8`` the folded forward with
int8 mid layers, on the card through the ``quantize_int8`` and
``int8_convt`` kernels (``ops/quant.py``): 8 forwards of batch 100, each
3 transposed-conv launches and 4 quantization launches (two for layer
1's input, whose abs-max takes a pass of its own, one each for layers 2
and 3, whose abs-max ``int8_convt`` hands on).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from eadgan_tpu_torch.cli.common import disable_tf32
from eadgan_tpu_torch.cli.generate_image import eval_apply
from eadgan_tpu_torch.models import CelebaGenerator
from eadgan_tpu_torch.ops.quant import make_celeba_infer
from eadgan_tpu_torch.sample.figures import celeba_inference_grids
from eadgan_tpu_torch.train.checkpoint import load_celeba_checkpoint
from eadgan_tpu_torch.utils import platform_device


def folded_apply(state_dict, device, quant="none"):
    """Numpy (z, labels, code) in, NHWC numpy images out: the BN-folded
    forward on ``device``, bf16 (``quant="none"``) or with int8 mid
    layers (``"int8"``) and bf16 ends."""
    fwd = make_celeba_infer(state_dict, quant=quant, compute_dtype=torch.bfloat16, device=device)

    def apply(*inputs):
        out = fwd(*[torch.as_tensor(np.asarray(x), device=device) for x in inputs])
        return out.permute(0, 2, 3, 1).cpu().numpy()

    return apply


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", type=str, default="checkpoint_600000.tar")
    parser.add_argument("--out_dir", type=str, default="images")
    parser.add_argument("--batches_done", type=int, default=0)
    parser.add_argument(
        "--quant", choices=["none", "bf16", "int8"], default="none",
        help="inference path: none = the float32 eval-mode forward; bf16 = the BatchNorm-folded "
        "bf16 forward; int8 = the folded forward with int8 mid layers",
    )
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = platform_device()

    # either format; of a JAX file only the generator's subtree, as the JAX CLI reads it
    state_dict = load_celeba_checkpoint(opt.checkpoint, parts=("generator",))["generator_state_dict"]
    if opt.quant in ("bf16", "int8"):
        apply_g = folded_apply(state_dict, device, quant="none" if opt.quant == "bf16" else "int8")
    else:
        model = CelebaGenerator()
        model.load_state_dict(state_dict)
        apply_g = eval_apply(model, device)
    celeba_inference_grids(apply_g, opt.out_dir, opt.batches_done)
    print(f"wrote grids under {opt.out_dir}/varying_c1..8/")


if __name__ == "__main__":
    main()
