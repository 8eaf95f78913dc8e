"""MNIST affine-approximator pretrainer CLI (PyTorch/CUDA).

``python -m eadgan_tpu_torch.cli.approximate_rpqmnxy`` — counterpart of
``python -m eadgan_tpu.cli.approximate_rpqmnxy``: ``--iterations``
(20,001 by default) steps of batch-128 MSE regression from flattened
rpqmnxy affine matrices to their physical parameters on the CUDA card
(``EADGAN_PLATFORM=cpu`` for the CPU), one step per iteration, writing
the model file ``rpqmnxy_approximator.pt`` every 20,000 iterations and
at the end, which ``cli.mnist`` loads as its frozen regularizer.
"""

from __future__ import annotations

import argparse
import os

from eadgan_tpu_torch.cli.common import disable_tf32, init_multiprocess
from eadgan_tpu_torch.train.checkpoint import save_model
from eadgan_tpu_torch.train.config import ApproximatorConfig
from eadgan_tpu_torch.train.pretrain import init_approximator_state, make_approximator_step
from eadgan_tpu_torch.utils import MetricLogger, platform_device

SAVE_EVERY = 20000
FILENAME = "rpqmnxy_approximator.pt"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iterations", type=int, default=20001)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--ckpt_dir", type=str, default=".")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--jsonl", type=str, default="")
    opt = parser.parse_args(argv)
    print(opt)
    disable_tf32()
    device = init_multiprocess(opt, platform_device)

    config = ApproximatorConfig(iterations=opt.iterations, batch_size=opt.batch_size, lr=opt.lr)
    state = init_approximator_state(config, device=device, seed=opt.seed)
    step = make_approximator_step(config)
    logger = MetricLogger(opt.jsonl or None, print_every=1000)

    path = os.path.join(opt.ckpt_dir, FILENAME)
    try:
        for iteration in range(config.iterations):
            state, metrics = step(state)
            logger.log(iteration, metrics)
            if iteration % SAVE_EVERY == 0:
                save_model(path, state.model)
    finally:
        logger.close()
    # the final weights always (an --iterations off the 20,000 cadence
    # would otherwise keep only step 0's)
    save_model(path, state.model)
    print(f"saved {path}")


if __name__ == "__main__":
    main()
