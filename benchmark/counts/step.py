"""A train step's operations, counted from the configuration's shapes
on the reference's step: every multiply-add of the forwards and
backwards of its three phases that ``torch.utils.flop_counter`` counts
(convolutions, transposed convolutions, matrix products), on the meta
device, where nothing runs.  Never taken from the program, so a change
that replaces a kernel reads the same work."""

import torch
from torch.utils.flop_counter import FlopCounterMode


def step_flops(ref, cfg: dict, batch: int) -> int:
    models = ref.build(cfg, "meta")
    real = ref.prepare(torch.zeros(ref.batch_shape(cfg, batch), dtype=torch.uint8, device="meta"),
                       None, cfg["data"])
    draws = ref.draw(None, batch, cfg, "meta")
    with FlopCounterMode(display=False) as counter:
        ref.step(models, None, real, draws, cfg)
    return int(counter.get_total_flops())


def forward_macs(module: torch.nn.Module, *inputs) -> int:
    """Multiply-adds of one forward of ``module`` (a meta-device model)."""
    with FlopCounterMode(display=False) as counter:
        module(*inputs)
    return int(counter.get_total_flops()) // 2
