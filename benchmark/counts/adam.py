"""The Adam kernel's bytes and operations a train step (the arithmetic of
``chip_smoke.py``'s Adam bound): every element of every parameter the
reference's optimizers step, a parameter that two optimizers step (the
info Adam's G and D) counted in each; 28 bytes an element (parameter,
gradient and both moments read once, parameter and moments written once,
float32) and 13 operations (the moments' two updates, 7; the step's
square root, two divisions, the epsilon, the rate and the subtraction,
6).  Counted from the reference's shapes on the meta device, never taken
from the program."""

BYTES_PER_ELEMENT = 28
OPS_PER_ELEMENT = 13


def adam_elements(ref, cfg: dict) -> int:
    """The elements the reference's optimizers step in one train step."""
    opts = ref.optimizers(ref.build(cfg, "meta"), cfg)
    return sum(p.numel() for opt in opts.values() for group in opt.param_groups
               for p in group["params"])


def adam_work(ref, cfg: dict) -> dict:
    n = adam_elements(ref, cfg)
    return {"ops": OPS_PER_ELEMENT * n, "bytes": BYTES_PER_ELEMENT * n, "compute": "f32"}
