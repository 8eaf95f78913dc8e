"""``adam_roofline.train``: the Adam kernel's share of its roofline over
the profiled stretch: the bound of a step's Adam work (``counts/adam.py``:
28 bytes an element of every parameter each reference optimizer steps,
at the memory rate) times the stretch's steps, over the time of the
``adam_fused_kernel`` launches the trace holds."""

from harness.rooflines import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "adam_fused_kernel")
