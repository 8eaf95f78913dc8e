"""``warp_roofline.train``: the warp kernel's share of its roofline over
the profiled stretch: the bound of its launches (bytes, ``counts/warp.py``,
at the memory rate; every launch at the step's shape) over the time of
the ``warp_affine_kernel`` launches the trace holds."""

from harness.peaks import HBM_BYTES_PER_S

KERNEL = "warp_affine_kernel"


def read(rec):
    s, warp = rec.get("stretch"), rec.get("warp")
    if not s or not warp:
        return None
    names = [n for n in s["kernel_s"] if KERNEL in n]
    launches = sum(s["kernel_count"][n] for n in names)
    seconds = sum(s["kernel_s"][n] for n in names)
    if not launches or seconds <= 0:
        return None
    return 100.0 * launches * warp["bytes_per_launch"] / HBM_BYTES_PER_S / seconds
