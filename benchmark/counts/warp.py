"""The bilinear affine warp's bytes and operations (the arithmetic of
``chip_smoke.py::time_warp``): the image read once, the output written
once, the (N, 2, 3) matrices; a 4-tap weighted sum per element and the
coordinates per pixel."""


def warp_bytes(n: int, h: int, w: int, c: int, itemsize: int = 4) -> int:
    elem = n * h * w * c
    return 2 * elem * itemsize + n * 6 * 4


def warp_ops(n: int, h: int, w: int, c: int) -> int:
    return n * h * w * c * 7 + n * h * w * 25
