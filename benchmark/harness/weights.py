"""Weights and model state made from the run's seed, on the card, in a
few large calls: one uniform draw for every weight and bias (each leaf a
slice, scaled to torch's default init bound of its layer), one normal
draw for every spectral-norm ``u``; ones and zeros where torch's init
puts them.  The reference's ``init_spec`` names the leaves, so the same
values load into the program's models and the reference's."""

from __future__ import annotations

import math
from typing import Dict

import torch


def make(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{key: tensor}`` for ``spec`` (``[(key, shape, kind, bound)]``),
    float32 (the counts int64), drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind)
             for kind in ("uniform", "normal")}
    pools = {"uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2.0 - 1.0,
             "normal": torch.randn(sizes["normal"], generator=gen, device=device)}
    offsets = {"uniform": 0, "normal": 0}
    out = {}
    for key, shape, kind, bound in spec:
        if kind in pools:
            n = math.prod(shape)
            flat = pools[kind][offsets[kind]:offsets[kind] + n]
            offsets[kind] += n
            out[key] = (flat * bound if kind == "uniform" else flat).reshape(shape)
        elif kind == "ones":
            out[key] = torch.ones(shape, device=device)
        elif kind == "zeros":
            out[key] = torch.zeros(shape, device=device)
        elif kind == "count":
            out[key] = torch.zeros(shape, dtype=torch.long, device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} of {key}")
    return out


def part(weights: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries under ``prefix.`` with the prefix taken off."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in weights.items() if k.startswith(p)}
