"""The benchmark's own counts: the CelebA models' multiply-adds against
the hand count, the step's operations, and the warp's bound against
``chip_smoke.py``'s arithmetic at PERF.md's shapes."""

import json

import pytest
import torch

import chip_smoke
from conftest import ROOT

from counts.step import forward_macs, step_flops
from counts.warp import warp_bytes, warp_ops
from harness import peaks, spec

CELEBA = json.loads((ROOT / "benchmark/configs/celeba.json").read_text())


def test_celeba_forward_macs_match_the_hand_count():
    ref = spec.reference("celeba")
    models = ref.build(CELEBA, "meta")
    z, code, labels = ref.draw(None, 1, CELEBA, "meta")
    onehot = torch.empty(1, 10, device="meta")
    assert forward_macs(models["g"], z, onehot, code) == 412_516_352
    d_macs = forward_macs(models["d"], torch.empty(1, 3, 64, 64, device="meta"))
    # the counter also sees one matrix-vector product of each spectral-norm power step
    sn_macs = sum(m.weight.numel() for m in models["d"].modules() if hasattr(m, "sn_weight"))
    assert d_macs - sn_macs == 409_255_936


def test_celeba_parameter_counts():
    ref = spec.reference("celeba")
    models = ref.build(CELEBA, "meta")
    assert sum(p.numel() for p in models["g"].parameters()) == CELEBA["model"]["generator_parameters"]
    assert sum(p.numel() for p in models["d"].parameters()) == CELEBA["model"]["discriminator_parameters"]


def test_celeba_step_operations():
    ref = spec.reference("celeba")
    flops = step_flops(ref, CELEBA, 128)
    per_image = flops / 128
    # 6 G and 17 D forward-equivalents of ~0.41 GMAC: ~19 GFLOP an image
    assert 17e9 < per_image < 21e9


def test_warp_bound_matches_chip_smoke():
    n, h, w, c = 128, 64, 64, 3
    mine = peaks.bound_s(warp_bytes(n, h, w, c), warp_ops(n, h, w, c), peaks.F32_FLOPS_PER_S)
    elem = n * h * w * c
    theirs_ms, by = chip_smoke.bound(2 * elem * 4 + n * 6 * 4, elem * 7 + n * h * w * 25,
                                     chip_smoke.F32_FLOPS_PER_S)
    assert by == "bytes" and mine == pytest.approx(theirs_ms / 1e3, rel=1e-12)
    assert mine * 1e6 == pytest.approx(3.76, abs=0.005)  # PERF.md's kernel table

