"""Every port CLI runs its float32 convolutions and matrix products in
full float32: after its setup, before it picks the device, both TF32
switches are off, whatever they were (torch allows TF32 in cuDNN
convolutions by default).  The CPU-vs-card gates, the card tests and the
timings all run with TF32 off, so this is the mode they check.  The
switches can be set without a card."""

import importlib

import pytest
import torch

from eadgan_tpu_torch.cli.common import disable_tf32

# module -> (the module whose platform_device it calls, argv)
CLIS = {
    "celeba": ("celeba", []),
    "pxy": ("pxy", []),
    "pxy_color": ("pxy", []),
    "rp": ("rp", []),
    "rp_color": ("rp", []),
    "approximate_rpqmnxy": ("approximate_rpqmnxy", []),
    "mnist": ("mnist", []),
    "generate_image": ("generate_image", ["--checkpoint", "missing.pt"]),
    "gen_imgs": ("gen_imgs", ["--checkpoint", "missing.tar", "--quant", "bf16"]),
}


class _Setup(Exception):
    pass


@pytest.fixture
def tf32_on():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_disable_tf32(tf32_on):
    disable_tf32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_turns_tf32_off_before_picking_the_device(name, tf32_on, monkeypatch):
    owner, argv = CLIS[name]
    seen = []

    def platform_device():
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        raise _Setup

    monkeypatch.setattr(importlib.import_module(f"eadgan_tpu_torch.cli.{owner}"),
                        "platform_device", platform_device)
    with pytest.raises(_Setup):
        importlib.import_module(f"eadgan_tpu_torch.cli.{name}").main(argv)
    assert seen == [(False, False)]
