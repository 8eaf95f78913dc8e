"""Host-side Python of the fused conv kernel's bring-up tools, on the CPU.

``tools.tma_wgmma_check``'s swizzle and A-box helpers are what its card
steps compare TMA's copies with; ``tools.conv_ablation``'s variants of
the fused conv and the int8 kernels find their anchors in the kernels'
sources; ``tools.tma_wgmma_check`` and ``tools.conv_ablation`` refuse to
run without a card.  Exact
comparisons: these are copies of values.
"""

import itertools

import pytest
import torch
import torch.nn.functional as F

from eadgan_tpu_torch.tools import conv_ablation, tma_wgmma_check


def test_unswizzle_inverts_the_128_byte_swizzle():
    rows = 24
    logical = torch.arange(rows * 64, dtype=torch.int16).reshape(rows, 64)
    chunks = logical.view(torch.uint8).reshape(rows, 8, 16)
    raw = torch.empty_like(chunks)
    for r, q in itertools.product(range(rows), range(8)):
        raw[r, tma_wgmma_check.swizzle_128b_chunk(r, q)] = chunks[r, q]
    got = tma_wgmma_check.unswizzle_128b(raw.reshape(-1))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), logical)


@pytest.mark.parametrize("coords", [(0, -1, -1, 0), (64, 1, 2, 1), (0, 7, 5, 1), (64, -1, 3, 0)])
def test_expected_box_is_a_strided_padded_slice(coords):
    """The A box: 64 channels from c0, every other column from c1 and row
    from c2 of image c3, zero outside the image and past Cin."""
    c0, c1, c2, c3 = coords
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 10, 10, 72, generator=gen).to(torch.bfloat16)
    pad = 40  # enough zeros on every side for any of these boxes
    xp = F.pad(x.float(), (0, 64, pad, pad, pad, pad))
    want = xp[c3, pad + c2:pad + c2 + 16:2, pad + c1:pad + c1 + 32:2, c0:c0 + 64]
    got = tma_wgmma_check.expected_box(x, *coords)
    assert torch.equal(got.float(), want.reshape(128, 64))


@pytest.mark.parametrize("name", sorted(conv_ablation.VARIANTS))
def test_ablation_refuses_a_source_without_its_anchors(name):
    """A kernel edited past a variant's anchors stops the tool with the
    anchor named, rather than timing the whole kernel under that name."""
    source = "__global__ void k() {}\n"
    if name == "full":
        assert conv_ablation.variant_source(name, source) == source
    else:
        with pytest.raises(ValueError, match=f"variant {name}: anchor"):
            conv_ablation.variant_source(name, source)


@pytest.mark.parametrize("kernel,name", [(k, n) for k in ("int8_convt", "quantize_int8")
                                         for n in sorted(conv_ablation.KERNELS[k][1])])
def test_int8_ablation_refuses_a_source_without_its_anchors(kernel, name):
    source = "__global__ void k() {}\n"
    variants = conv_ablation.KERNELS[kernel][1]
    if name == "full":
        assert conv_ablation.variant_source(name, source, variants) == source
    else:
        with pytest.raises(ValueError, match=f"variant {name}: anchor"):
            conv_ablation.variant_source(name, source, variants)


@pytest.mark.parametrize("kernel", sorted(conv_ablation.KERNELS))
def test_ablation_anchors_are_in_the_kernels(kernel):
    """Every variant's anchors are in the kernel's source as it is, so
    each variant stubs out its part (and only ``full`` is the kernel)."""
    source, variants, _ = conv_ablation.KERNELS[kernel]
    text = source.read_text()
    for name in variants:
        assert (conv_ablation.variant_source(name, text, variants) == text) == (name == "full")


@pytest.mark.parametrize("tool", [tma_wgmma_check, conv_ablation],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tool_needs_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot show")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tool.main([])
