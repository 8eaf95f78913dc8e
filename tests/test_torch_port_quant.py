"""Port int8 generator inference (``eadgan_tpu_torch/ops/quant.py``)
against the JAX package's ``eadgan_tpu/ops/quant.py``, on the CPU.

The CelebA generator's flax variables are initialised from a seed and
their BatchNorm parameters and statistics perturbed away from identity
as in ``tests/test_quant.py``, then carried into the port by
``interop/from_jax.py``; inputs are numpy-seeded.  Exact parts:

* the per-channel weight quantization of the folded layers 1-3 (each
  side quantizing JAX's folded kernel, in its own layout): int8 values
  equal after the layout map, scales equal;
* the per-tensor activation quantization: int8 values and scale equal,
  on inputs with exact .5 ties and on all zeros (the 1e-12 floor), from
  NCHW and NHWC;
* the int8 transposed conv: int32 sums equal at each quantized layer's
  geometry, and the kernel's phase decomposition (the repacked weight
  taken as four GEMMs over shifted input taps, as ``csrc/int8_convt.cu``
  does) equal to it;
* a layer's output, float32 and rounded to bf16 (``out_dtype``), against
  JAX's op by op; the abs-max handed to the next quantization
  (``output_amax_plain``) against ``jnp.max(jnp.abs(x))``, -0.0
  included; the quantization with that abs-max given.

The chained forward (abs-max handed on, the last int8 layer writing
``compute_dtype``) equals its unchained composition bit for bit.

The whole int8 forward against JAX's, tolerances measured here:

* float32 ends on both sides: 2e-2 absolute on tanh outputs.  Each side
  quantizes its own layer outputs, and a float32 sum taken in another
  order (layer 0's, each epilogue's products) can put an activation on
  the other side of a rounding boundary: a +-1 flip of one int8 value,
  1/127 of the tensor's range, which the following layers carry
  (measured 1.4e-3 at these weights and inputs);
* bf16 ends (the default): 2e-2 absolute, the bar of the bf16
  comparisons; torch rounds a bf16 convolution's output to bf16 before
  the float32 bias, JAX does not (measured 5.6e-3).

And the port's int8 forward against its own float32 eval forward: PSNR
above 25 dB and max abs below 0.5, the bar of ``tests/test_quant.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from eadgan_tpu.models import CelebaGenerator as JaxG
from eadgan_tpu.ops import quant as jq
from eadgan_tpu_torch.interop.from_jax import celeba_generator_from_flax
from eadgan_tpu_torch.models import CelebaGenerator
from eadgan_tpu_torch.ops import quant

B = 4
# (H, Cin, Cout) of the inputs of the generator's int8 layers 1-3
LAYERS = [(4, 1024, 512), (8, 512, 256), (16, 256, 128)]


@pytest.fixture(scope="module")
def g_variables():
    variables = jax.device_get(JaxG().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 200)), jnp.zeros((1, 10)), jnp.zeros((1, 8))))
    rng = np.random.RandomState(7)

    def perturb(path, x):
        name = "/".join(str(k) for k in path)
        x = np.asarray(x)
        if "var" in name:
            return x * rng.uniform(0.5, 2.0, x.shape).astype(x.dtype)
        if "mean" in name or "bias" in name or "scale" in name:
            return x + rng.normal(0, 0.3, x.shape).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def state_dict(g_variables):
    return celeba_generator_from_flax(g_variables)


def _inputs(seed=0, batch=B):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((batch, 200)).astype(np.float32),
        np.eye(10, dtype=np.float32)[rng.integers(0, 10, batch)],
        rng.uniform(-1, 1, (batch, 8)).astype(np.float32),
    )


def _torch_layout(hwio: np.ndarray) -> torch.Tensor:
    """flax ConvTranspose kernel (kh, kw, in, out), taps flipped -> torch
    (in, out, kh, kw), exactly (``interop/from_jax.py``'s map, any dtype)."""
    return torch.from_numpy(np.ascontiguousarray(np.transpose(hwio[::-1, ::-1], (2, 3, 0, 1))))


@pytest.mark.parametrize("layer", [1, 2, 3])
def test_weight_quantization_equals_jax(g_variables, state_dict, layer):
    kernel = np.asarray(jq.fold_celeba_generator_bn(g_variables)[layer]["kernel"])
    ref_q, ref_scale = (np.asarray(a) for a in jq.quantize_kernel_per_channel(jnp.asarray(kernel)))
    q, scale = quant.quantize_kernel_per_channel(_torch_layout(kernel))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), _torch_layout(ref_q).numpy())
    np.testing.assert_array_equal(scale.numpy(), ref_scale)
    assert np.abs(q.numpy()).max(axis=(0, 2, 3)).min() == 127  # every channel spans the range
    # the port's own fold quantizes to within a step of it (the folds agree to 1e-6)
    own, own_scale = quant.quantize_kernel_per_channel(quant.fold_celeba_generator_bn(state_dict)[layer][0])
    np.testing.assert_allclose(own_scale.numpy(), ref_scale, rtol=1e-6)
    assert (own.int() - q.int()).abs().max() <= 1


def _tie_activation(shape, rng):
    """Values whose quotient by the scale (2^-3: max |x| = 127 / 8) is
    exact, a third of them on .5 ties, both signs."""
    k = rng.integers(-126, 127, shape).astype(np.float32)
    tie = rng.random(shape) < 1 / 3
    x = (k + tie * np.where(k < 0, -0.5, 0.5)).astype(np.float32) / 8
    x.reshape(-1)[5] = -127 / 8
    return x


@pytest.mark.parametrize("kind", ["ties", "normal", "zeros"])
def test_activation_quantization_equals_jax(kind):
    rng = np.random.default_rng(1)
    shape = (B, 8, 8, 512)  # NHWC, the input of layer 2
    x = {"ties": lambda: _tie_activation(shape, rng),
         "normal": lambda: (rng.standard_normal(shape) * 3).astype(np.float32),
         "zeros": lambda: np.zeros(shape, np.float32)}[kind]()
    ref_q, ref_scale = (np.asarray(a) for a in jq._quantize_activation(jnp.asarray(x)))
    if kind == "ties":
        assert float(ref_scale) == 0.125 and np.any(np.abs(x * 8 % 1) == 0.5)
    if kind == "zeros":
        assert float(ref_scale) == np.float32(1e-12) / np.float32(127)
    for nhwc in (True, False):
        arg = torch.from_numpy(x if nhwc else np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        q, scale = quant.quantize_activation(arg, nhwc)
        assert q.dtype == torch.int8 and q.is_contiguous() and scale.shape == ()
        np.testing.assert_array_equal(q.numpy(), ref_q)
        np.testing.assert_array_equal(scale.numpy(), ref_scale)


def _int8(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("h,cin,cout", LAYERS)
def test_int8_convt_equals_jax(h, cin, cout):
    rng = np.random.default_rng(h)
    xq, kernel = _int8(rng, (2, h, h, cin)), _int8(rng, (4, 4, cin, cout))
    ref = np.asarray(jq._convt(jnp.asarray(xq), jnp.asarray(kernel), 2, 1, jnp.int32))
    got = quant.convt_int8_plain(torch.from_numpy(xq), _torch_layout(kernel), 2, 1)
    assert got.dtype == torch.int32 and got.shape == (2, 2 * h, 2 * h, cout)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("batch,h,cin,cout", [(2, 4, 64, 16), (3, 5, 128, 24), (1, 3, 64, 8)])
def test_phase_gemms_of_the_repacked_weight_equal_the_convt(batch, h, cin, cout):
    """The int8 kernel's geometry: output parity phase (py, px) of the k4
    s2 p1 transposed conv is a GEMM of the input taps at row and column
    offsets (py - ty, px - tx), zero outside, by the repacked weight's
    (Cout, 4 * Cin) matrix of that phase."""
    rng = np.random.default_rng(batch)
    xq = torch.from_numpy(_int8(rng, (batch, h, h + 1, cin)))
    wq = torch.from_numpy(_int8(rng, (cin, cout, 4, 4)))
    wp = quant.repack_convt_weight(wq)
    assert wp.shape == (4, cout, 4, cin) and wp.is_contiguous()
    padded = F.pad(xq.long(), (0, 0, 1, 1, 1, 1))
    w = h + 1
    out = torch.zeros(batch, 2 * h, 2 * w, cout, dtype=torch.long)
    for py in range(2):
        for px in range(2):
            taps = [padded[:, 1 + py - ty : 1 + py - ty + h, 1 + px - tx : 1 + px - tx + w]
                    for ty in range(2) for tx in range(2)]
            a = torch.cat(taps, dim=-1).reshape(-1, 4 * cin)
            gemm = a @ wp[2 * py + px].reshape(cout, 4 * cin).long().T
            out[:, py::2, px::2] = gemm.reshape(batch, h, w, cout)
    assert torch.equal(out.int(), quant.convt_int8_plain(xq, wq, 2, 1))


def test_int8_layer_epilogue():
    """``int8_convt_relu`` on CPU tensors: the int32 sums scaled by
    ``a_scale * w_scale``, the bias added, then ReLU, in float32."""
    rng = np.random.default_rng(0)
    xq = torch.from_numpy(_int8(rng, (2, 4, 4, 64)))
    layer = quant.Int8ConvT.from_folded(torch.from_numpy(rng.standard_normal((64, 16, 4, 4)).astype(np.float32)),
                                        torch.from_numpy(rng.standard_normal(16).astype(np.float32)))
    a_scale = torch.tensor(0.02)
    got = quant.int8_convt_relu(xq, a_scale, layer)
    acc = quant.convt_int8_plain(xq, layer.wq, 2, 1).float()
    assert torch.equal(got, torch.relu(acc * (a_scale * layer.w_scale) + layer.bias))
    assert (got == 0).any() and (got > 0).any()


def _jax_layer(rng, h, cin, cout):
    """One int8 layer's inputs and JAX's float32 output for them, op by op
    as ``jq.make_celeba_infer`` computes it: int32 sums, ``* (a_scale *
    w_scale) + bias``, ReLU."""
    xq, kernel = _int8(rng, (2, h, h, cin)), _int8(rng, (4, 4, cin, cout))
    w_scale = rng.uniform(1e-4, 1e-3, cout).astype(np.float32)
    bias = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    a_scale = np.float32(0.0173)
    y = jq._convt(jnp.asarray(xq), jnp.asarray(kernel), 2, 1, jnp.int32)
    ref = jax.nn.relu(y.astype(jnp.float32) * (a_scale * jnp.asarray(w_scale)) + jnp.asarray(bias))
    port = (torch.from_numpy(xq), torch.tensor(a_scale), _torch_layout(kernel),
            torch.from_numpy(w_scale), torch.from_numpy(bias))
    return port, ref


@pytest.mark.parametrize("h,cin,cout", LAYERS)
def test_int8_layer_output_in_bf16_equals_jax(h, cin, cout):
    """``int8_convt_relu_plain`` in float32 equals JAX's layer output bit
    for bit, and with ``out_dtype=torch.bfloat16`` equals that output's
    ``.astype(jnp.bfloat16)`` (round to nearest even) bit for bit."""
    port, ref = _jax_layer(np.random.default_rng(10 + h), h, cin, cout)
    got = quant.int8_convt_relu_plain(*port)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = quant.int8_convt_relu_plain(*port, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 2 * h, 2 * h, cout)
    want = np.asarray(ref.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32), want.view(np.uint32))
    assert (want > 0).mean() > 0.2 and (want == 0).any()


@pytest.mark.parametrize("kind", ["layer", "negative_zero", "all_zero"])
def test_output_amax_equals_jax(kind):
    """``output_amax_plain`` equals ``jnp.max(jnp.abs(x))`` of JAX's layer
    output exactly, bits included, also where the output holds -0.0 (and
    where -0.0 and 0.0 are all it holds: the abs-max is +0.0)."""
    _, ref = _jax_layer(np.random.default_rng(3), 8, 512, 256)
    x = np.array(ref)
    if kind == "negative_zero":
        x.reshape(-1)[::7] = -0.0
    elif kind == "all_zero":
        x[...] = 0.0
        x.reshape(-1)[::3] = -0.0
    assert np.signbit(x).any() == (kind != "layer")
    want = np.asarray(jnp.max(jnp.abs(jnp.asarray(x))))
    got = quant.output_amax_plain(torch.from_numpy(x))
    assert got.shape == () and got.dtype == torch.float32
    assert got.numpy().view(np.uint32) == want.view(np.uint32)


@pytest.mark.parametrize("kind", ["ties", "normal", "zeros"])
def test_activation_quantization_with_a_given_amax_equals_jax(kind):
    """``quantize_activation_plain`` handed the abs-max (as the chained
    forward hands it from the layer before) equals
    ``_quantize_activation``, from NCHW and NHWC."""
    rng = np.random.default_rng(2)
    shape = (B, 16, 16, 256)  # NHWC, the input of layer 3
    x = {"ties": lambda: _tie_activation(shape, rng),
         "normal": lambda: np.maximum(rng.standard_normal(shape) * 3, 0).astype(np.float32),
         "zeros": lambda: np.zeros(shape, np.float32)}[kind]()
    ref_q, ref_scale = (np.asarray(a) for a in jq._quantize_activation(jnp.asarray(x)))
    amax = quant.output_amax_plain(torch.from_numpy(x))
    for nhwc in (True, False):
        arg = torch.from_numpy(x if nhwc else np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
        q, scale = quant.quantize_activation(arg, nhwc, amax)
        np.testing.assert_array_equal(q.numpy(), ref_q)
        np.testing.assert_array_equal(scale.numpy(), ref_scale)


@pytest.mark.parametrize("compute", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chained_int8_forward_equals_the_unchained_one(state_dict, compute):
    """The chained forward (layers 1 and 2 hand their abs-max on, layer 3
    writes ``compute_dtype``) equals the separate steps bit for bit."""
    from eadgan_tpu_torch.tools.quant_bench import unchained_int8_forward

    x = [torch.from_numpy(a) for a in _inputs(5)]
    got = quant.make_celeba_infer(state_dict, quant="int8", compute_dtype=compute)(*x)
    want = unchained_int8_forward(state_dict, compute)(*x)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("compute,tol", [("float32", 2e-2), ("bfloat16", 2e-2)])
def test_int8_forward_matches_jax(g_variables, state_dict, compute, tol):
    z, label, code = _inputs(2)
    ref = np.asarray(jq.make_celeba_infer(g_variables, quant="int8",
                                          compute_dtype=getattr(jnp, compute))(z, label, code))
    fwd = quant.make_celeba_infer(state_dict, quant="int8", compute_dtype=getattr(torch, compute))
    got = fwd(*map(torch.from_numpy, (z, label, code)))
    assert got.dtype == torch.float32 and got.shape == (B, 3, 64, 64)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=tol)


def test_int8_is_the_default_and_tracks_the_f32_eval_forward(state_dict):
    z, label, code = map(torch.from_numpy, _inputs(3, batch=8))
    model = CelebaGenerator()
    model.load_state_dict(state_dict)
    with torch.no_grad():
        ref = model.eval()(z, label, code)
    out = quant.make_celeba_infer(state_dict)(z, label, code)
    explicit = quant.make_celeba_infer(state_dict, quant="int8")(z, label, code)
    assert torch.equal(out, explicit)
    psnr = 10 * np.log10(4.0 / float(((out - ref) ** 2).mean()))  # peak to peak 2 on tanh outputs
    assert psnr > 25.0, f"int8 PSNR {psnr:.1f} dB below the bar"
    assert float((out - ref).abs().max()) < 0.5


def test_unknown_quant_mode_raises(state_dict):
    with pytest.raises(ValueError, match="int4"):
        quant.make_celeba_infer(state_dict, quant="int4")
