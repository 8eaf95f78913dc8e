"""CUDA kernels against their plain versions, on the card.

Marked ``cuda``: on a machine without a CUDA card these tests skip (the
decision is taken inside the fixture, never at import).  On the card:
``python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the card's
machine need not have).

The warp also runs at the dSprites trainers' shapes, (128, 64, 64, 1)
binary sprites and (128, 64, 64, 3) colorized ones, under the aligner's
inverse matrices (codes in [-3, 3], so some rows land wholly outside the
image) and rp matrices, and one gray rp step on the card launches it
exactly three times.

The scorer's warp, the Representer's batch of 500 and odd ragged
batches of binary (C = 1) and colorized (C = 3) sprites under the
aligner's inverse matrices in ``zeros``; the Representer on the card
against the CPU from the same weights (continuous columns 1e-4,
category ids equal, one warp a batch).

The MNIST step's warp, (128, 32, 32, 1) with ``border`` padding (half
the columns a block saw at 64 wide), and one MNIST step on the card
launches it once; the MNIST step on the card against the CPU from the
same weights and draws (f32 rtol 1e-3 at step 0 and 3e-2 after, bf16
1e-2 and 5e-2, as ``chip_smoke.py``); the chained MNIST step against
the per-step one; the BatchNorm-folded bf16 CelebA generator against the
float32 eval forward on the card (2e-2 absolute on tanh outputs).

The chained engine (one CUDA graph of the train step, replayed): 8
steps of ``run_epochs`` for the pxy, gray rp and CelebA f32 steps at
batch 16 in windows of up to 4 against two per-step runs from copies of
the same state (``tools/chain_check.py``): with cuDNN held to its
deterministic algorithms the two per-step runs agree bit for bit, and
the chained run must too, in every logged loss and event batch; the
warp's launches are counted per replay.  A train state saved by a chained CLI run resumes under
``--chain 1``, and one saved at ``--chain 1`` resumes chained.  The
chained engine's events run on its worker against snapshots of the
state, which later replays leave as they were: a callback that sleeps
and then reads its state reads the per-step engine's values, bit for bit.
A graceful stop (``stop_event`` set by an inline event, CelebA and gray
rp at batch 16 in windows of 4) hands ``on_shutdown`` the train state of
a ``max_steps`` run to the same step, bit for bit
(``tools/stop_check.py``).

The model axis: the CelebA bf16 step on a (1, 1) grid in a NCCL group
of one, bit-equal to the plain step; two gloo ranks sharing the card as
a (1, 2) grid against one rank at the JAX 2-D test's bars
(``tools/tp_check.py``).

Data-parallel training in a NCCL group of one (``tools/dp_check.py``):
``run_epochs`` chained for the gray rp and CelebA bf16 steps at batch 16
in windows of 4, plain, ``data_parallel`` (its all-reduces captured in
the graph) and with ``zero_opt``, bit-equal in every logged loss and
state tensor; two NCCL ranks on the one card raise before either joins;
in a gloo group on the card the chained engine raises.

The int8 generator's kernels: ``int8_convt`` bit-equal to
``int8_convt_relu_plain`` (int32 sums exact on both sides, the same three
float32 operations in the epilogue) at the three quantized layers'
shapes, batch 128, the CLI's 100 and 3, writing float32 and bf16, its
abs-max word equal to the plain output's; ``quantize_int8`` bit-equal to
its plain version from NCHW and NHWC inputs, with exact .5 ties, normal
values, -0.0 and all zeros, with its own abs-max and a given one; the
int8 forward on the card against the CPU's, 2e-2
absolute on tanh outputs (each side quantizes its own float32 layer
outputs, so an activation can round one step apart); and both wrappers'
refusals.

The Adam kernel (``ops/adam_cuda.py``): five steps of CelebA's three
optimizers on its real parameters against the plain version on the card,
and the same on ragged sizes and on views 4 and 8 bytes past a 16-byte
boundary; a step captured in a CUDA graph and replayed against the same
steps eager, bit for bit; its refusals; and its launches, one a
``step()`` eager and counted a replay in the chained rp step.

The spectral norm's kernels (``ops/sn_cuda.py``) against the plain
version, at CelebA's four discriminator shapes and every shape the rp,
colored rp and MNIST steps normalize, writing bf16 and float32: sigma
and ``u'`` within 1e-5 of the plain version's (sums in another order),
the normalized weight bit-equal to ``(W / s).to(dtype)`` for the
kernels' own sigma, the weight's gradient within 1e-4 of its largest
element of autograd through the plain version and within 1e-5 of the
closed form on the kernels' own vectors in float64; sigma 0 (a zero
weight) gives ``W`` and a gradient equal to ``G``; eval mode and
``no_stat_updates`` leave ``u`` and sigma as they were; two runs, and a
captured graph's replays, hold the same bits as an eager call; the
launches, one or three a forward and one or two a backward by size,
counted eager and a replay in the chained rp step.

Tolerances: the warp in float32 2e-5 (nvcc contracts multiply-adds into
FMA, so a coordinate can land an ulp apart and pick the neighbouring
texel's weights; bilinear output is continuous, so the error stays
~1e-6), in bf16 1e-2 (one bf16 rounding of the output, against the plain
version on the same bf16 input).  The fused conv: 2e-2 of max(1, max
|ref|), the JAX tool's bar, and per element two bf16 steps of |ref| plus
1e-3 of max |ref| (``ops.fused_conv.mismatch``: both accumulate bf16
products in float32 in other orders and round once to bf16, so one step
apart at most).  Its cases run with the probe's small bias and with a
bias as large as the conv output, which a kernel that drops the bias or
reads another channel's cannot pass.
"""

import copy

import pytest
import torch

from eadgan_tpu_torch.ops import (
    adam_cuda,
    fused_conv_cuda,
    fused_conv_lrelu,
    fused_conv_lrelu_plain,
    stn_cuda,
    warp_affine,
    warp_affine_plain,
)
from eadgan_tpu_torch.ops.fused_conv import mismatch
from eadgan_tpu_torch.tools.quant_bench import generator_inputs, int8_layer_inputs
from eadgan_tpu_torch.transforms import RP, RPQMNXY, RPQXY, code_to_matrix
from eadgan_tpu_torch.utils.profiler import sprite_warp_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CASES = [
    ((4, 64, 64, 1), RP, 1.0),
    ((4, 64, 64, 3), RP, 1.0),
    ((2, 32, 64, 3), RP, 1.0),
    ((2, 17, 16, 1), RP, 1.0),
    ((2, 16, 16, 1), RPQMNXY, 3.0),
    ((6, 64, 64, 1), RP, 1.0),
    ((128, 64, 64, 3), RPQXY, 1.0),
    ((2, 17, 23, 3), RP, 1.0),  # a row end that is no multiple of the 4-pixel group
    ((4, 32, 32, 2), RP, 1.0),  # 8-byte (bf16) and 32-byte (f32) groups
    ((4, 32, 32, 4), RP, 1.0),
    ((2, 16, 16, 5), RP, 1.0),  # C above 4: the run-time channel loop
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("shape,family,scale", CASES)
def test_warp_kernel_matches_plain(cuda, shape, family, scale, pad, dtype, tol):
    gen = torch.Generator().manual_seed(0)
    img = torch.rand(shape, generator=gen).to(cuda, dtype)
    code = (torch.rand(shape[0], family.n_affine, generator=gen) * 2 - 1) * scale
    matrix = code_to_matrix(family, code.to(cuda))
    before = stn_cuda.launch_count
    got = warp_affine(img, matrix, pad)
    assert stn_cuda.launch_count == before + 1
    ref = warp_affine_plain(img, matrix, pad)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad", ["border", "zeros"])
@pytest.mark.parametrize("matrices", ["align", "rp"])
@pytest.mark.parametrize("channels", [1, 3])
def test_warp_kernel_matches_plain_at_dsprites_shapes(cuda, channels, matrices, pad, dtype, tol):
    img, matrix = sprite_warp_inputs(channels, matrices, cuda)
    img = img.to(dtype)
    before = stn_cuda.launch_count
    got = warp_affine(img, matrix, pad)
    assert stn_cuda.launch_count == before + 1
    ref = warp_affine_plain(img, matrix, pad)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("pad", ["border", "zeros"])
def test_warp_kernel_matches_plain_at_the_mnist_shape(cuda, pad, dtype, tol):
    from eadgan_tpu_torch.utils.profiler import mnist_warp_inputs

    img, matrix = mnist_warp_inputs(cuda)
    img = img.to(dtype)
    before = stn_cuda.launch_count
    got = warp_affine(img, matrix, pad)
    assert stn_cuda.launch_count == before + 1
    ref = warp_affine_plain(img, matrix, pad)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (128, 32, 32, 1)
    assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("batch", [500, 333, 1])
@pytest.mark.parametrize("channels", [1, 3])
def test_warp_kernel_matches_plain_at_the_scorer_shapes(cuda, channels, batch):
    img, matrix = sprite_warp_inputs(channels, "align", cuda, batch=batch)
    before = stn_cuda.launch_count
    got = warp_affine(img, matrix, "zeros")
    assert stn_cuda.launch_count == before + 1
    ref = warp_affine_plain(img, matrix, "zeros")
    torch.cuda.synchronize()
    assert (got - ref).abs().max().item() <= 2e-5


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_representer_on_the_card_matches_the_cpu(cuda, colored):
    import numpy as np

    from eadgan_tpu_torch.cli.score import fresh_encoders
    from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
    from eadgan_tpu_torch.eval import Representer

    sprites = synthetic_dsprites(n_pos=6).imgs
    imgs = sprites[np.random.default_rng(0).choice(len(sprites), 1001, replace=False)]
    reps = {}
    for dev in ("cpu", "cuda"):
        before = stn_cuda.launch_count
        reps[dev] = Representer(*fresh_encoders(colored), colored=colored, device=dev)(imgs)
    assert stn_cuda.launch_count == before + 3  # batches of 500, 500 and 1
    np.testing.assert_array_equal(reps["cpu"][:, 0], reps["cuda"][:, 0])
    np.testing.assert_allclose(reps["cpu"][:, 1:], reps["cuda"][:, 1:], rtol=0, atol=1e-4)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_mnist_step_matches_cpu_and_launches_the_warp_once(cuda, compute):
    import numpy as np

    from eadgan_tpu_torch.train.config import MnistConfig
    from eadgan_tpu_torch.train.gan_mnist import init_mnist_gan_state, make_mnist_gan_step
    from eadgan_tpu_torch.train.pretrain import approximator_model
    from eadgan_tpu_torch.utils.profiler import build_step, first_batch

    rtol = {"f32": (1e-3, 3e-2), "bf16": (1e-2, 5e-2)}[compute]
    dtype = torch.bfloat16 if compute == "bf16" else None
    config = MnistConfig(batch_size=4)
    step = make_mnist_gan_step(config)
    states = {dev: init_mnist_gan_state(config, approximator_model(1), device=dev, seed=0,
                                        dtype=dtype) for dev in ("cpu", "cuda")}
    _, _, data, prep = build_step("mnist", batch_size=4, device="cpu")
    imgs = first_batch(data, prep, 4, device="cpu")
    rng = np.random.default_rng(0)
    for s in range(3):
        fixed = {"z": rng.standard_normal((4, 62)).astype(np.float32),
                 "sampled_labels": rng.integers(0, 10, 4),
                 "code": rng.uniform(-1, 1, (4, 7)).astype(np.float32)}
        before = stn_cuda.launch_count
        _, on_card = step(states["cuda"], imgs.to(cuda), fixed=fixed)
        torch.cuda.synchronize()
        assert stn_cuda.launch_count == before + 1
        _, on_cpu = step(states["cpu"], imgs, fixed=fixed)
        for k, ref in on_cpu.items():
            torch.testing.assert_close(on_card[k].cpu(), ref, rtol=rtol[0 if s == 0 else 1], atol=0)


def test_folded_bf16_generator_matches_f32_eval_on_the_card(cuda):
    from eadgan_tpu_torch.models import CelebaGenerator
    from eadgan_tpu_torch.ops.quant import make_celeba_infer

    sd, x = generator_inputs(128, cuda)
    model = CelebaGenerator()
    model.load_state_dict(sd)
    model = model.to(cuda).eval()
    with torch.no_grad():
        ref = model(*x)
    got = make_celeba_infer(sd, quant="none", compute_dtype=torch.bfloat16, device=cuda)(*x)
    assert got.dtype == torch.float32 and got.shape == (128, 3, 64, 64)
    assert (got - ref).abs().max().item() <= 2e-2


def test_gray_rp_step_launches_the_warp_three_times(cuda):
    from eadgan_tpu_torch.train.config import SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    config = SpritesGanConfig(batch_size=4)
    state = init_sprites_gan_state(config, pxy_encoder(False, seed=1), device=cuda, seed=0)
    step = make_sprites_gan_step(config)
    img, _ = sprite_warp_inputs(1, "rp", cuda)
    before = stn_cuda.launch_count
    _, metrics = step(state, img[:4].contiguous())
    torch.cuda.synchronize()
    assert stn_cuda.launch_count == before + 3
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_warp_kernel_rejects_non_contiguous(cuda):
    img = torch.rand(2, 3, 16, 16, device=cuda).permute(0, 2, 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        stn_cuda.warp_affine_cuda(img, torch.eye(3, device=cuda).expand(2, 3, 3))


CONV_CASES = [
    (2, 8, 16, 32),
    (2, 8, 16, 40),  # Cout no multiple of the 128-channel tile
    (2, 32, 128, 256),
    (128, 32, 128, 256),  # the CelebA discriminator's layer 2 at batch 128
    (3, 6, 24, 136),
    (2, 8, 24, 40),  # Cin no multiple of the 64-channel K step
    (2, 10, 72, 264),  # ... and Cout above 256: two N tiles
    (1, 34, 64, 128),  # Ho = 17: no multiple of the 8 x 16 pixel tile
    (1, 32, 128, 256),  # a single image
    (256, 32, 128, 256),  # 512 tiles: four waves of the persistent grid
]


def _conv_inputs(device, batch, hw, cin, cout, bias=0.01):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(batch, hw, hw, cin, generator=gen)
    w = 0.05 * torch.randn(4, 4, cin, cout, generator=gen)
    b = bias * torch.randn(cout, generator=gen)
    return [t.to(device, torch.bfloat16) for t in (x, w, b)]


@pytest.mark.parametrize("bias", [0.01, 1.0])
@pytest.mark.parametrize("batch,hw,cin,cout", CONV_CASES)
def test_fused_conv_kernel_matches_plain(cuda, batch, hw, cin, cout, bias):
    x, w, b = _conv_inputs(cuda, batch, hw, cin, cout, bias)
    before = fused_conv_cuda.launch_count
    got = fused_conv_lrelu(x, w, b)
    assert fused_conv_cuda.launch_count == before + 1
    ref = fused_conv_lrelu_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    diff = mismatch(got, ref)
    assert diff["rel"] < 2e-2 and diff["elem"] <= 1.0, diff


def test_tma_wgmma_bringup_steps_pass(cuda):
    """The step-wise bring-up checks of the conv kernel's blocks: a plain
    GEMM through its descriptors, its A box, then the kernel itself."""
    from eadgan_tpu_torch.tools import tma_wgmma_check

    assert tma_wgmma_check.main([]) == 0


def test_fused_conv_kernel_rejects(cuda):
    x, w, b = _conv_inputs(cuda, 2, 8, 16, 32)
    with pytest.raises(TypeError, match="bfloat16"):
        fused_conv_cuda.fused_conv_lrelu_cuda(x.float(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_conv_cuda.fused_conv_lrelu_cuda(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_conv_cuda.fused_conv_lrelu_cuda(x[..., :12].contiguous(), w[:, :, :12].contiguous(), b)
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_conv_cuda.fused_conv_lrelu_cuda(x, w.clone().requires_grad_(True), b)


@pytest.mark.parametrize("pipeline", ["pxy", "rp", "celeba", "mnist"])
def test_chained_step_matches_per_step(cuda, pipeline):
    from eadgan_tpu_torch.tools.chain_check import run_check

    report = run_check(pipeline, steps=8, chain=4, batch=16)
    assert report["ok"], report
    assert report["spread"] == report["err"] == 0 and report["event_steps"] == [0, 4]


@pytest.mark.parametrize("pipeline", ["celeba", "rp"])
def test_graceful_stop_equals_a_run_to_the_same_step(cuda, pipeline):
    """A stop requested by an inline event mid-run (``run_epochs`` chained
    on the card) leaves, as ``on_shutdown`` copies it to the host, the
    train state of a ``max_steps`` run to the same step, bit for bit
    (``tools/stop_check.py``, cuDNN deterministic), at that window's end."""
    from eadgan_tpu_torch.tools.stop_check import run_stop_check

    report = run_stop_check(pipeline, batch=16, chain=4, stop_at=5, n_images=256)
    assert report["ok"], report
    assert report["stopped_at"] == 8
    assert report["warp_launches"] == report["stopped_at"] * (1 if pipeline == "celeba" else 3)


def test_warp_launches_counted_per_replay(cuda):
    from eadgan_tpu_torch.train.chain import make_chained_step
    from eadgan_tpu_torch.train.config import SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    config = SpritesGanConfig(batch_size=4)
    state = init_sprites_gan_state(config, pxy_encoder(False, seed=1), device=cuda, seed=0)
    img, _ = sprite_warp_inputs(1, "rp", cuda)
    window = img[:4].contiguous().expand(4, 4, 64, 64, 1)
    chained = make_chained_step(make_sprites_gan_step(config), generators=(state.rng,))
    before, captured = stn_cuda.launch_count, stn_cuda.captured_count
    chained(state, (), window)  # one eager step, the capture, three replays
    torch.cuda.synchronize()
    assert stn_cuda.captured_count == captured + 3 and chained.captured_warps == 3
    assert stn_cuda.launch_count == before + 3 + 3 * 3
    _, packed = chained(state, (), window)  # four replays
    torch.cuda.synchronize()
    assert stn_cuda.launch_count == before + 3 + 7 * 3
    assert stn_cuda.captured_count == captured + 3  # captured once per run
    assert packed.shape == (4, 6) and torch.isfinite(packed).all()


@pytest.mark.parametrize("first,then", [(32, 1), (1, 32)], ids=["chained_then_per_step",
                                                              "per_step_then_chained"])
def test_train_state_resumes_across_chain_settings(cuda, tmp_path, monkeypatch, first, then):
    """240 sprites at batch 16: 15 batches an epoch, one epoch.  The first
    run saves its state at step 0 and stops after 3 steps; the resumed
    run continues from step 1 to the planned total."""
    import json
    import math

    from eadgan_tpu_torch.cli import rp

    monkeypatch.setenv("EADGAN_PLATFORM", "cuda")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")
    common = ["--batch_size", "16", "--n_epochs", "1", "--sample_interval", "1000",
              "--allow_fresh_pxy", "--keep_states", "2", "--data_dir", str(tmp_path),
              "--out_dir", str(tmp_path / "images"), "--ckpt_dir", str(tmp_path)]
    rp.main(common + ["--chain", str(first), "--max_steps", "3", "--jsonl", str(tmp_path / "a.jsonl")])
    rp.main(common + ["--chain", str(then), "--resume", "auto", "--jsonl", str(tmp_path / "b.jsonl")])
    records = [json.loads(line) for line in (tmp_path / "b.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == list(range(1, 15))
    assert all(math.isfinite(r[k]) for r in records for k in rp.METRIC_KEYS)


@pytest.fixture
def no_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("pipeline,dtype", [("rp", None), ("celeba", torch.bfloat16)],
                         ids=["rp_f32", "celeba_bf16"])
def test_world1_data_parallel_and_zero_bit_equal_to_plain(cuda, no_group, pipeline, dtype):
    from eadgan_tpu_torch.tools.dp_check import run_dp_check

    report = run_dp_check(pipeline, dtype, steps=8, chain=4, batch=16, time_windows=0)
    assert report["backend"] == "nccl"
    assert report["ok"], report
    assert report["all_reduces_per_step"]["dp"] > 0


def test_nccl_ranks_sharing_the_card_raise(cuda, no_group, monkeypatch):
    import torch.distributed as dist

    from eadgan_tpu_torch.parallel import multihost

    monkeypatch.delenv("EADGAN_DIST_BACKEND", raising=False)
    if torch.cuda.device_count() > 1:
        pytest.skip("needs a machine with one card")
    for rank in (0, 1):
        with pytest.raises(RuntimeError, match="NCCL cannot run two ranks on one card"):
            multihost.initialize("localhost:1", 2, rank, device="cuda")
    assert not dist.is_initialized()


def test_gloo_chain_on_the_card_raises(cuda, no_group, monkeypatch):
    from eadgan_tpu_torch.parallel import join_local, multihost
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils.profiler import build_step

    monkeypatch.setenv("EADGAN_DIST_BACKEND", "gloo")
    join_local("cuda")
    assert multihost.backend() == "gloo"
    state, step, data, prep = build_step("rp", 8)
    with pytest.raises(ValueError, match="cannot be captured in a CUDA graph"):
        run_epochs(n_epochs=1, data=data, batch_size=8, state=state, step_fn=step, on_batch=None,
                   device="cuda", max_steps=2, chain=4, data_parallel=True, **prep)


def test_grid_1x1_on_the_card_bit_equal_to_no_grid(cuda, no_group):
    """The CelebA bf16 step at batch 16 on a (1, 1) grid in a NCCL group
    of one against the plain step, 3 steps from copies of one state:
    bit-equal, no model-axis collective."""
    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.parallel.mesh import model_collectives, reset_model_collectives
    from eadgan_tpu_torch.tools.chain_check import _cudnn_deterministic
    from eadgan_tpu_torch.tools.dp_check import _equal
    from eadgan_tpu_torch.tools.tp_check import inputs
    from eadgan_tpu_torch.train.chain import snapshot_state
    from eadgan_tpu_torch.train.checkpoint import train_state_payload
    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

    device = parallel.join_local("cuda")
    mesh = parallel.default_mesh(1)
    config = CelebaConfig(batch_size=16)
    state = init_celeba_gan_state(config, device=device, seed=0, dtype=torch.bfloat16)
    twin = parallel.shard_model_params(mesh, parallel.replicate(snapshot_state(state)))
    imgs = torch.from_numpy(inputs(16, 0)[0]).to(device)
    grid = parallel.data_parallel_step(make_celeba_gan_step(config), mesh)
    reset_model_collectives()
    with _cudnn_deterministic():
        for _ in range(3):
            state, m = make_celeba_gan_step(config)(state, imgs)
            twin, m_grid = grid(twin, imgs)
            assert all(torch.equal(m[k], m_grid[k]) for k in m)
    assert _equal(train_state_payload(state), train_state_payload(twin))
    assert all(v["count"] == 0 for v in model_collectives().values())


def test_grid_1x2_of_ranks_sharing_the_card_matches_one_rank(cuda, no_group):
    """``tools/tp_check.py`` on the card: two gloo ranks as (1, 2), the
    CelebA f32 step at ``chip_smoke.py`` phase 8's global batch of 128 for
    2 steps against one rank at the JAX 2-D test's bars; each rank
    launched the warp once a step and holds half of the large layers,
    and the replicated tensors agree bit for bit.  (At a global batch of
    8 the step-1 bar is at the card's noise for any grid: the data axis
    alone as (4, 1) deviates as far as (1, 2), 1.09e-3 against 1.16e-3,
    and meets it only through its atol; PERF.md section 6.)"""
    from eadgan_tpu_torch.tools.tp_check import run_tp_check

    report = run_tp_check(grid=(1, 2), batch=128, steps=2, device="cuda")
    assert report["vs_one_rank"]["ok"], report["vs_one_rank"]
    assert report["params_step0"]["g"]["ok"], report["params_step0"]
    assert report["ranks_agree"] and report["replicas_agree"]["ok"] and report["ok"]
    assert report["warp_launches_by_rank"] == {0: 2, 1: 2}
    assert all(b["params"] < 0.55 * report["one_rank_bytes"]["params"]
               for b in report["bytes_by_rank"].values())


def test_jax_2d_grid_of_ranks_sharing_the_card_matches_one_rank(cuda, no_group):
    """The JAX package's own 2-D test on the card: eight gloo ranks as
    (4, 2), the CelebA f32 step at its global batch of 8 for 3 steps
    against one rank at its bars (losses rtol 2e-4, 1e-3, 1e-2; G's
    parameters after step 0), every rank's replicated tensors bit-equal
    and the model-axis broadcast of replicated gradients once an
    optimizer step."""
    from eadgan_tpu_torch.tools.tp_check import run_tp_check

    report = run_tp_check(grid=(4, 2), batch=8, steps=3, device="cuda")
    assert report["vs_one_rank"]["ok"], report["vs_one_rank"]
    assert report["params_step0"]["g"]["ok"], report["params_step0"]
    assert report["ranks_agree"] and report["replicas_agree"]["ok"] and report["ok"]
    assert report["warp_launches_by_rank"] == {r: 3 for r in range(8)}
    assert all(step["sync"]["count"] == 3 for step in report["model_collectives_by_step"])


# the generator's int8 layers: (H, Cin, Cout) of the input of layers 1-3
INT8_LAYERS = [(4, 1024, 512), (8, 512, 256), (16, 256, 128)]


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("batch", [128, 100, 3])
@pytest.mark.parametrize("h,cin,cout", INT8_LAYERS)
def test_int8_convt_kernel_equals_plain(cuda, h, cin, cout, batch, out_dtype):
    """Bit-equal, float epilogue included: the int32 sums are exact on
    both sides and the epilogue rounds the same three operations (and the
    same bf16 rounding); the abs-max word equals the plain output's."""
    from eadgan_tpu_torch.ops import quant_cuda
    from eadgan_tpu_torch.ops.quant import int8_convt_relu, int8_convt_relu_plain, output_amax_plain

    xq, a_scale, layer, _ = int8_layer_inputs(batch, h, cin, cout)
    ref = int8_convt_relu_plain(xq, a_scale, layer.wq, layer.w_scale, layer.bias, out_dtype)
    card = type(layer)(*(t.to(cuda) for t in (layer.wq, layer.wp, layer.w_scale, layer.bias)))
    before = quant_cuda.launch_count["int8_convt"]
    got, amax = int8_convt_relu(xq.to(cuda), a_scale.to(cuda), card, out_dtype, with_amax=True)
    torch.cuda.synchronize()
    assert quant_cuda.launch_count["int8_convt"] == before + 1
    assert got.shape == (batch, 2 * h, 2 * h, cout) and got.dtype == out_dtype
    assert torch.equal(got.cpu(), ref)
    assert amax.shape == () and amax.dtype == torch.float32
    assert torch.equal(amax.cpu(), output_amax_plain(ref))
    assert (ref > 0).float().mean() > 0.2  # the ReLU left real values to compare


def _tie_activation(shape, seed=0):
    """float32 values whose quotient by the scale is exact: the scale is
    2^-3 (max |x| = 127 / 8), and a third of the values sit on .5 ties."""
    gen = torch.Generator().manual_seed(seed)
    k = torch.randint(-126, 127, shape, generator=gen).float()
    tie = torch.rand(shape, generator=gen) < 1 / 3
    x = (k + tie.float() * torch.where(k < 0, -0.5, 0.5)) / 8
    x.view(-1)[7] = 127 / 8
    return x


@pytest.mark.parametrize("given_amax", [False, True], ids=["own_amax", "given_amax"])
@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("shape", [(128, 1024, 4, 4), (100, 512, 8, 8), (3, 256, 16, 16),
                                   (2, 12, 3, 5)])
def test_quantize_int8_kernel_equals_plain(cuda, shape, nhwc, given_amax):
    """Bit-equal from NCHW and NHWC, with exact .5 ties, normal values, a
    -0.0 among them and all zeros; with the kernel's own abs-max (two
    launches) and with the abs-max given (one launch)."""
    from eadgan_tpu_torch.ops import quant_cuda
    from eadgan_tpu_torch.ops.quant import (output_amax_plain, quantize_activation,
                                            quantize_activation_plain)

    gen = torch.Generator().manual_seed(1)
    normal = torch.randn(shape, generator=gen) * 3
    normal.view(-1)[3] = -0.0
    for x in (_tie_activation(shape), normal, torch.zeros(shape)):
        if nhwc:
            x = x.permute(0, 2, 3, 1).contiguous()
        ref_q, ref_scale = quantize_activation_plain(x, nhwc)
        amax = output_amax_plain(x).to(cuda) if given_amax else None
        before = quant_cuda.launch_count["quantize_int8"]
        q, scale = quantize_activation(x.to(cuda), nhwc, amax)
        torch.cuda.synchronize()
        # abs-max, then quantize; one launch when the abs-max is given
        assert quant_cuda.launch_count["quantize_int8"] == before + (1 if given_amax else 2)
        assert q.dtype == torch.int8 and q.shape == ref_q.shape and scale.shape == ()
        assert torch.equal(q.cpu(), ref_q) and torch.equal(scale.cpu(), ref_scale)


def test_int8_generator_on_the_card_matches_the_cpu(cuda):
    """The int8 forward on the card against the CPU's plain one, float32
    ends on both (TF32 off): layer 0's sums in other orders can move an
    activation across a rounding boundary of its quantization, one step
    of 1/127 of the tensor's range, so 2e-2 absolute on tanh outputs, the
    bar of the bf16 comparisons."""
    from eadgan_tpu_torch.ops import quant_cuda
    from eadgan_tpu_torch.ops.quant import make_celeba_infer

    sd, x = generator_inputs(8, "cpu")
    ref = make_celeba_infer(sd, quant="int8", compute_dtype=torch.float32)(*x)
    before = dict(quant_cuda.launch_count)
    got = make_celeba_infer(sd, quant="int8", compute_dtype=torch.float32, device=cuda)(
        *(t.to(cuda) for t in x))
    torch.cuda.synchronize()
    assert quant_cuda.launch_count["int8_convt"] == before["int8_convt"] + 3
    # layer 1's input takes an abs-max launch; layers 2 and 3 get theirs from int8_convt
    assert quant_cuda.launch_count["quantize_int8"] == before["quantize_int8"] + 4
    assert got.dtype == torch.float32 and got.shape == (8, 3, 64, 64)
    assert (got.cpu() - ref).abs().max().item() <= 2e-2


def test_int8_kernels_reject(cuda):
    from eadgan_tpu_torch.ops import quant_cuda

    x = torch.rand(2, 8, 4, 4, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        quant_cuda.quantize_int8_cuda(x.cpu(), False)
    with pytest.raises(TypeError, match="float32"):
        quant_cuda.quantize_int8_cuda(x.double(), False)
    with pytest.raises(ValueError, match="contiguous"):
        quant_cuda.quantize_int8_cuda(x.permute(0, 2, 3, 1), True)
    with pytest.raises(ValueError, match="multiple of 4"):
        quant_cuda.quantize_int8_cuda(x[:, :6].contiguous(), False)

    with pytest.raises(TypeError, match="int32"):
        quant_cuda.quantize_int8_cuda(x, False, torch.zeros((), device=cuda))
    with pytest.raises(ValueError, match="one int32 word"):
        quant_cuda.quantize_int8_cuda(x, False, torch.zeros(2, dtype=torch.int32, device=cuda))

    xq, a_scale, layer, _ = int8_layer_inputs(2, 4, 64, 16)
    args = [t.to(cuda) for t in (xq, layer.wp, a_scale, layer.w_scale, layer.bias)]
    quant_cuda.int8_convt_cuda(*args)  # the arguments as they are pass
    bits = torch.empty((), dtype=torch.int32, device=cuda)
    out = quant_cuda.int8_convt_cuda(*args, out_dtype=torch.bfloat16, amax_out=bits)
    assert out.dtype == torch.bfloat16
    for dtype in (torch.float16, torch.int8, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            quant_cuda.int8_convt_cuda(*args, out_dtype=dtype)
    with pytest.raises(TypeError, match="int32"):
        quant_cuda.int8_convt_cuda(*args, amax_out=torch.zeros((), device=cuda))
    with pytest.raises(ValueError, match="must divide 128"):  # W = 3: no tile of whole rows
        quant_cuda.int8_convt_cuda(args[0][:, :, :3].contiguous(), *args[1:])
    bad = list(args)
    bad[0] = args[0].cpu()
    with pytest.raises(ValueError, match="CUDA"):
        quant_cuda.int8_convt_cuda(*bad)
    bad[0] = args[0].float()
    with pytest.raises(TypeError, match="int8"):
        quant_cuda.int8_convt_cuda(*bad)
    bad[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        quant_cuda.int8_convt_cuda(*bad)
    bad = list(args)
    bad[1] = args[1][:, :, :, :32].contiguous()
    with pytest.raises(ValueError, match="wp must be"):
        quant_cuda.int8_convt_cuda(*bad)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant_cuda.int8_convt_cuda(args[0][..., :32].contiguous(), bad[1], *args[2:])


def test_event_snapshots_survive_replays_on_the_card(cuda, monkeypatch):
    """The chained engine's events on its worker: each callback sleeps
    while the engine replays the next windows, which write the live state
    in place, then reads the state it was handed.  Under deterministic
    cuDNN it reads, bit for bit, the parameters and batch that the
    per-step engine's callback reads at that step, and the inline chained
    callback's (``EADGAN_SYNC_EVENTS=1``)."""
    import time

    from eadgan_tpu_torch.train.chain import snapshot_state
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils.profiler import build_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    state0, step, data, prep = build_step("pxy", 16)
    runs = {}
    for name, chain, sync in (("per_step", 1, "0"), ("inline", 4, "1"), ("worker", 4, "0")):
        monkeypatch.setenv("EADGAN_SYNC_EVENTS", sync)
        reads = []

        def on_batch(i, st, metrics, batch, reads=reads):
            if i % 4 == 0:
                time.sleep(0.2)
                params = torch.cat([p.detach().flatten() for p in st.model.parameters()])
                reads.append((i, params.cpu(), batch[0].cpu()))

        final = run_epochs(n_epochs=1, data=data, batch_size=16, state=snapshot_state(state0),
                           step_fn=step, on_batch=on_batch, device="cuda", max_steps=12,
                           chain=chain, chain_periods=(4,), **prep)
        torch.cuda.synchronize()
        assert final.step == 12
        runs[name] = reads
    assert [r[0] for r in runs["worker"]] == [0, 4, 8]
    for other in ("per_step", "inline"):
        for (i, pa, ba), (j, pb, bb) in zip(runs[other], runs["worker"]):
            assert i == j and torch.equal(pa, pb) and torch.equal(ba, bb), (other, i)


# --- the Adam kernel (ops/adam_cuda.py) ---------------------------------------------------------


def test_adam_kernel_matches_plain_on_celeba_parameters(cuda):
    """Five steps of CelebA's three optimizers on its real parameters,
    fresh gradients before each: the kernel against the plain version run
    beside it on the card (``tools/adam_bench.py::kernel_vs_plain``).
    Both compute in float32 in the same order, but nvcc contracts a
    multiply and an add into one FMA where PyTorch's kernels round twice:
    the moments part by a few roundings (1e-5 of the tensor's largest),
    the parameters, within [-1, 1] and moved ~lr a step, by a few ulps of
    1 (1e-6 absolute, three orders under a step's update); the step
    counts are exact."""
    from eadgan_tpu_torch.tools.adam_bench import kernel_vs_plain

    before = adam_cuda.launch_count
    errs = kernel_vs_plain(cuda, steps=5)
    assert adam_cuda.launch_count == before + 5 * 3  # one launch a step() of each optimizer
    assert errs["step"] == 0.0
    assert errs["param"] <= 1e-6, errs
    assert errs["exp_avg"] <= 1e-5 and errs["exp_avg_sq"] <= 1e-5, errs


# sizes across the chunk (4,096) and 4-element edges, and views whose
# base is 4 or 8 bytes past a 16-byte boundary (the per-element path)
ADAM_SIZES = [1, 3, 4, 4095, 4096, 4097, 12289, 300_000]


def _adam_tensors(device, offset):
    gen = torch.Generator(device=device).manual_seed(offset)

    def tensor(n, scale=1.0):
        base = torch.randn(n + offset, generator=gen, device=device) * scale
        return base[offset:]

    params = [tensor(n) for n in ADAM_SIZES]
    grads = [[tensor(n, 1e-2) for n in ADAM_SIZES] for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("offset", [0, 1, 2], ids=["aligned", "4_bytes_off", "8_bytes_off"])
def test_adam_kernel_matches_plain_on_ragged_and_misaligned_tensors(cuda, offset):
    params, grads = _adam_tensors(cuda, offset)
    twins = [p.clone() for p in params]
    kernel_state = [[torch.zeros_like(p), torch.zeros_like(p), torch.zeros((), device=cuda)]
                    for p in params]
    plain_state = [[torch.zeros_like(p), torch.zeros_like(p), torch.zeros((), device=cuda)]
                   for p in params]
    done = torch.zeros(1, dtype=torch.int32, device=cuda)
    for g in grads:
        adam_cuda.adam_cuda(params, g, *zip(*kernel_state), 1e-3, 0.5, 0.999, 1e-8, done)
        adam_cuda.adam_plain(twins, g, *zip(*plain_state), 1e-3, 0.5, 0.999, 1e-8)
    torch.cuda.synchronize()
    assert done.item() == 0
    for p, t, (m, v, s), (pm, pv, ps) in zip(params, twins, kernel_state, plain_state):
        assert float(s) == float(ps) == 3
        assert (p - t).abs().max().item() <= 1e-6
        for a, b in ((m, pm), (v, pv)):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_adam_step_captured_and_replayed_equals_eager(cuda):
    """One eager step, then a step captured into a CUDA graph and replayed
    three times, against four eager steps from the same start and
    gradients: the same bits in every parameter, moment and step count
    (the counts advance on the card at each replay, and the bias
    corrections with them)."""
    from eadgan_tpu_torch.train.state import adam

    params, grads = _adam_tensors(cuda, 0)
    runs = []
    for captured in (False, True):
        ps = [p.clone().requires_grad_() for p in params]
        opt = adam(ps, 1e-3)
        for p, g in zip(ps, grads[0]):
            p.grad = g.clone()
        opt.step()
        if captured:
            before = adam_cuda.captured_count, adam_cuda.launch_count
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                opt.step()
            assert (adam_cuda.captured_count, adam_cuda.launch_count) == (before[0] + 1, before[1])
            for _ in range(3):
                graph.replay()
        else:
            for _ in range(3):
                opt.step()
        torch.cuda.synchronize()
        runs.append((ps, opt))
    (eager, opt_e), (replayed, opt_r) = runs
    for a, b in zip(eager, replayed):
        assert torch.equal(a, b)
        sa, sb = opt_e.state[a], opt_r.state[b]
        assert float(sa["step"]) == float(sb["step"]) == 4
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


def test_adam_kernel_rejects(cuda):
    p = torch.zeros(8, 4, device=cuda)
    args = lambda p: ([p], [torch.zeros_like(p)], [torch.zeros_like(p)], [torch.zeros_like(p)],
                      [torch.zeros((), device=cuda)], 1e-3, 0.5, 0.999, 1e-8,
                      torch.zeros(1, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        adam_cuda.adam_cuda(*args(p.t()))
    with pytest.raises(TypeError, match="float32"):
        adam_cuda.adam_cuda(*args(p.double()))
    with pytest.raises(TypeError, match="float32"):
        adam_cuda.adam_cuda(*args(p.bfloat16()))
    bad = list(args(p))
    bad[4] = [torch.zeros(())]
    with pytest.raises(ValueError, match="on cpu"):
        adam_cuda.adam_cuda(*bad)


def test_adam_launches_counted_per_step_and_replay(cuda):
    """A gray rp step steps two optimizers, ``opt_d`` and ``opt_info``: two
    launches an eager step, two captured, two counted a replay."""
    from eadgan_tpu_torch.train.chain import make_chained_step
    from eadgan_tpu_torch.train.config import SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    config = SpritesGanConfig(batch_size=4)
    state = init_sprites_gan_state(config, pxy_encoder(False, seed=1), device=cuda, seed=0)
    img, _ = sprite_warp_inputs(1, "rp", cuda)
    window = img[:4].contiguous().expand(4, 4, 64, 64, 1)
    chained = make_chained_step(make_sprites_gan_step(config), generators=(state.rng,))
    before, captured = adam_cuda.launch_count, adam_cuda.captured_count
    chained(state, (), window)  # one eager step, the capture, three replays
    torch.cuda.synchronize()
    assert adam_cuda.captured_count == captured + 2 and chained.captured_adams == 2
    assert adam_cuda.launch_count == before + 2 + 3 * 2
    chained(state, (), window)  # four replays
    torch.cuda.synchronize()
    assert adam_cuda.launch_count == before + 2 + 7 * 2
    assert all(float(s["step"]) == 8 for s in state.opt_info.state.values())


# --- the spectral norm's kernels (ops/sn_cuda.py) --------------------------------------------------

# CelebA's discriminator; the rp, colored rp and MNIST steps' layers
SN_SHAPES = [(128, 3, 4, 4), (256, 128, 4, 4), (512, 256, 4, 4), (1024, 512, 4, 4),
             (32, 1, 4, 4), (32, 3, 4, 4), (32, 32, 4, 4), (64, 32, 4, 4), (64, 64, 4, 4),
             (128, 1024), (128, 128), (3, 128), (4, 128), (7, 128),
             (16, 1, 3, 3), (32, 16, 3, 3), (64, 32, 3, 3), (128, 64, 3, 3), (1, 512), (10, 512),
             (62, 512)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, None], ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", SN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_sn_kernels_match_plain(cuda, shape, dtype):
    from eadgan_tpu_torch.tools.sn_bench import kernel_vs_plain

    r = kernel_vs_plain(shape, dtype, cuda)
    assert r["wn_bit_equal"] and r["state_written"], r
    assert r["sigma_gap"] <= 1e-5 and r["u_gap"] <= 1e-5, r
    assert r["grad_gap"] <= 1e-4 and r["closed_form_gap"] <= 1e-5, r


@pytest.mark.parametrize("shape", [(32, 32, 4, 4), (512, 256, 4, 4)], ids=["one_block", "large"])
def test_sn_kernels_sigma_zero(cuda, shape):
    from eadgan_tpu_torch.tools.sn_bench import kernel_vs_plain

    r = kernel_vs_plain(shape, torch.bfloat16, cuda, zero=True)
    assert r["sigma"] == 0.0 and r["wn_bit_equal"] and r["grad_equal_g"], r


def _sn_layer(cuda, shape):
    from eadgan_tpu_torch.models.layers import SNConv

    layer = SNConv(shape[1], shape[0], 4, 2, 1, dtype=torch.bfloat16).to(cuda)
    layer.u.copy_(torch.nn.functional.normalize(torch.randn(shape[0], device=cuda), dim=0))
    return layer


@pytest.mark.parametrize("shape", [(32, 32, 4, 4), (512, 256, 4, 4)], ids=["one_block", "large"])
def test_sn_eval_and_no_stat_updates_leave_state(cuda, shape):
    from eadgan_tpu_torch.models.layers import no_stat_updates

    layer = _sn_layer(cuda, shape)
    x = torch.randn(2, shape[1], 8, 8, device=cuda)
    u, sigma = layer.u.clone(), layer.sigma.clone()
    with no_stat_updates(layer):
        layer(x)
    layer.eval()
    layer(x)
    torch.cuda.synchronize()
    assert torch.equal(layer.u, u) and torch.equal(layer.sigma, sigma)
    layer.train()
    out = layer.normalized_weight()
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and not torch.equal(layer.sigma, sigma)


@pytest.mark.parametrize("shape", [(32, 32, 4, 4), (512, 256, 4, 4)], ids=["one_block", "large"])
def test_sn_runs_and_graph_replays_bit_equal(cuda, shape):
    """Eager calls from copies of one layer give the same bits twice; a
    forward and backward captured in a CUDA graph and replayed gives the
    eager call's bits, and is counted as captured, not launched."""
    from eadgan_tpu_torch.ops import sn_cuda

    torch.manual_seed(0)
    base = _sn_layer(cuda, shape)
    g = torch.randn(shape, device=cuda).to(torch.bfloat16)

    def run(layer):
        out = layer.normalized_weight()
        (grad,) = torch.autograd.grad(out, layer.weight, g)
        return out, grad, layer.u, layer.sigma

    runs = []
    for _ in range(2):
        layer = copy.deepcopy(base)
        runs.append([t.clone() for t in run(layer)])
    layer = copy.deepcopy(base)
    static = run(copy.deepcopy(base))  # warm-up on a twin, outside the capture
    per_call = sum(sn_cuda.launches_per_call(layer.weight.numel()))
    before = sn_cuda.captured_count, sn_cuda.launch_count
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run(layer)
    assert (sn_cuda.captured_count, sn_cuda.launch_count) == (before[0] + per_call, before[1])
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(runs[0], runs[1], static):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_sn_launches_counted_per_step_and_replay(cuda):
    """The chained gray rp step: its spectral-norm launches an eager step
    equal the census's (every call through the kernels), captured once and
    counted again at each replay."""
    from eadgan_tpu_torch.ops import sn_cuda
    from eadgan_tpu_torch.tools.sn_bench import census, launches_per_step
    from eadgan_tpu_torch.train.chain import make_chained_step
    from eadgan_tpu_torch.train.config import SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    per_step = launches_per_step(census("rp", 4))
    config = SpritesGanConfig(batch_size=4)
    state = init_sprites_gan_state(config, pxy_encoder(False, seed=1), device=cuda, seed=0,
                                   dtype=torch.bfloat16)
    img, _ = sprite_warp_inputs(1, "rp", cuda)
    window = img[:4].contiguous().expand(4, 4, 64, 64, 1)
    chained = make_chained_step(make_sprites_gan_step(config), generators=(state.rng,))
    before, captured = sn_cuda.launch_count, sn_cuda.captured_count
    chained(state, (), window)  # one eager step, the capture, three replays
    torch.cuda.synchronize()
    assert sn_cuda.captured_count == captured + per_step and chained.captured_sn == per_step
    assert sn_cuda.launch_count == before + 4 * per_step


def test_sn_kernel_rejects(cuda):
    from eadgan_tpu_torch.ops import sn_cuda

    w = torch.zeros(8, 4, device=cuda)
    u, sigma = torch.zeros(8, device=cuda), torch.ones((), device=cuda)
    with pytest.raises(ValueError, match="contiguous float32"):
        sn_cuda.spectral_norm(w.t(), torch.zeros(4, device=cuda), sigma)
    with pytest.raises(ValueError, match="contiguous float32"):
        sn_cuda.spectral_norm(w.double(), u, sigma)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        sn_cuda.spectral_norm(w, u, sigma, torch.float16)
    with pytest.raises(ValueError, match="u must be"):
        sn_cuda.spectral_norm(w, u.cpu(), sigma)
