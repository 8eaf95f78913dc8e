#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port (``eadgan_tpu_torch``) on one
NVIDIA H100.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It needs one
CUDA card and the CUDA toolkit (nvcc) and runs ten phases, failing with
a non-zero exit on the first that fails:

1. environment: card name and power limit, torch/CUDA versions, TF32
   switched off as the CLIs switch it (``cli/common.py::disable_tf32``),
   and the build of every kernel from ``csrc/`` (one nvcc per source, all
   at once);
2. each kernel against its plain PyTorch version on the card: the warp
   over the cases of ``tests/test_stn_pallas.py``, the CelebA shape, the
   edges of its 4-pixel groups (a row end no multiple of 4, C = 2, 4, 5)
   and the dSprites trainers' shapes ((128, 64, 64, 1) binary sprites and
   (128, 64, 64, 3) colorized ones, under the aligner's inverse matrices
   on codes in [-3, 3], some rows wholly outside the image, and under rp
   matrices) and the MNIST step's shape ((128, 32, 32, 1) digits under
   rpqmnxy matrices), in both paddings, f32 and bf16, and the scorer's
   (the Representer's batch of 500 and odd ragged batches, C = 1 and 3,
   under the aligner's inverse matrices in ``zeros``); the fused conv +
   LeakyReLU
   in bf16 over the test shapes, the CelebA discriminator's layer 2 at
   batch 128 and the edges of its tiles (Cout and Cin no multiple of the
   tile, Ho no multiple of 8 or 16, one image, several waves), with the
   probe's small bias and with one as large as the conv output (one JSON
   line per case); the int8 generator's two kernels, ``int8_convt`` and
   ``quantize_int8``, at its three quantized layers' shapes at the CLI's
   batch of 100, bit-equal to their plain versions: ``int8_convt``
   writing float32 and bf16, its abs-max word equal to the plain
   output's; the quantization from layer 1's NCHW input and the others'
   NHWC, with exact .5 ties, -0.0 and all zeros, with its own abs-max and
   with the abs-max given; the Adam kernel (``csrc/adam_fused.cu``) over
   five steps of CelebA's three optimizers on its real parameters against
   its plain version beside it on the card (``tools/adam_bench.py``);
   the spectral norm's kernels (``csrc/spectral_norm.cu``) at CelebA's
   four discriminator shapes and four of the rp step's (two on the large
   path, two on one block), bf16 and float32, against the plain version (``tools/sn_bench.py::
   kernel_vs_plain``: sigma and ``u'`` within 1e-5, the normalized weight
   bit-equal to ``(W / s).to(dtype)`` for the kernels' sigma, the
   gradient within 1e-4 of autograd through the plain version);
3. train steps on the CPU and on the card from the same weights and
   draws, three steps at batch 4: CelebA at the low-lr config in f32 and
   bf16; the pxy step gray and colored in f32; the rp step gray and
   colored in f32 and gray in bf16; the MNIST step in f32 and bf16 and
   the approximator step in f32; then the chained engine (one CUDA graph
   of the step, replayed) against the per-step engine on the card,
   ``run_epochs`` for 8 steps at batch 128 with events every 4, for
   CelebA f32, pxy gray, rp gray and colored and MNIST
   (``tools/chain_check.py``: cuDNN deterministic, two per-step runs on
   the prefetcher, the chained one on the resident dataset and the
   chained one on raw windows bit-equal in every logged loss and event
   batch, the warp counted per replay); and the warp's launches counted per replay
   by its wrapper held against the warp kernels the CUPTI trace of a
   window of 32 replayed gray rp steps shows; the BatchNorm-folded
   bf16 CelebA generator against its float32 eval-mode forward at batch
   128 (2e-2), and the int8 one (``--quant int8``) against it too, PSNR
   above 25 dB and within 0.5; and the scorer's Representer on the CPU and on the card from the
   same weights, gray and colored (continuous 1e-4, category ids equal);
4. the main paths, each with its kernel's launch count set to 0 just
   before and read just after, and the warp's count held exactly (a
   replayed step counts the launches its capture recorded), and the Adam
   kernel's, one launch an optimizer step (3 a CelebA step, 2 an rp step,
   1 a pxy step), also in the traced runs' ``adam.launches``, and the
   spectral norm's ``sn.launches``, the census's launches a CelebA step
   and a gray rp step (the other trainers' are reported): the CelebA
   trainer, ``python -m eadgan_tpu_torch.cli.celeba --batch_size 128
   --max_steps 20`` at its default ``--chain 32`` in f32 on synthetic
   data, saving a train state at step 0 (mid-epoch), then ``--resume
   auto --compute bf16 --chain 1`` continuing it per step to the planned
   total; the dSprites pipeline on synthetic sprites at batch 128,
   chained, ``cli.pxy`` (20 steps, 1 warp a step + 1 for the step-0
   grid), ``cli.rp --encoder_pxy`` on its file (20 steps, 3 warps a step
   + 2 for the grid), ``cli.rp --resume auto --compute bf16 --chain 1``
   to the planned total, ``cli.pxy_color`` and ``cli.rp_color`` (10 steps
   each), and a longer chained ``cli.rp`` on ``EADGAN_SYNTH_POS=8`` (30
   batches an epoch, 90 steps) with ``EADGAN_TRACE``; ``cli.score
   --metric all`` on the gray rp run's files and on the colored run's, on
   ``EADGAN_SYNTH_POS=32`` (61,440 sprites) at its defaults, the warp
   launched once a Representer batch, no scikit-learn; ``cli.gen_imgs
   --quant none``, ``--quant bf16`` and ``--quant int8`` on the CelebA
   run's ``checkpoint_0.tar``, the int8 kernels' launches held exactly
   (8 forwards of 3 int8 layers: 24 ``int8_convt`` and 32
   ``quantize_int8``, two launches for layer 1's input, whose abs-max
   takes a pass of its own, and one for layers 2 and 3's, whose abs-max
   ``int8_convt`` hands on); a CelebA save window
   (grids, ``checkpoint_%d.tar``, the train state) timed inline
   (``EADGAN_SYNC_EVENTS=1``) against the chained engine's event worker; the MNIST pipeline at batch 128 on the
   synthetic digits, ``cli.approximate_rpqmnxy`` (a short run), then
   ``cli.mnist --chain 32`` on its file (32 steps, 1 warp a step + 1 for
   the step-0 grid), then ``cli.generate_image`` on its generator file;
   and the fused conv's probe, ``python -m
   eadgan_tpu_torch.tools.fused_conv_probe`` at its defaults, whose
   record gives the fused conv's kernel and library times;
5. timing with CUDA events: the B=128 CelebA step in f32 and in bf16,
   the rp step gray f32, gray bf16 and colored f32, the MNIST step in
   f32 and bf16 and the approximator step (with images/s and the warp's
   share), each per step and replayed (windows of 32 replays, each
   gathering its batch on the card from the resident dataset as the
   CLIs' graph does, after the eager step and the capture); CelebA
   generator inference at batch 128, the float32 eval forward, the
   folded bf16 one and the int8 one with its PSNR, beside their bounds,
   and the int8 one's unchained steps, both traced by kernel
   (``tools/quant_bench.py``); the int8 kernels at the three layers at
   batch 128, as the int8 forward runs them, beside their bounds, plain
   versions and yardsticks
   (``torch._int_mm`` on the phases' im2col matrices and cuDNN's bf16
   transposed conv; ``torch.amax`` and the quantize expression); the warp beside its bound, its
   plain version and the library call that computes the same function at
   (128, 64, 64, 3), at (128, 64, 64, 1) in both paddings and at the
   MNIST step's (128, 32, 32, 1), and at the scorer's (500, 64, 64, 1)
   and (500, 64, 64, 3) in ``zeros``; the Representer's batch of 500;
   and the fused conv's plain version, bound and host cost per call;
   CelebA's three Adam steps by the Adam kernel beside their bound (28
   bytes an element), its plain version and, as yardsticks, torch's
   fused capturable Adam and the foreach one the port ran before; a
   CelebA step's and an rp step's spectral-norm calls (24 forwards and 20
   backwards, 39 and 33) by the kernels, forwards and backwards apart, in
   a replayed CUDA graph, beside their bound (6 bytes an element forward,
   10 backward) and the plain version (``tools/sn_bench.py``);
6. robustness, CelebA at batch 128 on 8,192 synthetic faces (64 batches
   an epoch): (a) ``run_epochs`` at ``--chain 32`` in f32 under
   deterministic cuDNN, stopped by an inline event at step 40, hands
   ``on_shutdown`` the train state of a ``max_steps`` run to the same
   window end, bit for bit (``tools/stop_check.py``; its warp launches,
   one a step, are this slice's path in the ``kernels`` line); (b)
   ``cli.celeba --max_steps 200`` (f32, ``--chain 32``) gets SIGTERM once
   a logged step reaches 64, exits 86 at a window end S with
   ``celeba_train_state_S.ckpt`` written, and ``--resume auto
   --max_steps 200-S`` ends at step 200 with exit 0 (the seconds from
   SIGTERM to exit and of the final save); (c) ``cli.supervise
   --max_restarts 1 celeba -- ... --watchdog 15`` (bf16) with
   ``EADGAN_FAULT_HANG_STEP=40``: exit 87 with the stall record and the
   thread stacks, the relaunch with ``--resume auto``, exit 0 (the
   seconds from the relaunch to the first logged step); (d) the replayed
   bf16 step through ``run_epochs`` without, then with, the SIGTERM guard
   armed and a 60 s watchdog;
7. data-parallel training (``parallel/``): (a) the CelebA bf16 chained
   trainer through ``run_epochs`` in a NCCL group of one, 64 steps at
   batch 128 from copies of one state under deterministic cuDNN, plain,
   ``data_parallel`` (gradient, BatchNorm and metric all-reduces captured
   in the CUDA graph) and ``data_parallel`` + ``zero_opt``: every logged
   loss and state tensor bit-equal, the all-reduces a step and the
   replayed step of each form (``tools/dp_check.py``); two NCCL ranks on
   the one card refused before either joins, and the chained engine
   refused in a gloo group on the card; (b) two gray rp ranks sharing the
   card over gloo (``EADGAN_DIST_BACKEND=gloo``), ``cli.supervise --ranks
   2 rp -- --data_parallel --chain 1 --compute f32`` at batch 128, 8
   steps, against one rank at the same global batch (losses within the
   CPU tests' tolerance, rank 1's warp launches exactly 3 a step, rank 0
   alone logging, rendering and saving), then SIGTERM to rank 1 alone of
   a gang started directly: both exit 86 at one step with one final train
   state, which ``--resume auto`` continues in one process.  The
   data-parallel runs' warp launches are the paths ``celeba_dp`` and
   ``rp_gang`` of the ``kernels`` line;
8. the model axis (``parallel.shard_model_params``, the CelebA step at
   its published widths on a (data, model) grid, ``tools/tp_check.py``),
   TF32 off, cuDNN deterministic: (a) a NCCL group of one as a (1, 1)
   grid, CelebA bf16 at batch 128 for 16 steps from copies of one state,
   plain against the grid's step: every loss and state tensor bit-equal
   and no model-axis collective; (b) two ranks sharing the card over
   gloo as (1, 2), CelebA f32 at a global batch of 128 for 4 steps
   against one rank at the JAX 2-D test's bars (losses rtol 2e-4 / atol
   1e-5 at step 0, 1e-3 and 1e-2 after; G's parameters after step 0
   within 2.1 Adam steps of ``opt_g`` and ``opt_info`` together, under
   0.5% beyond half of one; D's by the same rule reported), with the bytes of
   parameters and Adam moments each rank holds and the bytes its
   model-axis collectives move a step; (c) four ranks as (2, 2) with
   ZeRO-1, global batch 32, 3 steps with a collective save after 2,
   whose file a (1, 2) grid restores, re-cuts and saves again bit for
   bit, then steps once against the writer's third step.  In (b) and
   (c) every tensor no model shard cuts must hold the same bits on the
   ranks that hold it.  Every rank must exit 0.  The grids' warp launches (one a step on each rank's
   rows) are the paths ``celeba_tp`` ((a) and (b)) and
   ``celeba_tp_zero`` ((c), the resumed ranks included);
9. the host-fed data path and DCI without scikit-learn: (a) the host
   batcher (``csrc/batcher.cpp``, built by g++) bit-equal to its plain
   numpy versions at CelebA's (128, 64, 64, 3) with mixed flips, gray
   rp's (128, 64, 64) and colorized, timed at 1 and 8 threads beside
   numpy, and one CelebA batch onto the card the old way (numpy, a
   pageable copy) against the new (the native gather into pinned memory,
   an asynchronous copy); (b) ``tools/chain_check.py`` for CelebA and
   gray rp with its fourth run, the chained engine on raw windows
   (``EADGAN_DEVICE_DATA_MAX=0``), all four runs bit-equal; (c) the
   per-step engine on its prefetcher through ``cli.celeba --chain 1
   --compute bf16`` (40 steps) and ``cli.rp --chain 1 --compute f32`` (20
   steps), loop step ms and the main thread's wait for a batch; (d)
   ``cli.celeba --compute bf16`` chained for 64 steps on 8,192 faces,
   resident against ``EADGAN_DEVICE_DATA_MAX=0``; (e) ``cli.score
   --metric DCI --dci_regressor LassoCV``, then ``RandomForest``, on the
   rp run's files.  The new runs' warp launches are the paths
   ``celeba_per_step``, ``celeba_rawwin`` and ``rp_per_step``;
10. the JAX package's files (``interop/flax_msgpack.py``,
   ``interop/jax_state.py``), in a temporary directory it removes: (a)
   ``cli.celeba --compute bf16`` at batch 128 for 64 chained steps on
   4,096 faces with ``--sample_interval 4 --keep_states 1`` (states
   saved at steps 0 and 60, the newer kept), that state written with
   ``save_jax_train_state`` and restored as ``--resume`` restores it,
   every tensor (parameters, buffers with ``u``/``sigma``, both Adam
   moments and the step counts of every parameter, the step) bit-equal
   to the state written, then ``cli.celeba --resume <the JAX file>`` for
   32 more steps, its step counter going on from the file's, its losses
   finite and the warp launched once a step; (b) the state's models in a
   JAX-format ``checkpoint_60.tar`` through ``cli.gen_imgs --quant none``
   and ``--quant int8``, every grid bit-equal to the one from the run's
   own ``checkpoint_60.tar``, the int8 kernels' launches held exactly;
   (c) a gray ``cli.rp`` state (``opt_g`` None, ``opt_info`` over G and
   E) through the same round trip and 32 resumed steps (3 warps a step);
   (d) the CelebA state's bytes and the seconds of encode, write, read,
   decode and the whole restore onto the card; (e) the phase within 120
   s.  The resumed runs' warp launches are the paths ``celeba_jax`` and
   ``rp_jax``, and the int8 kernels' launches on the JAX-format tar the
   path ``gen_imgs_jax``.

Its last lines are the ``{"kernels": [...]}`` record, the ``nvidia-smi``
name/power-limit line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import math
import os
import runpy
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

CELEBA_ADAMS = 3  # opt_g, opt_d, opt_info: one Adam kernel launch each a CelebA step

# published peaks of one H100 SXM (NVIDIA data sheet), used for bounds
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TENSOR_FLOPS_PER_S = 989e12  # dense
INT8_TENSOR_OPS_PER_S = 1979e12  # dense


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


# --- phases -----------------------------------------------------------------


def phase_environment(torch):
    from eadgan_tpu_torch.cli.common import disable_tf32

    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}", flush=True)
    disable_tf32()  # as every CLI does before it picks the device
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
        flush=True,
    )
    print(
        "tf32 (as the CLIs set it): cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}",
        flush=True,
    )
    from eadgan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library()
    load_s = time.perf_counter() - t0
    print(f"kernel library {_build.LIBRARY.path.name}: built in {_build.LIBRARY.build_seconds} s "
          f"(load {load_s:.2f} s)", flush=True)
    for line in _build.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


WARP_CASES = [
    # name, shape, family, code scale, padding, dtype
    ("c1", (4, 64, 64, 1), "RP", 1.0, "border", "float32"),
    ("c1", (4, 64, 64, 1), "RP", 1.0, "zeros", "float32"),
    ("c3", (4, 64, 64, 3), "RP", 1.0, "border", "float32"),
    ("c3", (4, 64, 64, 3), "RP", 1.0, "zeros", "float32"),
    ("non_square", (2, 32, 64, 3), "RP", 1.0, "border", "float32"),
    ("non_square", (2, 32, 64, 3), "RP", 1.0, "zeros", "float32"),
    ("odd_height", (2, 17, 16, 1), "RP", 1.0, "border", "float32"),
    ("extreme_x3", (2, 16, 16, 1), "RPQMNXY", 3.0, "border", "float32"),
    ("extreme_x3", (2, 16, 16, 1), "RPQMNXY", 3.0, "zeros", "float32"),
    ("even_n", (6, 64, 64, 1), "RP", 1.0, "border", "float32"),
    ("celeba_main", (128, 64, 64, 3), "RPQXY", 1.0, "border", "float32"),
    ("celeba_main", (128, 64, 64, 3), "RPQXY", 1.0, "zeros", "float32"),
    ("c1", (4, 64, 64, 1), "RP", 1.0, "zeros", "bfloat16"),
    ("extreme_x3", (2, 16, 16, 1), "RPQMNXY", 3.0, "border", "bfloat16"),
    ("celeba_main", (128, 64, 64, 3), "RPQXY", 1.0, "border", "bfloat16"),
    # edges of the 4-pixel groups: a row end that is no multiple of 4 (scalar
    # tail), C = 2 and 4 (8- and 16-byte packed stores), C = 5 (run-time C)
    *(
        (name, shape, "RP", 1.0, pad, dtype)
        for name, shape in (("w23", (2, 17, 23, 3)), ("c2", (4, 32, 32, 2)),
                            ("c4", (4, 32, 32, 4)), ("c5", (2, 16, 16, 5)))
        for pad in ("border", "zeros")
        for dtype in ("float32", "bfloat16")
    ),
]

# the dSprites trainers' warps: (channels, matrices); C = 1 is the shape
# the TPU ran through its pair kernel (stn_pallas.py:116), C = 3 colored
DSPRITES_WARP_CASES = [(c, m) for c in (1, 3) for m in ("align", "rp")]
SCORE_BATCH = 500  # the scorer's Representer batch (eval/representation.py)

# (batch, hw, cin, cout) of the fused conv: the CPU tests' shapes, the
# CelebA discriminator's layer 2 at batch 128 (the probe's default, the
# main path's shape), Couts that are no multiple of the N tile, Cins that
# are no multiple of the kernel's 64-channel K step, Ho no multiple of its
# 8 x 16 pixel tile, a single image, and 512 tiles (four waves of the
# persistent grid); each with the probe's bias, 0.01 * N(0, 1), and with
# N(0, 1), as large as the conv output, which no kernel that drops the
# bias or reads another channel's can match
CONV_CASES = [
    ("small", (2, 8, 16, 32)),
    ("cout40", (2, 8, 16, 40)),
    ("full_width_b2", (2, 32, 128, 256)),
    ("celeba_d2_main", (128, 32, 128, 256)),
    ("cout136", (3, 6, 24, 136)),
    ("cin24_cout40", (2, 8, 24, 40)),
    ("cin72_cout264", (2, 10, 72, 264)),
    ("ho17", (1, 34, 64, 128)),
    ("single_image", (1, 32, 128, 256)),
    ("multi_wave", (256, 32, 128, 256)),
]
CONV_BIAS = (0.01, 1.0)
CONV_MAIN = (128, 32, 128, 256)
CONV_TOL_REL = 2e-2  # of max(1, max |ref|): the JAX tool's bar
CONV_TOL_ELEM_MAIN = 0.5  # at the main shape: one bf16 step of the two the bar allows


def conv_inputs(torch, shape, bias=0.01, seed=0):
    """bf16 (x, w, b) on the card, drawn as the probe draws them (bias
    scale 0.01)."""
    import numpy as np

    batch, hw, cin, cout = shape
    rng = np.random.default_rng(seed)
    arrays = (
        rng.standard_normal((batch, hw, hw, cin)),
        0.05 * rng.standard_normal((4, 4, cin, cout)),
        bias * rng.standard_normal((cout,)),
    )
    return [torch.from_numpy(a).to(torch.bfloat16).cuda() for a in arrays]


# the CelebA generator's int8 layers 1-3: (H, Cin, Cout) of their inputs;
# gen_imgs runs them at batch 100, quant_bench and phase 5 at 128
INT8_LAYERS = [(4, 1024, 512), (8, 512, 256), (16, 256, 128)]


def phase_int8_vs_plain(torch, errs):
    """The int8 generator's two kernels against their plain versions (run
    on the CPU: exact integer sums in float64) at the three layers'
    shapes at the CLI's batch of 100 (the card tests add 128 and 3):
    ``int8_convt`` in float32 and bf16 with its abs-max word, and
    ``quantize_int8`` with its own abs-max and a given one, on the layer's
    activation (with exact .5 ties), the same with -0.0 in it, and zeros;
    bit-equal, or the script fails."""
    from eadgan_tpu_torch.ops.quant import (int8_convt_relu, int8_convt_relu_plain,
                                            output_amax_plain, quantize_activation,
                                            quantize_activation_plain)
    from eadgan_tpu_torch.tools.quant_bench import int8_layer_inputs

    errs["int8_convt"] = errs["quantize_int8"] = 0.0
    batch = 100
    for h, cin, cout in INT8_LAYERS:
        xq, a_scale, layer, act = int8_layer_inputs(batch, h, cin, cout)
        card = type(layer)(*(t.cuda() for t in (layer.wq, layer.wp, layer.w_scale, layer.bias)))
        for out_dtype in (torch.float32, torch.bfloat16):
            ref = int8_convt_relu_plain(xq, a_scale, layer.wq, layer.w_scale, layer.bias, out_dtype)
            got, amax = int8_convt_relu(xq.cuda(), a_scale.cuda(), card, out_dtype, with_amax=True)
            got, amax = got.cpu(), amax.cpu()
            check(got.shape == ref.shape and got.dtype == out_dtype, "int8_convt: dtype/shape")
            err = (got.float() - ref.float()).abs().max().item()
            amax_equal = torch.equal(amax, output_amax_plain(ref))
            equal = torch.equal(got, ref) and amax_equal
            emit({"case": f"layer_h{h}", "kernel": "int8_convt", "shape": list(xq.shape),
                  "cout": cout, "out_dtype": str(out_dtype), "max_abs_err": err,
                  "amax": amax.item(), "amax_equal": amax_equal, "bit_equal": equal, "tol": 0.0})
            check(equal, f"int8_convt vs plain at {tuple(xq.shape)}->{cout} {out_dtype}: {err}, "
                         f"abs-max equal {amax_equal}")
        nhwc = h != 4
        with_neg_zero = act.clone()
        with_neg_zero.view(-1)[1::5] = -0.0
        for kind, x in (("layer", act), ("negative_zero", with_neg_zero),
                        ("zeros", torch.zeros_like(act))):
            ref_q, ref_scale = quantize_activation_plain(x, nhwc)
            for given in (False, True):
                amax = output_amax_plain(x).cuda() if given else None
                q, scale = quantize_activation(x.cuda(), nhwc, amax)
                q, scale = q.cpu(), scale.cpu()
                equal = torch.equal(q, ref_q) and torch.equal(scale, ref_scale)
                qerr = (q.int() - ref_q.int()).abs().max().item()
                emit({"case": f"layer_h{h}_input_{kind}", "kernel": "quantize_int8",
                      "shape": list(x.shape), "layout": "nhwc" if nhwc else "nchw",
                      "amax": "given" if given else "own", "max_abs_err": qerr,
                      "scale": scale.item(), "bit_equal": equal, "tol": 0.0})
                check(equal, f"quantize_int8 vs plain at {tuple(x.shape)} {kind}, "
                             f"{'given' if given else 'own'} abs-max: {qerr}")
    torch.cuda.synchronize()


def phase_kernel_vs_plain(torch):
    """Returns each kernel's max abs error at the main path's shape."""
    from eadgan_tpu_torch import transforms
    from eadgan_tpu_torch.ops.fused_conv import fused_conv_lrelu_plain, mismatch
    from eadgan_tpu_torch.ops.fused_conv_cuda import fused_conv_lrelu_cuda
    from eadgan_tpu_torch.ops.stn import warp_affine_plain
    from eadgan_tpu_torch.ops.stn_cuda import warp_affine_cuda
    from eadgan_tpu_torch.tools.adam_bench import kernel_vs_plain
    from eadgan_tpu_torch.tools.sn_bench import kernel_vs_plain as sn_kernel_vs_plain
    from eadgan_tpu_torch.transforms import RPQXY, code_to_matrix
    from eadgan_tpu_torch.utils.profiler import mnist_warp_inputs, sprite_warp_inputs

    errs = {}
    gen = torch.Generator().manual_seed(0)
    for name, shape, family, scale, pad, dtype_name in WARP_CASES:
        family = getattr(transforms, family)
        dtype = getattr(torch, dtype_name)
        img = torch.rand(shape, generator=gen).to("cuda", dtype)
        code = (torch.rand(shape[0], family.n_affine, generator=gen) * 2 - 1) * scale
        matrix = code_to_matrix(family, code.cuda())
        got = warp_affine_cuda(img, matrix, pad)
        ref = warp_affine_plain(img, matrix, pad)
        torch.cuda.synchronize()
        check(got.dtype == dtype and got.shape == img.shape, f"{name}: dtype/shape")
        err = (got.float() - ref.float()).abs().max().item()
        tol = 2e-5 if dtype == torch.float32 else 1e-2
        emit({"case": name, "kernel": "warp_affine", "shape": list(shape), "padding": pad,
              "dtype": dtype_name, "max_abs_err": err, "tol": tol})
        check(math.isfinite(err) and err <= tol, f"kernel vs plain {name} {pad} {dtype}: {err}")
        if name == "celeba_main" and pad == "border" and dtype == torch.float32:
            errs["warp_affine"] = err

    for channels, matrices in DSPRITES_WARP_CASES:
        img32, matrix = sprite_warp_inputs(channels, matrices, "cuda")
        for dtype in (torch.float32, torch.bfloat16):
            img = img32.to(dtype)
            for pad in ("border", "zeros"):
                got = warp_affine_cuda(img, matrix, pad)
                ref = warp_affine_plain(img, matrix, pad)
                torch.cuda.synchronize()
                check(got.dtype == dtype and got.shape == img.shape, f"dsprites warp: dtype/shape")
                err = (got.float() - ref.float()).abs().max().item()
                tol = 2e-5 if dtype == torch.float32 else 1e-2
                name = f"dsprites_c{channels}_{matrices}"
                emit({"case": name, "kernel": "warp_affine", "shape": list(img.shape), "padding": pad,
                      "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err, "tol": tol})
                check(math.isfinite(err) and err <= tol, f"kernel vs plain {name} {pad} {dtype}: {err}")
                if (channels, matrices, pad, dtype) == (1, "rp", "border", torch.float32):
                    errs["warp_affine_pair"] = err

    # the scorer's warp (eval/representation.py): the Representer's batch of
    # 500 and odd ragged last batches, binary sprites (C = 1, which the TPU
    # took through its pair kernel) and colorized ones (C = 3) under the
    # aligner's inverse matrices, "zeros" padding, float32
    for channels in (1, 3):
        for n in (SCORE_BATCH, 333, 1):
            img, matrix = sprite_warp_inputs(channels, "align", "cuda", batch=n)
            got = warp_affine_cuda(img, matrix, "zeros")
            ref = warp_affine_plain(img, matrix, "zeros")
            torch.cuda.synchronize()
            check(got.dtype == torch.float32 and got.shape == img.shape, "scorer warp: dtype/shape")
            err = (got - ref).abs().max().item()
            emit({"case": f"score_c{channels}", "kernel": "warp_affine", "shape": list(img.shape),
                  "padding": "zeros", "dtype": "float32", "max_abs_err": err, "tol": 2e-5})
            check(math.isfinite(err) and err <= 2e-5, f"kernel vs plain score_c{channels} N={n}: {err}")
            if n == SCORE_BATCH:
                errs["warp_affine_pair_score" if channels == 1 else "warp_affine_score"] = err

    # the MNIST step's warp: (128, 32, 32, 1), half the columns a block saw
    # at 64 wide, under the step's rpqmnxy matrices ("border" is the step's)
    img32, matrix = mnist_warp_inputs("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        img = img32.to(dtype)
        for pad in ("border", "zeros"):
            got = warp_affine_cuda(img, matrix, pad)
            ref = warp_affine_plain(img, matrix, pad)
            torch.cuda.synchronize()
            check(got.dtype == dtype and got.shape == img.shape, "mnist warp: dtype/shape")
            err = (got.float() - ref.float()).abs().max().item()
            tol = 2e-5 if dtype == torch.float32 else 1e-2
            emit({"case": "mnist_main", "kernel": "warp_affine", "shape": list(img.shape),
                  "padding": pad, "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
                  "tol": tol})
            check(math.isfinite(err) and err <= tol, f"kernel vs plain mnist {pad} {dtype}: {err}")
            if pad == "border" and dtype == torch.float32:
                errs["warp_affine_pair_mnist"] = err

    # gradients through the warp's autograd wrapper equal the plain ones
    img = torch.rand((2, 16, 16, 3), generator=gen).cuda()
    code = (torch.rand(2, 5, generator=gen) * 2 - 1).cuda()
    grads = []
    for fn in (warp_affine_cuda, warp_affine_plain):
        i = img.clone().requires_grad_(True)
        c = code.clone().requires_grad_(True)
        (fn(i, code_to_matrix(RPQXY, c), "border") ** 2).sum().backward()
        grads.append((i.grad, c.grad))
    for a, b in zip(*grads):
        err = (a - b).abs().max().item()
        check(err <= 1e-4, f"warp gradient through the kernel wrapper: {err}")

    # per element at most two bf16 steps of |ref| plus 1e-3 of max |ref|
    # ("elem" <= 1), and the JAX tool's bar on the largest difference
    for name, shape in CONV_CASES:
        for bias in CONV_BIAS:
            x, w, b = conv_inputs(torch, shape, bias)
            got = fused_conv_lrelu_cuda(x, w, b)
            ref = fused_conv_lrelu_plain(x, w, b)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16 and got.shape == ref.shape, f"{name}: dtype/shape")
            diff = mismatch(got, ref)
            emit({"case": name, "kernel": "fused_conv_lrelu", "shape": list(shape), "bias": bias,
                  "dtype": "bfloat16", **diff, "tol_rel": CONV_TOL_REL, "tol_elem": 1.0})
            check(math.isfinite(diff["rel"]) and diff["rel"] < CONV_TOL_REL and diff["elem"] <= 1.0,
                  f"fused conv vs plain {name} bias {bias}: {diff}")
            if shape == CONV_MAIN:
                check(diff["elem"] <= CONV_TOL_ELEM_MAIN, f"fused conv at the main shape: {diff}")
            if shape == CONV_MAIN and bias == 0.01:
                errs["fused_conv_lrelu"] = diff["max_abs_err"]
    # forward-only: an input that needs a gradient is refused, not detached
    try:
        fused_conv_lrelu_cuda(x, w.clone().requires_grad_(True), b)
    except RuntimeError as e:
        check("forward-only" in str(e), f"fused conv refused a grad input for another reason: {e}")
    else:
        fail("fused conv accepted an input that requires grad")
    phase_int8_vs_plain(torch, errs)

    # the Adam kernel: 5 steps of CelebA's three optimizers on its real
    # parameters against the plain version beside it on the card (the
    # card tests' bars: FMA contraction parts the moments by a few
    # roundings and the parameters by a few ulps of 1)
    adam = kernel_vs_plain(torch.device("cuda"), steps=5)
    emit({"case": "celeba_optimizers", "kernel": "adam_fused", "steps": 5, "max_err": adam,
          "tol": ADAM_TOL})
    check(all(adam[k] <= ADAM_TOL[k] for k in ADAM_TOL), f"Adam kernel vs plain: {adam}")
    errs["adam_fused"] = adam["param"]

    # the spectral norm's kernels: CelebA's discriminator and four rp
    # layers (the largest conv and dense on the large path, the first conv
    # and the 7-code head on one block) against the plain version, with
    # the card tests' bars
    for shape in SN_CASES:
        for dtype in (torch.bfloat16, None):
            r = sn_kernel_vs_plain(shape, dtype, torch.device("cuda"))
            emit({"case": "sn", "kernel": "spectral_norm", **r, "tol": SN_TOL})
            check(r["wn_bit_equal"] and r["state_written"]
                  and all(r[k] <= SN_TOL[k] for k in SN_TOL), f"spectral norm vs plain: {r}")
            errs["spectral_norm_grad_gap"] = max(errs.get("spectral_norm_grad_gap", 0.0),
                                                 r["grad_gap"])
    return errs


# CelebA's discriminator; rp's largest conv and dense layers (the large
# path) and its first conv and 7-code head (one block)
SN_CASES = [(128, 3, 4, 4), (256, 128, 4, 4), (512, 256, 4, 4), (1024, 512, 4, 4), (64, 64, 4, 4),
            (128, 1024), (32, 1, 4, 4), (7, 128)]
SN_TOL = {"sigma_gap": 1e-5, "u_gap": 1e-5, "grad_gap": 1e-4, "closed_form_gap": 1e-5}


# the Adam kernel against its plain version after 5 steps: parameters and
# step counts absolute, moments relative to each tensor's largest
ADAM_TOL = {"param": 1e-6, "exp_avg": 1e-5, "exp_avg_sq": 1e-5, "step": 0.0}


# CPU vs CUDA step losses: float32 (TF32 off) agrees to summation order at
# step 0 and drifts with Adam's sign steps after; bf16 rounds every conv
# output, and cuDNN and the CPU round at other points, so a few bf16 steps
# (2^-8 each) apart at step 0
STEP_RTOL = {"f32": (1e-3, 3e-2), "bf16": (1e-2, 5e-2)}


def phase_step_parity(torch):
    import numpy as np

    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

    batch = 4
    config = CelebaConfig(batch_size=batch, g_lr=1e-4, d_lr=2e-5, info_lr=2e-5)
    step = make_celeba_gan_step(config)
    for compute, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        states = {
            dev: init_celeba_gan_state(config, device=dev, seed=0, dtype=dtype)
            for dev in ("cpu", "cuda")
        }
        rng = np.random.default_rng(0)
        imgs = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(np.float32)
        for s in range(3):
            fixed = {
                "z": rng.standard_normal((batch, 200)).astype(np.float32),
                "sampled_labels": rng.integers(0, 10, batch),
                "code": rng.uniform(-1, 1, (batch, 8)).astype(np.float32),
            }
            losses = {}
            for dev, state in states.items():
                _, m = step(state, torch.from_numpy(imgs).to(dev), fixed)
                losses[dev] = {k: float(v) for k, v in m.items()}
            _check_step_losses("celeba", compute, s, losses)


def _check_step_losses(label, compute, s, losses):
    rtol = STEP_RTOL[compute][0 if s == 0 else 1]
    for k, ref in losses["cpu"].items():
        got = losses["cuda"][k]
        rel = abs(got - ref) / max(abs(ref), 1e-12)
        emit({"step_parity": s, "pipeline": label, "compute": compute, "loss": k, "cpu": ref,
              "cuda": got, "rel": rel, "rtol": rtol})
        check(math.isfinite(got) and rel <= rtol, f"{label} {compute} step {s} {k}: cpu {ref} cuda {got}")


def phase_step_parity_dsprites(torch):
    """The pxy step (gray, colored) and the rp step (gray, colored; gray
    also bf16), batch 4, three steps at the CLIs' rates, on the CPU and
    on the card from the same weights and draws."""
    import numpy as np

    from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
    from eadgan_tpu_torch.train.config import PxyConfig, SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
    from eadgan_tpu_torch.train.pretrain import init_pxy_state, make_pxy_step, pxy_encoder

    batch = 4
    sprites = synthetic_dsprites(n_pos=3).imgs
    runs = [("pxy", False, "f32"), ("pxy", True, "f32"), ("rp", False, "f32"), ("rp", True, "f32"),
            ("rp", False, "bf16")]
    for pipeline, colored, compute in runs:
        dtype = torch.bfloat16 if compute == "bf16" else None
        if pipeline == "pxy":
            config = PxyConfig.for_dataset(colored, batch_size=batch)
            step = make_pxy_step(config)
            states = {dev: init_pxy_state(config, device=dev, seed=0) for dev in ("cpu", "cuda")}
        else:
            config = SpritesGanConfig.for_dataset(colored, batch_size=batch)
            step = make_sprites_gan_step(config)
            states = {
                dev: init_sprites_gan_state(config, pxy_encoder(colored, seed=1), device=dev,
                                            seed=0, dtype=dtype)
                for dev in ("cpu", "cuda")
            }
        code_dim = config.code_dim
        rng = np.random.default_rng(0)
        imgs = sprites[rng.choice(len(sprites), batch, replace=False)][..., None].astype(np.float32)
        label = f"{pipeline}_color" if colored else pipeline
        for s in range(3):
            if pipeline == "pxy":
                fixed = {"code": rng.uniform(-1, 1, (batch, code_dim)).astype(np.float32)}
            else:
                fixed = {f"{k}_{p}": v for p in ("d", "i") for k, v in (
                    ("code", rng.uniform(-1, 1, (batch, code_dim)).astype(np.float32)),
                    ("onehot", np.eye(3, dtype=np.float32)[rng.integers(0, 3, batch)]))}
            if colored:
                fixed["color"] = rng.uniform(0.5, 1.0, (batch, 3)).astype(np.float32)
            losses = {}
            for dev, state in states.items():
                _, m = step(state, torch.from_numpy(imgs).to(dev), fixed)
                losses[dev] = {k: float(v) for k, v in m.items()}
            _check_step_losses(label, compute, s, losses)


def phase_step_parity_mnist(torch):
    """The MNIST step in f32 and bf16 with a fresh frozen approximator, and
    the approximator's own step in f32, batch 4, three steps at the CLIs'
    rates, on the CPU and on the card from the same weights and draws."""
    import numpy as np

    from eadgan_tpu_torch.train.config import ApproximatorConfig, MnistConfig
    from eadgan_tpu_torch.train.gan_mnist import init_mnist_gan_state, make_mnist_gan_step
    from eadgan_tpu_torch.train.pretrain import (approximator_model, init_approximator_state,
                                                 make_approximator_step)
    from eadgan_tpu_torch.utils.profiler import build_step, first_batch

    batch = 4
    _, _, data, prep = build_step("mnist", batch_size=batch, device="cpu")
    imgs = first_batch(data, prep, batch, device="cpu")
    config = MnistConfig(batch_size=batch)
    step = make_mnist_gan_step(config)
    for compute, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        states = {dev: init_mnist_gan_state(config, approximator_model(seed=1), device=dev, seed=0,
                                            dtype=dtype) for dev in ("cpu", "cuda")}
        rng = np.random.default_rng(0)
        for s in range(3):
            fixed = {"z": rng.standard_normal((batch, 62)).astype(np.float32),
                     "sampled_labels": rng.integers(0, 10, batch),
                     "code": rng.uniform(-1, 1, (batch, 7)).astype(np.float32)}
            losses = {dev: {k: float(v) for k, v in step(state, imgs.to(dev), fixed=fixed)[1].items()}
                      for dev, state in states.items()}
            _check_step_losses("mnist", compute, s, losses)

    config = ApproximatorConfig(batch_size=128)
    step = make_approximator_step(config)
    states = {dev: init_approximator_state(config, device=dev, seed=0) for dev in ("cpu", "cuda")}
    rng = np.random.default_rng(0)
    for s in range(3):
        fixed = {"code": rng.uniform(-1, 1, (128, 7)).astype(np.float32)}
        losses = {dev: {k: float(v) for k, v in step(state, fixed)[1].items()}
                  for dev, state in states.items()}
        _check_step_losses("approximator", "f32", s, losses)


INFER_TOL = 2e-2  # bf16 fold against the f32 eval forward, absolute on tanh outputs
INT8_PSNR_DB, INT8_MAX_ABS = 25.0, 0.5  # the int8 forward's bar (tests/test_quant.py)


def phase_infer_parity(torch):
    """The BatchNorm-folded bf16 CelebA generator (``cli.gen_imgs --quant
    bf16``) and the int8 one (``--quant int8``, through both int8
    kernels) against the float32 eval-mode forward (``--quant none``) on
    the card, batch 128: bf16 within 2e-2, int8 above 25 dB PSNR and
    within 0.5."""
    from eadgan_tpu_torch.models import CelebaGenerator
    from eadgan_tpu_torch.ops.quant import make_celeba_infer
    from eadgan_tpu_torch.tools.quant_bench import generator_inputs, psnr_db

    sd, x = generator_inputs(128, "cuda")
    model = CelebaGenerator()
    model.load_state_dict(sd)
    with torch.no_grad():
        ref = model.cuda().eval()(*x)
    got = make_celeba_infer(sd, quant="none", compute_dtype=torch.bfloat16, device="cuda")(*x)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    emit({"infer_parity": "celeba_generator", "batch": 128, "folded": "bf16", "ref": "f32 eval",
          "shape": list(got.shape), "max_abs_err": err, "tol": INFER_TOL})
    check(got.dtype == torch.float32 and got.shape == ref.shape, "folded generator: dtype/shape")
    check(math.isfinite(err) and err <= INFER_TOL, f"folded bf16 generator vs f32 eval: {err}")
    got = make_celeba_infer(sd, quant="int8", device="cuda")(*x)
    torch.cuda.synchronize()
    err, psnr = (got - ref).abs().max().item(), psnr_db(got, ref)
    emit({"infer_parity": "celeba_generator", "batch": 128, "folded": "int8 (bf16 ends)",
          "ref": "f32 eval", "shape": list(got.shape), "psnr_db": psnr, "max_abs_err": err,
          "min_psnr_db": INT8_PSNR_DB, "tol": INT8_MAX_ABS})
    check(got.dtype == torch.float32 and got.shape == ref.shape, "int8 generator: dtype/shape")
    check(bool(torch.isfinite(got).all()), "int8 generator: non-finite output")
    check(psnr > INT8_PSNR_DB and err < INT8_MAX_ABS, f"int8 generator vs f32 eval: {psnr} dB, {err}")


REP_TOL = 1e-4  # continuous columns, CPU vs card: float32 convs summed in other orders


def phase_representer_parity(torch):
    """The scorer's Representer on the CPU and on the card from the same
    weights, gray and colored, on 1,001 synthetic sprites (batches of 500,
    500 and 1): the continuous columns within 1e-4, the category ids
    equal, the card's warp launched once a batch."""
    import numpy as np

    from eadgan_tpu_torch.cli.score import fresh_encoders
    from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
    from eadgan_tpu_torch.eval import Representer
    from eadgan_tpu_torch.ops import stn_cuda

    sprites = synthetic_dsprites(n_pos=6).imgs
    imgs = sprites[np.random.default_rng(0).choice(len(sprites), 2 * SCORE_BATCH + 1, replace=False)]
    for colored in (False, True):
        reps = {}
        for dev in ("cpu", "cuda"):
            before = stn_cuda.launch_count
            reps[dev] = Representer(*fresh_encoders(colored), colored=colored, seed=0,
                                    device=dev)(imgs)
        launched = stn_cuda.launch_count - before
        cpu, card = reps["cpu"], reps["cuda"]
        err = float(np.abs(cpu[:, 1:] - card[:, 1:]).max())
        ids_equal = bool((cpu[:, 0] == card[:, 0]).all())
        emit({"representer_parity": "colored" if colored else "gray", "images": len(imgs),
              "batch": SCORE_BATCH, "continuous_max_abs_err": err, "tol": REP_TOL,
              "category_ids_equal": ids_equal, "distinct_ids": int(len(np.unique(card[:, 0]))),
              "warp_launches": launched})
        check(card.shape == (len(imgs), 5) and np.isfinite(card).all(), "Representer on the card")
        check(err <= REP_TOL and ids_equal, f"Representer CPU vs card: {err}, ids equal {ids_equal}")
        check(launched == 3, f"Representer on the card launched the warp {launched} times, not 3")


CHAIN_CHECKS = ("celeba", "pxy", "rp", "rp_color", "mnist")


def phase_chain_parity(torch):
    """The chained engine against the per-step engine on the card; then
    the warp's launches under replay, as its wrapper counts them against
    the CUPTI trace of a window of gray rp replays."""
    from eadgan_tpu_torch.tools.chain_check import run_check
    from eadgan_tpu_torch.utils.profiler import profile_step

    for pipeline in CHAIN_CHECKS:
        report = run_check(pipeline, steps=8, chain=4, batch=128)
        emit(report)
        check(report["ok"], f"chained {pipeline} engine against the per-step engine: {report}")
    summary, _ = profile_step("rp", chain=CHAIN_WINDOW)
    emit({"replayed_profile": {k: v for k, v in summary.items() if k != "top_kernels"},
          "top_kernels": summary["top_kernels"][:5]})
    check(summary["kernels_in_trace"], "the trace of the replayed rp steps shows no kernel")
    counted = summary["warp_launches_per_step"], summary["warp_kernels_in_trace_per_step"]
    check(counted == (3, 3), f"warp launches a replayed rp step, counted and traced: {counted}")


@contextlib.contextmanager
def environ(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_module(torch, module: str, argv) -> None:
    """``python -m module argv...`` in this process, as a user runs it."""
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    finally:
        sys.argv = saved
    torch.cuda.synchronize()


def read_records(path, keys=("d_loss", "g_loss")):
    records = [json.loads(line) for line in open(path)]
    for r in records:
        check(all(math.isfinite(r[k]) for k in keys), f"loss {r}")
    return records


def loop_ms(records) -> float:
    """Per-step runs: median host clock between consecutive log records
    from step 2 on: one loop step (the step, the batch's gather and its
    copy to the card), past step 0's sample grids and saves."""
    ts = [r["t"] for r in records]
    return statistics.median(b - a for a, b in zip(ts[2:], ts[3:])) * 1e3


def read_trace(trace_path) -> dict:
    """An ``EADGAN_TRACE`` file: ``{"spans": [...], "counters": {...}}``."""
    with open(trace_path) as f:
        return json.load(f)


def trace_spans(recorded, name) -> list:
    """The spans called ``name`` in a read ``EADGAN_TRACE`` file, by start."""
    return sorted((s for s in recorded["spans"] if s["name"] == name),
                  key=lambda s: s["start_ns"])


def span_s(span) -> float:
    return (span["end_ns"] - span["start_ns"]) * 1e-9


def chained_loop_ms(trace_path, adams: int, sn=None) -> dict:
    """Chained runs, from their ``EADGAN_TRACE`` file's ``engine.*`` spans:
    one ``engine.window`` a window (with ``s`` and ``k``), tiling the
    loop (a last one, without ``s``, drains the last window and is left
    out here).  A window's span ends after the previous window's metrics
    came back, so the time between window ends j - 1 and j holds the
    device work of window j - 1: the loop step is the time from the end
    of the second window (the first is the eager step with its grids and
    saves, the second the capture) to the end of the last, over the
    steps of the windows from the second to the last but one.  Also the
    sums of the windows' child spans (``feed``, ``dispatch``,
    ``drain.wait``, ``drain.log``, ``event``, ...) over those windows,
    over the same steps, in ms; and the replayed steps' device split by
    their stamps (the ``step.*`` counters), in ms a step.  The engine's
    counters are held to its spans: a window and its steps counted once
    each, one capture, every step but the eager first one stamped, and
    the Adam kernel (``adam.launches``) launched ``adams`` times a step,
    one launch an optimizer step, the eager step's and each replay's, and
    the spectral norm's kernels (``sn.launches``) ``sn`` times a step
    where given (reported as ``sn_launches_per_step`` either way)."""
    recorded = read_trace(trace_path)
    spans, counters = recorded["spans"], recorded["counters"]
    windows = [w for w in trace_spans(recorded, "engine.window") if "k" in w]
    check(len(windows) >= 3, f"{trace_path}: fewer than three windows")
    run = sum(w["k"] for w in windows)
    check(counters.get("engine.windows") == len(windows) and counters.get("engine.steps") == run
          and counters.get("engine.captures") == 1 and counters.get("step.stamped") == run - 1
          and counters.get("adam.launches") == adams * run,
          f"{trace_path}: counters {counters} for {len(windows)} windows of {run} steps, "
          f"{adams} Adam launches a step")
    check(sn is None or counters.get("sn.launches") == sn * run,
          f"{trace_path}: sn.launches {counters.get('sn.launches')} for {run} steps, {sn} a step")
    timed, steps = windows[2:], sum(w["k"] for w in windows[1:-1])
    ids = {w["id"] for w in timed}
    phases = collections.defaultdict(float)
    for s in spans:
        if s["parent"] in ids:
            phases[s["name"].removeprefix("engine.")] += span_s(s)
    return {
        "loop_step_ms_host_clock": (timed[-1]["end_ns"] - windows[1]["end_ns"]) * 1e-6 / steps,
        "timed_windows": len(timed), "timed_steps": steps,
        "trace_ms_per_step": {p: t / steps * 1e3 for p, t in sorted(phases.items())},
        "stamped_ms_per_step": {p: counters[f"step.{p}_ns"] / (run - 1) * 1e-6
                                for p in ("prepare", "fwd_bwd", "optimizer")},
        "adam_launches_per_step": counters["adam.launches"] / run,
        "sn_launches_per_step": counters.get("sn.launches", 0) / run,
    }


def phase_trainer(torch):
    """The trainer at its default ``--chain 32``: 20 f32 steps (4 epochs
    of 5 batches, the planned total), sample grids and a train state saved
    at step 0 only, the warp launched exactly once a step plus once for
    the grid; then ``--resume auto --compute bf16 --chain 1`` continuing
    per step from step 1, inside epoch 0, to the planned total."""
    from eadgan_tpu_torch.ops import adam_cuda, quant_cuda, sn_cuda, stn_cuda
    from eadgan_tpu_torch.tools.sn_bench import census, launches_per_step
    from eadgan_tpu_torch.train.checkpoint import saved_steps

    module = "eadgan_tpu_torch.cli.celeba"
    sn_per_step = launches_per_step(census("celeba", 4))  # by the layers' sizes
    stem = "celeba_train_state"  # the trainer's train-state files (not imported: runpy runs it)
    total = 20
    with tempfile.TemporaryDirectory(prefix="eadgan_smoke_") as tmp, \
            environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_N="640"):
        common = [
            "--batch_size", "128", "--n_epochs", "4", "--data_dir", tmp,
            "--out_dir", os.path.join(tmp, "images"), "--ckpt_dir", tmp, "--keep_states", "1",
        ]
        jsonl = os.path.join(tmp, "metrics.jsonl")
        trace = os.path.join(tmp, "chain_trace.json")
        # one sample interval is the whole run: grids, the checkpoint and
        # the train state are written at step 0 only
        stn_cuda.reset_launch_count()  # counts from here read the main path only
        adam_cuda.reset_launch_count()
        sn_cuda.reset_launch_count()
        t0 = time.perf_counter()
        with environ(EADGAN_TRACE=trace):
            run_module(torch, module, common + ["--compute", "f32", "--max_steps", str(total),
                                                "--sample_interval", str(total), "--jsonl", jsonl])
        wall = time.perf_counter() - t0
        launches, adams, sns = stn_cuda.launch_count, adam_cuda.launch_count, sn_cuda.launch_count
        chained = chained_loop_ms(trace, CELEBA_ADAMS, sn_per_step)

        records = read_records(jsonl)
        check([r["step"] for r in records] == list(range(total)), "f32 trainer steps")
        ckpt = torch.load(os.path.join(tmp, "checkpoint_0.tar"), weights_only=True)
        check(set(ckpt) == {"discriminator_state_dict", "generator_state_dict", "epoch",
                            "batches_done"}, f"checkpoint keys {sorted(ckpt)}")
        for name in ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 9)]:
            check(os.path.isfile(os.path.join(tmp, "images", name, "0.png")), f"grid {name}")
        check(saved_steps(tmp, stem) == [0], f"train states {saved_steps(tmp, stem)}")
        saved = torch.load(os.path.join(tmp, f"{stem}_0.ckpt"), weights_only=True)
        check(saved["step"] == 1, f"saved step {saved['step']}")

        jsonl2 = os.path.join(tmp, "resumed.jsonl")
        t0 = time.perf_counter()
        run_module(torch, module, common + ["--resume", "auto", "--compute", "bf16", "--chain", "1",
                                            "--sample_interval", "1000", "--jsonl", jsonl2])
        resume_wall = time.perf_counter() - t0
        resumed = read_records(jsonl2)
        # step 1 is inside epoch 0 (5 batches an epoch): its 4 remaining
        # batches run, then 3 whole epochs, ending at the planned total
        check([r["step"] for r in resumed] == list(range(1, total)),
              f"resumed steps {[r['step'] for r in resumed]}")

        # inference from the run's checkpoint: the f32 eval forward, the
        # BatchNorm-folded bf16 one and the int8 one, 8 sweep grids each
        infer = {}
        for quant in ("none", "bf16", "int8"):
            out = os.path.join(tmp, f"gen_imgs_{quant}")
            quant_cuda.reset_launch_count()  # counts from here read this path only
            t0 = time.perf_counter()
            run_module(torch, "eadgan_tpu_torch.cli.gen_imgs",
                       ["--checkpoint", os.path.join(tmp, "checkpoint_0.tar"), "--out_dir", out,
                        "--quant", quant])
            infer[quant] = time.perf_counter() - t0
            int8_launches = dict(quant_cuda.launch_count)
            # 8 forwards of batch 100: 3 int8 layers each, 3 int8_convt and
            # 2 + 1 + 1 quantize_int8 launches a forward
            want = {"int8_convt": 24, "quantize_int8": 32} if quant == "int8" else {
                "int8_convt": 0, "quantize_int8": 0}
            check(int8_launches == want, f"gen_imgs --quant {quant}: int8 launches {int8_launches}")
            for k in range(1, 9):
                check(os.path.isfile(os.path.join(out, f"varying_c{k}", "0.png")),
                      f"gen_imgs --quant {quant} grid varying_c{k}")
            check(not os.path.exists(os.path.join(out, "varying_c9")), "gen_imgs: 8 grids")
    check(launches == total + 1, f"warp kernel launched {launches} times in {total} steps + 1 grid")
    check(adams == CELEBA_ADAMS * total, f"Adam kernel launched {adams} times in {total} steps")
    check(sns == sn_per_step * total,
          f"spectral norm's kernels launched {sns} times in {total} steps, {sn_per_step} a step")
    emit({"trainer": module, "batch_size": 128, "steps": total, "compute": "f32", "chain": 32,
          "wall_s": wall, **chained, "warp_launches": launches, "adam_launches": adams,
          "sn_launches": sns, "last": records[-1]})
    emit({"trainer_resumed": module, "compute": "bf16", "chain": 1, "from_step": 1,
          "steps": [r["step"] for r in resumed], "wall_s": resume_wall,
          "loop_step_ms_host_clock": loop_ms(resumed), "last": resumed[-1]})
    emit({"inference_cli": "eadgan_tpu_torch.cli.gen_imgs", "checkpoint": "checkpoint_0.tar",
          "grids": 8, "wall_s_by_quant": infer, "int8_launches": int8_launches})
    return {"warp_affine": launches, "adam_fused": adams, "spectral_norm": sns, **int8_launches}


SAVE_STEPS, SAVE_EVERY = 24, 8  # the save-window runs: steps, and the event period


def phase_save_window(torch):
    """The CelebA trainer's save window, inline (``EADGAN_SYNC_EVENTS=1``)
    against the event worker, f32 at batch 128: ``run_epochs`` chained
    (``--chain 32``, the profiler's 1,024 synthetic faces, 8 batches an
    epoch) for 24 steps with saves at steps 8 and 16, each doing what
    ``cli.celeba``'s callback does at a multiple of 15 sample intervals:
    the sample grids (one warp), ``checkpoint_%d.tar`` and the ~520 MB
    train state (step 0's event, before the capture, where the engine
    waits for the worker anyway, saves nothing).  From each run's
    ``EADGAN_TRACE`` file: the host seconds of the two save windows and
    of their ``engine.event`` spans, the callback (inline) or the
    snapshot and submit (worker); the seconds of each grid
    (``sample.grid``) and file (``checkpoint.save``) wherever they ran,
    and on the worker of each event, its wait for the snapshot and the
    queue's ``put``; and the run's wall, the worker's last save
    included.  The files of both runs exist when ``run_epochs`` returns;
    the counters hold every file with its bytes, every grid, and on the
    worker every event, and each worker event holds one wait and one
    callback."""
    from eadgan_tpu_torch.cli.celeba import warp_batch
    from eadgan_tpu_torch.sample.figures import celeba_training_grids
    from eadgan_tpu_torch.train.checkpoint import (cpu_state_dict, save_checkpoint,
                                                   save_train_state, saved_steps)
    from eadgan_tpu_torch.train.engine import generator_apply, run_epochs
    from eadgan_tpu_torch.utils.profiler import build_step

    record = {"save_window": "celeba", "batch_size": 128, "compute": "f32", "chain": 32,
              "steps": SAVE_STEPS, "saves": list(range(SAVE_EVERY, SAVE_STEPS, SAVE_EVERY))}
    for mode in ("inline", "worker"):
        state, step, data, prep = build_step("celeba", 128)
        with tempfile.TemporaryDirectory(prefix="eadgan_save_") as tmp:
            trace = os.path.join(tmp, "trace.json")

            def on_batch(i, st, metrics, batch, tmp=tmp):
                if i % SAVE_EVERY or i == 0:
                    return
                real = batch[0][:100]
                scaled = warp_batch(real, i, 8)
                celeba_training_grids(generator_apply(lambda: st.g), real.cpu().numpy(),
                                      scaled.cpu().numpy(), os.path.join(tmp, "images"), i,
                                      latent_dim=200, n_classes=10, code_dim=8)
                save_checkpoint(os.path.join(tmp, f"checkpoint_{i}.tar"), {
                    "discriminator_state_dict": cpu_state_dict(st.d),
                    "generator_state_dict": cpu_state_dict(st.g), "epoch": i // 8,
                    "batches_done": i})
                save_train_state(tmp, "celeba_train_state", i, st, keep=0)

            with environ(EADGAN_SYNC_EVENTS="1" if mode == "inline" else "0",
                         EADGAN_TRACE=trace):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_epochs(n_epochs=SAVE_STEPS // 8, data=data, batch_size=128, state=state,
                           step_fn=step, on_batch=on_batch, device="cuda", max_steps=SAVE_STEPS,
                           chain=32, chain_periods=(SAVE_EVERY,), **prep)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            check(saved_steps(tmp, "celeba_train_state") == [16, 8],
                  f"{mode}: train states {saved_steps(tmp, 'celeba_train_state')}")
            for i in record["saves"]:
                check(os.path.isfile(os.path.join(tmp, f"checkpoint_{i}.tar")), f"{mode}: ckpt {i}")
                check(os.path.isfile(os.path.join(tmp, "images", "varying_c8", f"{i}.png")),
                      f"{mode}: grid {i}")
            saved = torch.load(os.path.join(tmp, "celeba_train_state_16.ckpt"), weights_only=True)
            check(saved["step"] == 17, f"{mode}: saved step {saved['step']}")
            files = [os.path.join(tmp, f"{stem}_{i}.{ext}") for i in record["saves"]
                     for stem, ext in (("checkpoint", "tar"), ("celeba_train_state", "ckpt"))]
            written = sum(os.path.getsize(f) for f in files)
            recorded = read_trace(trace)
        windows = trace_spans(recorded, "engine.window")
        events = {e["parent"]: e for e in trace_spans(recorded, "engine.event")}
        saves = [w for w in windows
                 if "k" in w and (w["s"] + w["k"] - 1) % SAVE_EVERY == 0 and w["s"] > 0]
        check(len(saves) == 2, f"{mode}: save windows {saves}")
        counters = recorded["counters"]
        on_worker = len(events) if mode == "worker" else 0
        check(counters.get("checkpoint.saves") == len(files)
              and counters.get("checkpoint.bytes") == written
              and counters.get("sample.grids") == len(record["saves"])
              and counters.get("worker.events", 0) == on_worker,
              f"{mode}: counters {counters}, {len(files)} files of {written} bytes, "
              f"{len(events)} events")
        worker_events = trace_spans(recorded, "worker.event")
        held = collections.defaultdict(list)
        for s in recorded["spans"]:
            held[s["parent"]].append(s["name"])
        check(len(worker_events) == on_worker
              and all(sorted(held[e["id"]]) == ["worker.callback", "worker.wait"]
                      for e in worker_events),
              f"{mode}: worker spans {[(e['id'], held[e['id']]) for e in worker_events]}")
        submits = trace_spans(recorded, "engine.event.submit")
        check(len(submits) == on_worker and counters.get("worker.submit_blocked", 0) <= on_worker,
              f"{mode}: {len(submits)} submits, counters {counters}")
        record[mode] = {"wall_s": wall,
                        "save_windows": [{"s": w["s"], "k": w["k"], "host_s": span_s(w)} for w in saves],
                        "save_cb_s": [span_s(events[w["id"]]) for w in saves],
                        "window_host_s": sum(span_s(w) for w in windows[1:]),
                        "grid_s": [span_s(g) for g in trace_spans(recorded, "sample.grid")],
                        "checkpoint_save_s": [span_s(c) for c in
                                              trace_spans(recorded, "checkpoint.save")],
                        "checkpoint_mb": written / 1e6,
                        "worker_event_s": [span_s(e) for e in worker_events],
                        "worker_wait_s": [span_s(w) for w in trace_spans(recorded, "worker.wait")],
                        "submit_s": [span_s(p) for p in submits],
                        "submit_blocked": counters.get("worker.submit_blocked", 0)}
        # the models and the three Adams' moments, as a save copies them
        record["train_state_mb"] = sum(
            v.numel() * v.element_size()
            for v in [*state.g.state_dict().values(), *state.d.state_dict().values(),
                      *(v for o in (state.opt_g, state.opt_d, state.opt_info)
                        for st in o.state.values() for v in st.values())]
            if torch.is_tensor(v)) / 1e6
        del state
    emit(record)
    return record


MNIST_STEPS, MNIST_GRID_WARPS = 32, 1  # two epochs of the 16-batch stand-in; the grid's warp
APPROX_ITERATIONS = 300


def phase_mnist_trainers(torch):
    """The MNIST pipeline through its three CLIs at batch 128 on the
    synthetic digits (2,048, 16 batches an epoch): the approximator for
    a short run, then ``cli.mnist`` at its default ``--chain 32`` on that
    file for two epochs, grids and saves at step 0 only, its warp
    launches counted from 0 and held to exactly one a step plus the
    step-0 grid's; then ``cli.generate_image`` on the generator file,
    seven sweep grids.  Returns the warp launches of the MNIST run."""
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.train.checkpoint import saved_steps

    with tempfile.TemporaryDirectory(prefix="eadgan_mnist_") as tmp, \
            environ(EADGAN_PLATFORM="cuda"):
        approx_jsonl = os.path.join(tmp, "approx.jsonl")
        t0 = time.perf_counter()
        run_module(torch, "eadgan_tpu_torch.cli.approximate_rpqmnxy",
                   ["--iterations", str(APPROX_ITERATIONS), "--ckpt_dir", tmp,
                    "--jsonl", approx_jsonl])
        approx_wall = time.perf_counter() - t0
        approx = read_records(approx_jsonl, ("affine_loss",))
        check([r["step"] for r in approx] == list(range(APPROX_ITERATIONS)), "approximator steps")
        approx_file = os.path.join(tmp, "rpqmnxy_approximator.pt")
        check(os.path.isfile(approx_file), "rpqmnxy_approximator.pt")

        jsonl = os.path.join(tmp, "mnist.jsonl")
        trace = os.path.join(tmp, "mnist_chain_trace.json")
        stn_cuda.reset_launch_count()  # counts from here read this run only
        t0 = time.perf_counter()
        with environ(EADGAN_TRACE=trace):
            run_module(torch, "eadgan_tpu_torch.cli.mnist", [
                "--batch_size", "128", "--compute", "f32", "--n_epochs", "2",
                "--max_steps", str(MNIST_STEPS),
                "--sample_interval", str(MNIST_STEPS), "--approximator", approx_file,
                "--data_dir", tmp, "--out_dir", os.path.join(tmp, "images"), "--ckpt_dir", tmp,
                "--jsonl", jsonl])
        wall = time.perf_counter() - t0
        launches = stn_cuda.launch_count
        records = read_records(jsonl, ("d_loss", "g_loss", "info_loss"))
        check([r["step"] for r in records] == list(range(MNIST_STEPS)), "mnist steps")
        want = MNIST_STEPS + MNIST_GRID_WARPS
        check(launches == want, f"mnist: warp launched {launches} times, expected {want}")
        for name in ["static", "original", "scaled"] + [f"varying_c{k}" for k in range(1, 8)]:
            check(os.path.isfile(os.path.join(tmp, "images", name, "0.png")), f"mnist grid {name}")
        for name in ("generator_0.pt", "encoder_0.pt"):
            check(os.path.isfile(os.path.join(tmp, name)), name)
        check(saved_steps(tmp, "mnist_train_state") == [0], "mnist train state")
        chained = chained_loop_ms(trace, 3)  # opt_g, opt_d, opt_info

        out = os.path.join(tmp, "test")
        run_module(torch, "eadgan_tpu_torch.cli.generate_image",
                   ["--checkpoint", os.path.join(tmp, "generator_0.pt"), "--out_dir", out])
        for k in range(1, 8):
            check(os.path.isfile(os.path.join(out, f"varying_c{k}", "0.png")),
                  f"generate_image grid varying_c{k}")
        check(not os.path.exists(os.path.join(out, "varying_c8")), "generate_image: 7 grids")
    emit({"trainer": "eadgan_tpu_torch.cli.approximate_rpqmnxy", "batch_size": 128,
          "steps": APPROX_ITERATIONS, "wall_s": approx_wall,
          "loop_step_ms_host_clock": loop_ms(approx), "last": approx[-1]})
    emit({"trainer": "eadgan_tpu_torch.cli.mnist", "batch_size": 128, "steps": MNIST_STEPS,
          "chain": 32, "warp_launches": launches, "expected_launches": want, "wall_s": wall,
          **chained, "last": records[-1]})
    emit({"inference_cli": "eadgan_tpu_torch.cli.generate_image", "checkpoint": "generator_0.pt",
          "grids": 7})
    return launches


SCORE_SYNTH_POS = 32  # the real archive's 32 positions a side: 61,440 synthetic sprites
SCORE_KEYS = {"betaVAE_metric", "factorVAE_metric", "factorVAE_metric_revised", "MIG_metric",
              "SAP_metric", "DCI_Lasso_disent_metric", "DCI_Lasso_complete_metric",
              "FStat_modu_metric", "FStat_expl_metric"}


def score_warp_launches(n_images: int, n_groups: int = 500, group_size: int = 100) -> int:
    """The warp launches of ``cli.score --metric all``, one a Representer
    batch: BetaVAE's and FactorVAE's groups, the 10% sample that
    FactorVAE's eval std, SAP, DCI and the F-statistic each represent, and
    MIG's 1,000 points."""
    calls = [group_size] * (2 * n_groups) + [n_images // 10] * 4 + [1000]
    return sum(-(-n // SCORE_BATCH) for n in calls)


RP_KEYS = ("d_loss", "g_loss", "cat_loss", "cont_loss", "affine_loss", "relative_cat_loss")
RP_STEPS, RP_GRID_WARPS = 20, 2  # the gray rp run: steps, and the step-0 grid's warps
RP_LONG_STEPS = 90  # the chained rp run on 3,840 sprites: 3 epochs of 30 batches


def phase_dsprites_trainers(torch):
    """The dSprites pipeline through its four CLIs at batch 128 on
    synthetic sprites (540 images, 4 batches an epoch), at the default
    ``--chain 32``: each run's warp launches are counted from 0 and must
    be exactly one per pxy step and three per rp step, plus the step-0
    grid's (pxy: one align; rp: one align and one distort), and the gray
    rp runs' chained steps the spectral norm's launches of the census's
    gray rp step (``sn.launches`` in the trace).  The gray rp
    run saves its train state at step 0 and the bf16 run resumes it per
    step (``--chain 1``) to the planned total (5 epochs, 20 steps).  Then
    a longer chained gray rp run on ``EADGAN_SYNTH_POS=8`` (3,840
    sprites, 30 batches an epoch, 3 epochs), whose windows the epoch ends
    clamp less.  After the gray rp run and after the colored one,
    ``cli.score --metric all`` scores that run's aligner and encoder files
    on ``EADGAN_SYNTH_POS=32`` (61,440 sprites, the real archive's size)
    at its defaults (500 groups, batch 500), its warp launches held to one
    a Representer batch.  Returns the launches by run."""
    from eadgan_tpu_torch.ops import adam_cuda, stn_cuda
    from eadgan_tpu_torch.tools.sn_bench import census, launches_per_step
    from eadgan_tpu_torch.train.checkpoint import saved_steps

    rp_sn = launches_per_step(census("rp", 4))  # the gray rp step's, by the layers' sizes
    launches, out = {}, []
    with tempfile.TemporaryDirectory(prefix="eadgan_sprites_") as tmp, \
            environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS="3"):

        def run(label, module, steps, per_step, grid, argv, keys, first=0):
            jsonl = os.path.join(tmp, f"{label}.jsonl")
            trace = os.path.join(tmp, f"{label}_chain_trace.json")
            adams = 1 if module.endswith(("pxy", "pxy_color")) else 2  # rp: opt_d, opt_info
            stn_cuda.reset_launch_count()  # counts from here read this run only
            adam_cuda.reset_launch_count()
            t0 = time.perf_counter()
            with environ(EADGAN_TRACE=trace):
                run_module(torch, module, ["--batch_size", "128", "--data_dir", tmp,
                                           "--out_dir", os.path.join(tmp, label), "--ckpt_dir", tmp,
                                           "--jsonl", jsonl, *argv])
            wall = time.perf_counter() - t0
            records = read_records(jsonl, keys)
            check([r["step"] for r in records] == list(range(first, first + steps)),
                  f"{label} steps {[r['step'] for r in records]}")
            want = per_step * steps + grid
            check(stn_cuda.launch_count == want,
                  f"{label}: warp launched {stn_cuda.launch_count} times, expected {want}")
            launches[label] = stn_cuda.launch_count
            check(adam_cuda.launch_count == adams * steps,
                  f"{label}: Adam kernel launched {adam_cuda.launch_count} times in {steps} steps")
            chained = "--chain" not in argv
            sn = rp_sn if module.endswith(".rp") else None  # held for the gray rp step
            loop = chained_loop_ms(trace, adams, sn) if chained else {
                "loop_step_ms_host_clock": loop_ms(records)}
            out.append({"trainer": module, "run": label, "batch_size": 128, "steps": steps,
                        "chain": 32 if chained else 1, "warp_launches": stn_cuda.launch_count,
                        "expected_launches": want, "adam_launches": adam_cuda.launch_count,
                        "wall_s": wall, **loop, "last": records[-1]})

        def score(label, colored, pxy_file):
            """``cli.score --metric all`` on the run's aligner and its
            ``encoder_0.pt`` (random weights after a step: scores are
            printed, not gated), on the 61,440-sprite stand-in."""
            out_json = os.path.join(tmp, f"{label}.json")
            argv = ["--metric", "all", "--encoder_pxy", pxy_file, "--encoder",
                    os.path.join(tmp, "encoder_0.pt"), "--data_dir", tmp, "--json_out", out_json]
            buf = io.StringIO()
            stn_cuda.reset_launch_count()  # counts from here read this run only
            t0 = time.perf_counter()
            with environ(EADGAN_SYNTH_POS=str(SCORE_SYNTH_POS)), contextlib.redirect_stdout(buf):
                run_module(torch, "eadgan_tpu_torch.cli.score", argv + (["--colored"] if colored else []))
            wall = time.perf_counter() - t0
            text = buf.getvalue()
            print(text, end="", flush=True)
            with open(out_json) as f:
                scores = json.load(f)
            check(set(scores) == SCORE_KEYS, f"{label}: score keys {sorted(scores)}")
            check("sklearn" not in sys.modules, f"{label}: the scorer imported scikit-learn")
            n_images = 3 * 4 * 5 * SCORE_SYNTH_POS ** 2
            want = score_warp_launches(n_images)
            check(stn_cuda.launch_count == want,
                  f"{label}: warp launched {stn_cuda.launch_count} times, expected {want}")
            launches[label] = stn_cuda.launch_count
            out.append({"score_cli": "eadgan_tpu_torch.cli.score", "run": label, "colored": colored,
                        "dataset_images": n_images, "n_groups": 500, "batch": SCORE_BATCH,
                        "warp_launches": stn_cuda.launch_count, "expected_launches": want,
                        "wall_s": wall,
                        "timing_s": json.loads(text.rsplit("score timing (s): ", 1)[1]),
                        "scores": scores})

        def grids(label, names):
            for name in names:
                check(os.path.isfile(os.path.join(tmp, label, name, "0.png")), f"{label} grid {name}")

        rp_grids = ["original", "trans"] + [f"varying_c{k}" for k in range(1, 8)]
        run("pxy", "eadgan_tpu_torch.cli.pxy", 20, 1, 1,
            ["--max_steps", "20", "--sample_interval", "20"], ["affine_loss"])
        grids("pxy", ["original", "align"])
        pxy_file = os.path.join(tmp, "encoder_pxy_0.pt")
        check(os.path.isfile(pxy_file), "encoder_pxy_0.pt")
        check(saved_steps(tmp, "encoder_pxy_train_state") == [0], "pxy train state")

        rp_args = ["--encoder_pxy", pxy_file, "--n_epochs", "5", "--keep_states", "1"]
        run("rp", "eadgan_tpu_torch.cli.rp", RP_STEPS, 3, RP_GRID_WARPS,
            rp_args + ["--compute", "f32", "--max_steps", str(RP_STEPS),
                       "--sample_interval", str(RP_STEPS)], RP_KEYS)
        grids("rp", rp_grids)
        for name in ("encoder_0.pt", "generator_0.pt"):
            check(os.path.isfile(os.path.join(tmp, name)), name)
        check(saved_steps(tmp, "rp_train_state") == [0], "rp train state")
        score("score_gray", False, pxy_file)
        # step 1 is inside epoch 0: its 3 remaining batches, then 4 epochs
        run("rp_resumed_bf16", "eadgan_tpu_torch.cli.rp", RP_STEPS - 1, 3, 0,
            rp_args + ["--resume", "auto", "--compute", "bf16", "--chain", "1",
                       "--sample_interval", "1000"], RP_KEYS, first=1)

        run("pxy_color", "eadgan_tpu_torch.cli.pxy_color", 10, 1, 1,
            ["--max_steps", "10", "--sample_interval", "10"], ["affine_loss"])
        color_file = os.path.join(tmp, "encoder_pxy_color_0.pt")
        check(os.path.isfile(color_file), "encoder_pxy_color_0.pt")
        run("rp_color", "eadgan_tpu_torch.cli.rp_color", 10, 3, 2,
            ["--encoder_pxy", color_file, "--compute", "f32", "--max_steps", "10",
             "--sample_interval", "10"], RP_KEYS)
        grids("rp_color", rp_grids)
        score("score_color", True, color_file)

        with environ(EADGAN_SYNTH_POS="8"):
            long_dir = os.path.join(tmp, "long")
            run("rp_long", "eadgan_tpu_torch.cli.rp", RP_LONG_STEPS, 3, RP_GRID_WARPS,
                ["--encoder_pxy", pxy_file, "--compute", "f32", "--n_epochs", "3",
                 "--sample_interval", "1000",
                 "--data_dir", long_dir, "--ckpt_dir", long_dir], RP_KEYS)
    for record in out:
        emit(record)
    return launches


def phase_probe(torch):
    """The fused conv's main path: its probe entry point at its defaults."""
    from eadgan_tpu_torch.ops import fused_conv_cuda

    with tempfile.TemporaryDirectory(prefix="eadgan_probe_") as tmp:
        out = os.path.join(tmp, "probe.json")
        fused_conv_cuda.reset_launch_count()  # counts from here read the main path only
        run_module(torch, "eadgan_tpu_torch.tools.fused_conv_probe", ["--out", out])
        launches = fused_conv_cuda.launch_count
        with open(out) as f:
            record = json.load(f)
    batch, hw, cin, cout = CONV_MAIN
    check(record["shape"] == [batch, hw, hw, cin, cout], f"probe shape {record['shape']}")
    check(record["timing"] == "cuda_events" and "cuda_fused" in record, f"probe record {record}")
    check(record["rel"] < CONV_TOL_REL, f"probe: kernel vs library rel {record['rel']}")
    check(record["plain_elem"] <= CONV_TOL_ELEM_MAIN, f"probe: kernel vs plain {record['plain_elem']}")
    check(launches >= 1, f"fused conv launched {launches} times by its probe")
    emit({"probe": "eadgan_tpu_torch.tools.fused_conv_probe", "fused_conv_launches": launches,
          "record": record})
    return {"fused_conv_lrelu": launches}, record


def bound(bytes_moved, flops, flops_per_s):
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


CHAIN_WINDOW = 32  # replays in a timed window of the chained step


def time_step(torch, pipeline, compute, dtype):
    """One pipeline's train step at B=128 by CUDA events: the median of
    30 single steps after 5 warm-up steps, with the warp's launches a
    step counted over those 30; then the same step chained, gathering
    its batch on the card: after its eager step and the capture (and the
    rest of that window), two windows of 32 replays, each timed by CUDA
    events, the median over 32, with the warp's launches a replay."""
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.utils.profiler import build_step, chained_replays, step_args

    batch = 128
    state, step, data, prep = build_step(pipeline, batch, dtype)
    args = step_args(data, prep, batch)
    for _ in range(5):
        step(state, *args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    warp_before = stn_cuda.launch_count
    t0 = time.perf_counter()
    for _ in range(30):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, metrics = step(state, *args)
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 30
    step_ms = statistics.median(s.elapsed_time(e) for s, e in events)
    check(all(math.isfinite(float(v)) for v in metrics.values()), f"step metrics {metrics}")
    record = {"step": f"{pipeline}_{compute}", "batch_size": batch, "median_ms_cuda_events": step_ms,
              "mean_ms_host_clock": host_ms, "img_per_s": batch / step_ms * 1e3,
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30, "samples": 30,
              "warp_launches_per_step": (stn_cuda.launch_count - warp_before) / 30}

    torch.cuda.reset_peak_memory_stats()  # the graph's pool is allocated at capture
    run = chained_replays(state, step, data, prep, batch, CHAIN_WINDOW)
    torch.cuda.synchronize()
    windows = []
    warp_before = stn_cuda.launch_count
    t0 = time.perf_counter()
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, packed = run()
        end.record()
        windows.append((start, end))
    torch.cuda.synchronize()
    chained_host_ms = (time.perf_counter() - t0) * 1e3 / (2 * CHAIN_WINDOW)
    chained_ms = statistics.median(s.elapsed_time(e) for s, e in windows) / CHAIN_WINDOW
    check(bool(torch.isfinite(packed).all()), f"chained {pipeline} metrics {packed[-1]}")
    record.update({
        "chained_ms_cuda_events": chained_ms, "chained_mean_ms_host_clock": chained_host_ms,
        "chained_img_per_s": batch / chained_ms * 1e3, "chained_window": CHAIN_WINDOW,
        "chained_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "chained_warp_launches_per_step": (stn_cuda.launch_count - warp_before) / (2 * CHAIN_WINDOW),
        "per_step_over_chained": step_ms / chained_ms,
    })
    del state, run
    return record


def time_warp(torch, n, h, w, c, cycles, gen, padding="border"):
    """(kernel, plain, library, wrapper host) ms and the bound of the warp
    at one f32 shape and padding."""
    import torch.nn.functional as F

    from eadgan_tpu_torch.ops.stn import warp_affine_plain
    from eadgan_tpu_torch.ops.stn_cuda import warp_affine_cuda
    from eadgan_tpu_torch.transforms import RPQXY, code_to_matrix
    from eadgan_tpu_torch.utils.timing import device_ms, host_enqueue_ms, host_ms_per_call

    img = torch.rand((n, h, w, c), generator=gen, device="cuda") * 2 - 1
    code = torch.rand((n, 8), generator=gen, device="cuda") * 2 - 1
    matrix = code_to_matrix(RPQXY, code[:, :5])
    theta = matrix[:, :2].contiguous()
    img_nchw = img.permute(0, 3, 1, 2)  # channels_last view, no copy

    def library():
        grid = F.affine_grid(theta, (n, c, h, w), align_corners=False)
        return F.grid_sample(img_nchw, grid, padding_mode=padding, align_corners=False)

    # the yardstick computes the same function; its own grid arithmetic
    # rounds differently (measured 1.6e-5 on an H100), hence 1e-4
    lib_err = (library().permute(0, 2, 3, 1) - warp_affine_cuda(img, matrix, padding)).abs().max().item()
    check(lib_err <= 1e-4, f"library call disagrees with the warp kernel: {lib_err}")
    elem = n * h * w * c
    bytes_moved = 2 * elem * 4 + n * 6 * 4  # image read once, output written once, theta
    flops = elem * 7 + n * h * w * 25  # 4-tap weighted sum per element, coordinates per pixel
    bound_ms, bound_by = bound(bytes_moved, flops, F32_FLOPS_PER_S)
    def kernel():
        return warp_affine_cuda(img, matrix, padding)

    return {
        "shape": [n, h, w, c],
        "padding": padding,
        "ms": device_ms(kernel, 200, cycles),
        "plain_ms": device_ms(lambda: warp_affine_plain(img, matrix, padding), 20, cycles),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": device_ms(library, 100, cycles),
        "wrapper_call_ms_host_clock": host_ms_per_call(kernel, 200),
        "wrapper_enqueue_ms_host_clock": host_enqueue_ms(kernel, 200),
        "library_vs_kernel_max_abs_err": lib_err,
    }


def time_inference(torch, cycles):
    """CelebA generator inference at batch 128 by CUDA events
    (``tools/quant_bench.py``): the float32 eval-mode forward (``cli.
    gen_imgs --quant none``), the BatchNorm-folded bf16 forward (``--quant
    bf16``) and the int8 one (``--quant int8``), each beside its bound,
    with the int8 forward's PSNR against the f32 eval forward on the same
    latents, gated at 25 dB, and the int8 layers' weight bytes."""
    from eadgan_tpu_torch.tools.quant_bench import measure

    record = measure(128, cycles)
    emit(record)
    check(record["int8"]["psnr_db_vs_f32_eval"] > INT8_PSNR_DB, f"int8 PSNR {record['int8']}")
    check(record["int8"]["equals_unchained"], "the chained int8 forward differs from its steps")
    check(all(p["kernels_in_trace"] for p in record["profile"].values()),
          "the int8 forwards' profiles show no kernel")
    return record


def time_int8_kernels(torch, cycles, errs, launches):
    """The two int8 kernels at the generator's three layers, batch 128, by
    CUDA events, as the int8 forward runs them: ``int8_convt`` writing
    float32 and its abs-max at layers 1 and 2 and bf16 at layer 3,
    ``quantize_int8`` with its own abs-max at layer 1's input and the
    abs-max given at layers 2 and 3's.  Each beside its plain version (on
    the card), its bound and its yardsticks: for ``int8_convt``,
    ``torch._int_mm`` on the four phases' im2col matrices (built
    beforehand) and cuDNN's bf16 ``F.conv_transpose2d`` at the same shape;
    for ``quantize_int8``, ``torch.amax(x.abs())`` (where the kernel takes
    its own) and the quantize expression.  ``int8_convt`` is also timed
    writing float32 at every layer and ``quantize_int8`` with its own
    abs-max at every layer (``ms_f32_out``, ``ms_own_amax``: the functions
    the forward ran before it chained them).  The entries' times are sums
    over the three layers (one forward's worth), with the layers
    alongside."""
    import torch.nn.functional as F

    from eadgan_tpu_torch.ops.quant import (int8_convt_relu, int8_convt_relu_plain,
                                            output_amax_plain, quantize_activation,
                                            quantize_activation_plain)
    from eadgan_tpu_torch.tools.quant_bench import int8_layer_inputs
    from eadgan_tpu_torch.utils.timing import device_ms, host_enqueue_ms

    batch = 128
    convt_layers, quant_layers = [], []
    for h, cin, cout in INT8_LAYERS:
        xq, a_scale, layer, act = int8_layer_inputs(batch, h, cin, cout)
        xq, a_scale, act = xq.cuda(), a_scale.cuda(), act.cuda()
        layer = type(layer)(*(t.cuda() for t in (layer.wq, layer.wp, layer.w_scale, layer.bias)))
        last = h == INT8_LAYERS[-1][0]  # the last int8 layer writes bf16 for layer 4
        out_dtype, with_amax = (torch.bfloat16, False) if last else (torch.float32, True)
        # im2col of each phase: the four taps' rows, K = 4 * Cin, as the kernel reads them
        padded = F.pad(xq, (0, 0, 1, 1, 1, 1))
        cols = [torch.cat([padded[:, 1 + py - ty:1 + py - ty + h, 1 + px - tx:1 + px - tx + h]
                           for ty in range(2) for tx in range(2)], dim=-1).reshape(-1, 4 * cin)
                for py in range(2) for px in range(2)]
        mats = [layer.wp[p].reshape(cout, 4 * cin).t() for p in range(4)]
        x_bf16 = torch.randn(batch, cin, h, h, device="cuda").to(torch.bfloat16)
        w_bf16 = layer.wq.to(torch.bfloat16)
        macs = batch * (2 * h) ** 2 * cout * cin * 4
        out_bytes = batch * (2 * h) ** 2 * cout * (2 if last else 4)
        nbytes = xq.numel() + layer.wp.numel() + out_bytes + 8 * cout
        bound_ms, bound_by = bound(nbytes, 2 * macs, INT8_TENSOR_OPS_PER_S)

        def kernel():
            return int8_convt_relu(xq, a_scale, layer, out_dtype, with_amax)

        def plain():
            out = int8_convt_relu_plain(xq, a_scale, layer.wq, layer.w_scale, layer.bias, out_dtype)
            return out, output_amax_plain(out)

        convt_layers.append({
            "shape": [batch, h, h, cin, cout], "out_dtype": str(out_dtype), "amax_out": with_amax,
            "ms": device_ms(kernel, 50, cycles),
            "ms_f32_out": device_ms(lambda: int8_convt_relu(xq, a_scale, layer), 50, cycles),
            "plain_ms": device_ms(plain, 3, cycles),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": device_ms(lambda: [torch._int_mm(a, b) for a, b in zip(cols, mats)], 50,
                                    cycles),
            "library_bf16_ms": device_ms(lambda: F.conv_transpose2d(x_bf16, w_bf16, None, 2, 1), 50,
                                         cycles),
            "wrapper_enqueue_ms_host_clock": host_enqueue_ms(kernel, 200),
        })
        convt_layers[-1]["tops_per_s"] = 2 * macs / convt_layers[-1]["ms"] / 1e9
        nhwc = h != 4
        amax = output_amax_plain(act) if nhwc else None  # layer 1's input is cuDNN's: no abs-max
        n = act.numel()

        def library(act=act, amax=amax):
            scale = torch.clamp_min(torch.amax(act.abs()) if amax is None else amax, 1e-12) / 127.0
            return torch.clamp(torch.round(act / scale), -127, 127).to(torch.int8)

        quant_layers.append({
            "shape": list(act.shape), "layout": "nhwc" if nhwc else "nchw",
            "amax": "own" if amax is None else "given",
            "ms": device_ms(lambda: quantize_activation(act, nhwc, amax), 50, cycles),
            "ms_own_amax": device_ms(lambda: quantize_activation(act, nhwc), 50, cycles),
            "plain_ms": device_ms(lambda: quantize_activation_plain(act, nhwc, amax), 20, cycles),
            "bound_ms": bound(5 * n, 0, 1)[0], "bound_by": "bytes",
            "library_ms": device_ms(library, 50, cycles),
            "wrapper_enqueue_ms_host_clock": host_enqueue_ms(
                lambda: quantize_activation(act, nhwc, amax), 200),
        })
        del cols, mats, padded
    entries = []
    for name, source, line, layers, extra in (
            ("int8_convt", "int8_convt.cu", 108, convt_layers, ("ms_f32_out", "library_bf16_ms")),
            ("quantize_int8", "quantize_int8.cu", 124, quant_layers, ("ms_own_amax",))):
        total = {k: sum(layer[k] for layer in layers)
                 for k in ("ms", "plain_ms", "bound_ms", "library_ms", *extra)}
        by_ops = sum(layer["bound_ms"] for layer in layers if layer["bound_by"] == "operations")
        entries.append({
            "name": name, "route": "cuda", "source": f"eadgan_tpu_torch/csrc/{source}",
            "replaces": f"eadgan_tpu/ops/quant.py:{line}", "replaces_kind": "xla_lowering",
            "launches": launches[name], "max_abs_err": errs[name], **total,
            # the larger share of the summed bound
            "bound_by": "operations" if 2 * by_ops >= total["bound_ms"] else "bytes",
            "timed_at": "batch 128, the three int8 layers summed, as the int8 forward runs them",
            "layers": layers,
        })
    emit({"int8_kernel_timing": entries})
    return entries


def time_representer(torch, cycles):
    """The scorer's Representer on the card by CUDA events: one batch of
    500 sprites under fresh weights (aligner, warp, encoder), gray and
    colored."""
    from eadgan_tpu_torch.cli.score import fresh_encoders
    from eadgan_tpu_torch.eval import Representer
    from eadgan_tpu_torch.utils.profiler import sprite_warp_inputs
    from eadgan_tpu_torch.utils.timing import device_ms

    record = {"representer": "eadgan_tpu_torch.eval.Representer", "batch": SCORE_BATCH}
    for colored in (False, True):
        rep = Representer(*fresh_encoders(colored), colored=colored, device="cuda")
        img, _ = sprite_warp_inputs(3 if colored else 1, "align", "cuda", batch=SCORE_BATCH)
        ms = device_ms(lambda: rep.represent(img), 50, cycles)
        record["colored" if colored else "gray"] = {"ms": ms, "img_per_s": SCORE_BATCH / ms * 1e3}
    emit(record)
    return record


def phase_timing(torch, errs, probe, int8_launches):
    """Kernel records for the ``kernels`` line; the fused conv's kernel
    and library times are those its probe measured on the main path, the
    int8 kernels' launches those of ``gen_imgs --quant int8``."""
    from eadgan_tpu_torch.ops.fused_conv import fused_conv_lrelu_plain
    from eadgan_tpu_torch.ops.fused_conv_cuda import fused_conv_lrelu_cuda
    from eadgan_tpu_torch.tools.adam_bench import time_optimizers
    from eadgan_tpu_torch.tools.fused_conv_probe import counts
    from eadgan_tpu_torch.tools.sn_bench import census, time_step_calls
    from eadgan_tpu_torch.utils.timing import (device_ms, host_enqueue_ms, host_ms_per_call,
                                               sleep_cycles_per_ms)

    # the train steps at B=128, f32 (TF32 off) and bf16
    steps = [time_step(torch, pipeline, compute, dtype) for pipeline, compute, dtype in (
        ("celeba", "f32", None), ("celeba", "bf16", torch.bfloat16), ("rp", "f32", None),
        ("rp", "bf16", torch.bfloat16), ("rp_color", "f32", None), ("mnist", "f32", None),
        ("mnist", "bf16", torch.bfloat16), ("approximator", "f32", None))]

    cycles = sleep_cycles_per_ms()
    gen = torch.Generator(device="cuda").manual_seed(1)
    # the warp at the CelebA and colored dSprites shape, and at C = 1 (gray
    # dSprites), where the TPU took its pair kernel (stn_pallas.py:116), in
    # both paddings there
    warp = time_warp(torch, 128, 64, 64, 3, cycles, gen)
    warp_c1 = time_warp(torch, 128, 64, 64, 1, cycles, gen)
    warp_c1_zeros = time_warp(torch, 128, 64, 64, 1, cycles, gen, padding="zeros")
    # the MNIST step's shape, which the TPU also took through its pair kernel
    warp_mnist = time_warp(torch, 128, 32, 32, 1, cycles, gen)
    # the scorer's: the Representer's batch of 500 in "zeros", C = 1 and 3
    warp_score_c1 = time_warp(torch, SCORE_BATCH, 64, 64, 1, cycles, gen, padding="zeros")
    warp_score_c3 = time_warp(torch, SCORE_BATCH, 64, 64, 3, cycles, gen, padding="zeros")
    emit({"warp_timing": warp, "warp_timing_c1": warp_c1, "warp_timing_c1_zeros": warp_c1_zeros,
          "warp_timing_mnist": warp_mnist, "warp_timing_score_c1": warp_score_c1,
          "warp_timing_score_c3": warp_score_c3})
    time_inference(torch, cycles)
    time_representer(torch, cycles)
    # the rp and MNIST steps' warps against their time (gray: C = 1,
    # colored: C = 3, MNIST: 32x32)
    for record in steps:
        if record["step"].startswith(("rp", "mnist")):
            one = {"rp_color": warp, "rp": warp_c1, "mnist": warp_mnist}[
                record["step"].rsplit("_", 1)[0]]
            record["warp_share_of_step"] = (record["warp_launches_per_step"] * one["ms"]
                                            / record["median_ms_cuda_events"])
            record["chained_warp_share_of_step"] = (record["chained_warp_launches_per_step"]
                                                    * one["ms"] / record["chained_ms_cuda_events"])
        emit(record)
    keys = ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "wrapper_call_ms_host_clock", "wrapper_enqueue_ms_host_clock")
    # one CUDA kernel replaces both Pallas bodies: the TPU took _kernel for
    # N odd or C * W > 128 (CelebA, colored dSprites) and _kernel_pair
    # otherwise (gray dSprites, MNIST); each entry reads its own paths
    warp_kernel = {
        "name": "warp_affine",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/warp_affine.cu",
        "replaces": "eadgan_tpu/ops/stn_pallas.py:50",
        "launches": None,
        "max_abs_err": errs["warp_affine"],
        **{k: warp[k] for k in keys},
        **{f"score_{k}": warp_score_c3[k] for k in keys},
        "score_max_abs_err": errs["warp_affine_score"],
    }
    pair_kernel = {
        "name": "warp_affine_pair",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/warp_affine.cu",
        "replaces": "eadgan_tpu/ops/stn_pallas.py:116",
        "launches": None,
        "max_abs_err": errs["warp_affine_pair"],
        **{k: warp_c1[k] for k in keys},
        **{f"zeros_{k}": warp_c1_zeros[k] for k in keys[1:]},
        **{f"mnist_{k}": warp_mnist[k] for k in keys},
        "mnist_max_abs_err": errs["warp_affine_pair_mnist"],
        **{f"score_{k}": warp_score_c1[k] for k in keys},
        "score_max_abs_err": errs["warp_affine_pair_score"],
    }

    # the fused conv at its main path's shape: its plain version, bound and
    # what a call costs on the host: back to back ending in a synchronize
    # (device-bound here), and enqueue only (the wrapper's checks, three
    # tensor maps encoded, the ctypes call)
    x, w, b = conv_inputs(torch, CONV_MAIN)
    nbytes, flops = counts(*CONV_MAIN)
    bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS_PER_S)
    conv_kernel = {
        "name": "fused_conv_lrelu",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/fused_conv_lrelu.cu",
        "replaces": "tools/fused_conv_probe.py:61",
        "shape": list(CONV_MAIN),
        "launches": None,
        "max_abs_err": errs["fused_conv_lrelu"],
        "ms": probe["cuda_fused"],
        "plain_ms": device_ms(lambda: fused_conv_lrelu_plain(x, w, b), 20, cycles),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": probe["library_conv_bias_lrelu"],
        "library_conv_only_ms": probe["library_conv_only"],
        "wrapper_call_ms_host_clock": host_ms_per_call(lambda: fused_conv_lrelu_cuda(x, w, b), 300),
        "wrapper_enqueue_ms_host_clock": host_enqueue_ms(lambda: fused_conv_lrelu_cuda(x, w, b), 300),
        "tflop_per_s": flops / probe["cuda_fused"] / 1e9,
        "library_vs_kernel_rel": probe["rel"],
        "plain_elem": probe["plain_elem"],
    }
    emit({"fused_conv_timing": conv_kernel})

    # the Adam kernel: CelebA's three optimizer steps against their bound,
    # its plain version, and torch's fused capturable Adam and the foreach
    # one the port ran before it (the yardsticks; the port calls neither)
    adam_timing = time_optimizers(cycles)
    adam_kernel = {
        "name": "adam_fused",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/adam_fused.cu",
        "replaces": "torch.optim.Adam(capturable=True) foreach; no Pallas kernel (XLA fuses optax)",
        "shape": "CelebA opt_g + opt_d + opt_info, 51.84 M elements",
        "launches": None,
        "max_abs_err": errs["adam_fused"],
        "ms": adam_timing["ms"],
        "plain_ms": adam_timing["plain_ms"],
        "bound_ms": adam_timing["bound_ms"],
        "bound_by": "bytes",
        "library_ms": adam_timing["fused_library_ms"],
        "library_foreach_ms": adam_timing["foreach_library_ms"],
        "bound_share": adam_timing["bound_share"],
    }
    emit({"adam_timing": adam_kernel})

    # the spectral norm: a CelebA step's 24 forwards and 20 backwards and an
    # rp step's 39 and 33, replayed from a CUDA graph, against their bound
    # and the plain version's (the layers' torch expression)
    sn_timing = {p: time_step_calls(census(p, 4)) for p in ("celeba", "rp")}
    emit({"sn_timing": sn_timing})
    celeba_sn = sn_timing["celeba"]
    sn_kernel = {
        "name": "spectral_norm",
        "route": "cuda",
        "source": "eadgan_tpu_torch/csrc/spectral_norm.cu",
        "replaces": "none: XLA's fusion of flax's SpectralNorm (torch's ~35 kernels a layer call before)",
        "shape": "CelebA D, 24 forwards + 20 backwards a step, 11.02 M elements",
        "launches": None,
        "max_rel_grad_gap": errs["spectral_norm_grad_gap"],  # of the largest element
        **{k: celeba_sn[k] for k in ("ms", "forward_ms", "backward_ms", "plain_ms", "bound_ms",
                                     "bound_share", "launches_per_step")},
        "bound_by": "bytes",
        "rp": {k: sn_timing["rp"][k] for k in ("ms", "forward_ms", "backward_ms", "plain_ms",
                                               "bound_ms", "launches_per_step")},
    }
    return [warp_kernel, pair_kernel, conv_kernel, adam_kernel, sn_kernel,
            *time_int8_kernels(torch, cycles, errs, int8_launches)]


# --- phase 6: robustness ----------------------------------------------------

ROBUST_BATCH, ROBUST_FACES = 128, 8192  # 64 batches an epoch: whole 32-step windows
ROBUST_STEPS = 200  # the SIGTERM drill's schedule
ROBUST_SIGTERM_AFTER = 64  # SIGTERM once a logged step reaches this
ROBUST_HANG_STEP, ROBUST_WATCHDOG = 40, 15  # the supervised drill
ROBUST_COST_WINDOWS = 8  # windows of 32 replays a run in the guard's cost


class Child:
    """A subprocess in a session of its own, its stdout and stderr lines
    collected with their host time as they arrive; leaving the ``with``
    kills the whole session if it still runs (a supervisor's trainer
    included), so no process outlives the phase that started it."""

    def __init__(self, argv, env):
        import threading

        self.lines = {"out": [], "err": []}
        self._cv = threading.Condition()
        self.proc = subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True, start_new_session=True)
        self._readers = [threading.Thread(target=self._read, args=(k, f), daemon=True)
                         for k, f in (("out", self.proc.stdout), ("err", self.proc.stderr))]
        for t in self._readers:
            t.start()

    def _read(self, key, stream):
        for line in stream:
            with self._cv:
                self.lines[key].append((time.perf_counter(), line.rstrip("\n")))
                self._cv.notify_all()
        with self._cv:
            self.lines[key].append((time.perf_counter(), None))  # end of stream
            self._cv.notify_all()

    def wait_line(self, pred, timeout, start=0):
        """``(index, host time, line)`` of the first stdout line from
        ``start`` on that ``pred`` accepts; fails at the end of the stream
        or after ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        with self._cv:
            i = start
            while True:
                out = self.lines["out"]
                while i < len(out):
                    t, line = out[i]
                    check(line is not None, f"{self.proc.args[:4]}: output ended before the line "
                          f"awaited; stderr tail {self.text('err')[-3000:]}")
                    if pred(line):
                        return i, t, line
                    i += 1
                left = deadline - time.monotonic()
                check(left > 0, f"{self.proc.args[:4]}: no awaited line in {timeout} s")
                self._cv.wait(min(left, 1.0))

    def wait(self, timeout):
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            fail(f"{self.proc.args[:4]} did not exit in {timeout} s")
        for t in self._readers:
            t.join(timeout=30)
        return rc

    def text(self, key):
        return "\n".join(line for _, line in self.lines[key] if line is not None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            self.proc.wait()


def logged_step(line: str, n_batches: int) -> int:
    """The step of a trainer's progress line, ``[Epoch e/n] [Batch b/m] ...``
    (-1 for any other line)."""
    if not line.startswith("[Epoch "):
        return -1
    epoch = int(line.split("]")[0].split()[1].split("/")[0])
    batch = int(line.split("[Batch ")[1].split("/")[0])
    return epoch * n_batches + batch


def robust_env(**extra):
    return dict(os.environ, EADGAN_PLATFORM="cuda", EADGAN_SYNTH_N=str(ROBUST_FACES),
                PYTHONUNBUFFERED="1",
                PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])),
                **extra)


def robust_stop_in_process(torch):
    """(a) ``run_epochs`` at ``--chain 32``, CelebA f32 at batch 128, cuDNN
    deterministic: an inline event sets ``stop_event`` at step 40; the
    state ``on_shutdown`` copies at its step S equals, bit for bit, that of
    ``run_epochs(max_steps=S)`` from the same seed and weights
    (``tools/stop_check.py``); the warp's launches of the stopped run, one
    a step, are this slice's main path."""
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.tools.stop_check import run_stop_check

    stn_cuda.reset_launch_count()  # counts from here read this path only
    report = run_stop_check("celeba", batch=ROBUST_BATCH, chain=32, stop_at=ROBUST_HANG_STEP,
                            n_images=ROBUST_FACES)
    launches = stn_cuda.launch_count - report["warp_launches"]  # run B's
    emit({"robust_stop": {k: v for k, v in report.items() if k != "window_ends"}})
    check(report["ok"], f"a graceful stop against a run to the same step: {report}")
    check(report["warp_launches"] == report["stopped_at"],
          f"warp launches in the stopped run: {report['warp_launches']}")
    check(launches == report["stopped_at"], f"warp launches in the max_steps run: {launches}")
    return report


def robust_sigterm_cli(torch):
    """(b) ``cli.celeba --batch_size 128 --max_steps 200`` (default
    ``--chain 32``, f32) gets SIGTERM once a logged step reaches 64: exit
    86 at a window end S with the final train state written, then
    ``--resume auto --max_steps 200-S`` ends at step 200 with exit 0."""
    import signal

    from eadgan_tpu_torch.train.chain import plan_windows

    module = "eadgan_tpu_torch.cli.celeba"
    n_batches = ROBUST_FACES // ROBUST_BATCH
    ends = set()  # the window ends of the schedule, as the engine plans them
    for e in range(ROBUST_STEPS // n_batches + 1):
        for ws, k in plan_windows(e * n_batches, n_batches, 32, (4000, 60000), ROBUST_STEPS):
            ends.add(ws + k)
    with tempfile.TemporaryDirectory(prefix="eadgan_robust_") as tmp:
        common = [sys.executable, "-m", module, "--batch_size", str(ROBUST_BATCH), "--compute", "f32",
                  "--data_dir", tmp, "--out_dir", os.path.join(tmp, "images"), "--ckpt_dir", tmp]
        t_start = time.perf_counter()
        with Child(common + ["--max_steps", str(ROBUST_STEPS)], robust_env()) as child:
            _, t_seen, seen = child.wait_line(
                lambda l: logged_step(l, n_batches) >= ROBUST_SIGTERM_AFTER, timeout=300)
            t_sig = time.perf_counter()
            child.proc.send_signal(signal.SIGTERM)
            rc = child.wait(timeout=120)
            t_exit = time.perf_counter()
            out, err = child.text("out"), child.text("err")
        check(rc == 86, f"SIGTERM: exit {rc}, stderr tail {err[-3000:]}")
        check("preemption: caught signal" in err, "the guard's notice")
        line = [x for x in out.splitlines()
                if x.startswith("graceful shutdown: saving final train state at step ")]
        check(len(line) == 1, f"the final-save line: {line}")
        stopped = int(line[0].rsplit(" ", 1)[1])
        saved_s = float([x for x in out.splitlines()
                         if x.startswith("graceful shutdown: final train state saved in ")][0]
                        .split(" in ")[1].split()[0])
        check(stopped in ends and logged_step(seen, n_batches) < stopped < ROBUST_STEPS,
              f"stopped at {stopped}: not a window end past the logged step {seen!r}")
        path = os.path.join(tmp, f"celeba_train_state_{stopped}.ckpt")
        check(os.path.isfile(path), f"missing {path}")
        check(torch.load(path, weights_only=True)["step"] == stopped, "the final file's step")

        jsonl = os.path.join(tmp, "resumed.jsonl")
        t0 = time.perf_counter()
        with Child(common + ["--resume", "auto", "--max_steps", str(ROBUST_STEPS - stopped),
                             "--jsonl", jsonl], robust_env()) as child:
            rc = child.wait(timeout=300)
            err = child.text("err")
        resume_wall = time.perf_counter() - t0
        check(rc == 0, f"--resume auto after SIGTERM: exit {rc}, stderr tail {err[-3000:]}")
        steps = [r["step"] for r in read_records(jsonl)]
        check(steps == list(range(stopped, ROBUST_STEPS)),
              f"resumed steps {steps[:3]}..{steps[-3:]}")
    record = {"sigterm_cli": module, "batch_size": ROBUST_BATCH, "compute": "f32", "chain": 32,
              "max_steps": ROBUST_STEPS, "sigterm_after_logged_step": logged_step(seen, n_batches),
              "stopped_at": stopped, "exit": 86, "sigterm_to_exit_s": t_exit - t_sig,
              "final_save_s": saved_s, "start_to_sigterm_s": t_sig - t_start,
              "seen_to_sigterm_s": t_sig - t_seen, "resume_wall_s": resume_wall,
              "resumed_to": ROBUST_STEPS}
    emit(record)
    return record


def robust_supervised_stall(torch):
    """(c) ``cli.supervise --max_restarts 1 celeba -- ... --watchdog 15``
    (bf16, ``--chain 32``, 96 steps) with ``EADGAN_FAULT_HANG_STEP=40``
    and a marker file: the first life hangs at its first beat past step
    40, its watchdog exits 87 with a stall record and every thread's
    stack, the supervisor relaunches it with ``--resume auto`` (the
    marker keeps the fault from firing again) and the second life exits
    0.  The restart cost is the host time from the relaunch line to the
    second life's first logged step."""
    from eadgan_tpu_torch.ops import _build

    n_batches = ROBUST_FACES // ROBUST_BATCH
    # phase 1 built the kernels: the trainers load them from the build cache
    warm = _build.LIBRARY.path is not None and _build.LIBRARY.path.is_file()
    with tempfile.TemporaryDirectory(prefix="eadgan_robust_") as tmp:
        marker = os.path.join(tmp, "fault_fired")
        argv = [sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--max_restarts", "1",
                "celeba", "--", "--batch_size", str(ROBUST_BATCH), "--compute", "bf16", "--max_steps", "96",
                "--data_dir", tmp, "--out_dir", os.path.join(tmp, "images"), "--ckpt_dir", tmp,
                "--watchdog", str(ROBUST_WATCHDOG)]
        env = robust_env(EADGAN_FAULT_HANG_STEP=str(ROBUST_HANG_STEP),
                         EADGAN_FAULT_HANG_MARKER=marker)
        t_start = time.perf_counter()
        with Child(argv, env) as child:
            i_hang, t_hang, hang = child.wait_line(
                lambda l: l.startswith("fault injection: hanging at step"), timeout=300)
            i_restart, t_restart, _ = child.wait_line(
                lambda l: "restart 1/1 with --resume auto" in l, timeout=ROBUST_WATCHDOG + 120,
                start=i_hang)
            _, t_restored, restored = child.wait_line(
                lambda l: l.startswith("--resume auto: restored"), timeout=300, start=i_restart)
            _, t_first, first = child.wait_line(lambda l: logged_step(l, n_batches) >= 0,
                                                timeout=300, start=i_restart)
            rc = child.wait(timeout=300)
            out, err = child.text("out"), child.text("err")
        wall = time.perf_counter() - t_start
        check(rc == 0, f"supervised run: exit {rc}, stderr tail {err[-3000:]}")
        check("child exited 87 (watchdog stall)" in out, "the supervisor saw no exit 87")
        check("finished cleanly after 1 restart(s)" in out, "the second life did not finish")
        check('"event": "watchdog_stall"' in err, "no stall record on stderr")
        check("Thread 0x" in err or "Current thread" in err, "no thread stacks on stderr")
        check(os.path.isfile(marker), "the fault never fired")
        stall = json.loads(next(x for x in err.splitlines() if '"watchdog_stall"' in x))
    record = {"supervised_stall": "celeba", "batch_size": ROBUST_BATCH, "compute": "bf16", "chain": 32,
              "watchdog_s": ROBUST_WATCHDOG, "hang": hang, "stall_record": stall,
              "hang_to_relaunch_s": t_restart - t_hang, "relaunch_to_restored_s":
              t_restored - t_restart, "restored": restored,
              "relaunch_to_first_logged_step_s": t_first - t_restart,
              "first_logged_step": logged_step(first, n_batches), "wall_s": wall,
              "exits": [87, 0], "kernel_cache_warm": warm}
    emit(record)
    return record


def robust_guard_cost(torch):
    """(d) The replayed CelebA bf16 step at batch 128 through ``run_epochs``
    (``--chain 32``, 8 windows of 32, inline event at each window end),
    without the guard and the watchdog, then with the SIGTERM guard armed
    and ``watchdog=60``, then as the first with the port's tracing on
    (``EADGAN_TRACE``, the graph captured with its stamps): phase 5's
    method, CUDA events recorded at the window ends, the median over the
    windows after the capture's of each window's time over 32, and the
    loop step by host clock at the window ends, from the end of the
    second window to the last's over the steps between (as
    :func:`chained_loop_ms` reads it); traced, also the trace's split."""
    from eadgan_tpu_torch.data.celeba import _synthetic_faces
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils.preempt import PreemptionGuard
    from eadgan_tpu_torch.utils.profiler import build_step

    faces = _synthetic_faces(n=ROBUST_FACES, size=64, seed=0)
    record = {"guard_cost": "celeba_bf16", "batch_size": ROBUST_BATCH, "chain": CHAIN_WINDOW,
              "windows": ROBUST_COST_WINDOWS}
    for mode in ("off", "guard_and_watchdog_60", "off_traced"):
        armed = mode == "guard_and_watchdog_60"
        state, step, _, prep = build_step("celeba", ROBUST_BATCH, torch.bfloat16)
        marks, ends = [], []

        def on_batch(i, st, metrics, batch):
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            ends.append(time.perf_counter())

        guard = PreemptionGuard().install() if armed else None
        with tempfile.TemporaryDirectory(prefix="eadgan_cost_") as tmp:
            trace = os.path.join(tmp, "trace.json")
            try:
                with environ(EADGAN_TRACE=trace if mode == "off_traced" else ""):
                    run_epochs(n_epochs=ROBUST_COST_WINDOWS, data=faces, batch_size=ROBUST_BATCH,
                               state=state, step_fn=step, on_batch=on_batch, device="cuda",
                               max_steps=CHAIN_WINDOW * ROBUST_COST_WINDOWS, chain=CHAIN_WINDOW,
                               watchdog=60.0 if armed else 0.0,
                               stop_event=guard.requested if armed else None,
                               on_shutdown=lambda *a: None, **prep)
            finally:
                if guard is not None:
                    guard.uninstall()
            torch.cuda.synchronize()
            split = chained_loop_ms(trace, CELEBA_ADAMS) if mode == "off_traced" else {}
        check(guard is None or not guard.requested.is_set(), "the guard saw a signal")
        windows = [a.elapsed_time(b) / CHAIN_WINDOW for a, b in zip(marks[1:], marks[2:])]
        record[mode] = {"replayed_ms_cuda_events": statistics.median(windows),
                        "window_ms_range": [min(windows), max(windows)],
                        "loop_step_ms_host_clock": (ends[-1] - ends[1]) * 1e3
                        / (CHAIN_WINDOW * (len(ends) - 2)),
                        **{k: split[k] for k in ("trace_ms_per_step", "stamped_ms_per_step")
                           if k in split}}
        del state
    record["armed_minus_off_ms"] = (record["guard_and_watchdog_60"]["replayed_ms_cuda_events"]
                                    - record["off"]["replayed_ms_cuda_events"])
    record["traced_minus_off_ms"] = (record["off_traced"]["replayed_ms_cuda_events"]
                                     - record["off"]["replayed_ms_cuda_events"])
    emit(record)
    return record


def phase_robustness(torch):
    """(a)-(d); returns the warp's launches on this slice's main path, the
    stopped run of (a)."""
    t0 = time.perf_counter()
    stop = robust_stop_in_process(torch)
    robust_sigterm_cli(torch)
    robust_supervised_stall(torch)
    robust_guard_cost(torch)
    emit({"robustness_phase_s": time.perf_counter() - t0})
    return stop["warp_launches"]

# --- phase 7: data-parallel training ------------------------------------------

DP_STEPS, DP_CHAIN = 64, 32  # (a): CelebA bf16 at batch 128, windows of 32 replays
GANG_BATCH, GANG_STEPS = 128, 8  # (b): the gray rp gang's global batch and steps
# logged losses of the two-rank gang against one rank at the same global
# batch, as tests/test_torch_port_multiprocess.py states them: step 0, after
GANG_RTOL0, GANG_RTOL = 1e-5, 1e-3


def dp_world1(torch):
    """(a) The CelebA bf16 chained trainer through ``run_epochs`` in a NCCL
    group of one, 64 steps at batch 128 from copies of one state under
    deterministic cuDNN, plain, ``data_parallel`` and ``data_parallel`` +
    ``zero_opt``: every logged loss and state tensor bit-equal, the
    all-reduces a step, the replayed step of each form and what a traced
    window of each adds by kernel (``tools/dp_check.py``).  The
    data-parallel runs' warp launches (one a step, counted from 0 before
    each run) are the path ``celeba_dp``."""
    from eadgan_tpu_torch.tools.dp_check import run_dp_check

    report = run_dp_check("celeba", torch.bfloat16, steps=DP_STEPS, chain=DP_CHAIN, batch=128,
                          profile=True)
    emit({"dp_world1": report})
    check(report["backend"] == "nccl", f"the group of one runs {report['backend']}")
    check(report["ok"], f"data-parallel and ZeRO runs against the plain one: {report}")
    return report["warp_launches"]["dp"] + report["warp_launches"]["zero"], report


def dp_refusals(torch):
    """Two NCCL ranks on the one card raise before either joins; in a gloo
    group on the card the chained engine (a graph capture) raises."""
    import torch.distributed as dist

    from eadgan_tpu_torch.parallel import join_local, multihost
    from eadgan_tpu_torch.train.engine import run_epochs
    from eadgan_tpu_torch.utils.profiler import build_step

    check(not dist.is_initialized(), "a process group is still joined")
    refused = {}
    with environ(EADGAN_DIST_BACKEND=""):
        for rank in (0, 1):
            try:
                multihost.initialize("localhost:1", 2, rank, device="cuda")
            except RuntimeError as e:
                refused[rank] = str(e)
    check(sorted(refused) == [0, 1] and all("NCCL cannot run two ranks on one card" in m
                                            for m in refused.values()),
          f"two NCCL ranks on one card: {refused}")
    check(not dist.is_initialized(), "a refused rank joined")
    with environ(EADGAN_DIST_BACKEND="gloo"):
        join_local("cuda")
        try:
            check(multihost.backend() == "gloo", "EADGAN_DIST_BACKEND=gloo")
            state, step, data, prep = build_step("rp", 8)
            try:
                run_epochs(n_epochs=1, data=data, batch_size=8, state=state, step_fn=step,
                           on_batch=None, device="cuda", max_steps=2, chain=32,
                           data_parallel=True, **prep)
                gloo_capture = None
            except ValueError as e:
                gloo_capture = str(e)
        finally:
            dist.destroy_process_group()
    check(gloo_capture is not None and "cannot be captured" in gloo_capture,
          f"gloo --chain 32 on the card: {gloo_capture}")
    record = {"dp_refusals": {"nccl_shared_card": refused, "gloo_chain_32": gloo_capture}}
    emit(record)
    return record


def _gang_reports(directory):
    """The warp launches each rank of a gang wrote at exit
    (``EADGAN_LAUNCH_REPORT``), by rank."""
    out = {}
    for name in os.listdir(directory):
        if name.startswith("warp_launches."):
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
            if rec["rank"] != "":  # not the supervisor
                out[int(rec["rank"])] = rec["launches"]
    return out


def dp_gang(torch):
    """(b) Two ranks sharing the card over gloo: ``cli.supervise --ranks 2
    rp -- --data_parallel --chain 1 --compute f32`` at batch 128 for 8
    steps against one rank at the same global batch (losses within the CPU
    tests' tolerance; rank 0 alone logs, renders and saves: rank 1
    launched the warp exactly 3 a step, no grid's); then the gang-stop
    drill, the two ranks started directly: SIGTERM to rank 1 alone, both
    exit 86 at one step S with one final train-state file, which
    ``--resume auto`` continues in one process.  The gang's warp launches
    (each rank on its slice) are the path ``rp_gang``."""
    import signal

    from eadgan_tpu_torch.cli.supervise import _free_port
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.train.checkpoint import saved_steps

    record = {"dp_gang": "rp", "ranks": 2, "backend": "gloo", "batch_size": GANG_BATCH, "compute": "f32",
              "chain": 1, "steps": GANG_STEPS}
    with tempfile.TemporaryDirectory(prefix="eadgan_gang_") as tmp:
        reports = os.path.join(tmp, "reports")
        os.makedirs(reports)
        rp_argv = ["--allow_fresh_pxy", "--batch_size", str(GANG_BATCH), "--chain", "1", "--compute", "f32",
                   "--sample_interval", str(GANG_STEPS), "--data_dir", tmp]
        gang_dir, one_dir = os.path.join(tmp, "gang"), os.path.join(tmp, "one")
        env = robust_env(EADGAN_SYNTH_POS="3", EADGAN_DIST_BACKEND="gloo",
                         EADGAN_LAUNCH_REPORT=reports)
        argv = [sys.executable, "-m", "eadgan_tpu_torch.cli.supervise", "--ranks", "2", "rp", "--",
                *rp_argv, "--max_steps", str(GANG_STEPS), "--data_parallel",
                "--out_dir", os.path.join(gang_dir, "images"), "--ckpt_dir", gang_dir,
                "--jsonl", os.path.join(gang_dir, "gang.jsonl")]
        t0 = time.perf_counter()
        with Child(argv, env) as child:
            rc = child.wait(timeout=300)
            out, err = child.text("out"), child.text("err")
        record["gang_wall_s"] = time.perf_counter() - t0
        check(rc == 0, f"the two-rank gang: exit {rc}, stderr tail {err[-3000:]}")
        check("x2 ranks" in out, "the supervisor launched no gang")
        by_rank = _gang_reports(reports)
        check(by_rank == {0: 3 * GANG_STEPS + RP_GRID_WARPS, 1: 3 * GANG_STEPS},
              f"the ranks' warp launches {by_rank}: rank 0 renders the step-0 grid alone")
        gang = read_records(os.path.join(gang_dir, "gang.jsonl"), RP_KEYS)
        check([r["step"] for r in gang] == list(range(GANG_STEPS)), "gang: one log, rank 0's")
        check(saved_steps(gang_dir, "rp_train_state") == [0], "gang: one train state, step 0")

        stn_cuda.reset_launch_count()
        with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS="3"):
            run_module(torch, "eadgan_tpu_torch.cli.rp", [
                *rp_argv, "--max_steps", str(GANG_STEPS), "--out_dir", os.path.join(one_dir, "images"),
                "--ckpt_dir", one_dir, "--jsonl", os.path.join(one_dir, "one.jsonl")])
        one = read_records(os.path.join(one_dir, "one.jsonl"), RP_KEYS)
        worst = [max(abs(g[k] - o[k]) / abs(o[k]) for k in RP_KEYS) for g, o in zip(gang, one)]
        record.update({"rel_diff_by_step": worst, "rtol": [GANG_RTOL0, GANG_RTOL],
                       "warp_launches_by_rank": by_rank, "one_rank_warp_launches": stn_cuda.launch_count})
        check(len(one) == GANG_STEPS and worst[0] <= GANG_RTOL0 and max(worst) <= GANG_RTOL,
              f"the gang against one rank at batch {GANG_BATCH}: {worst}")

        # the gang-stop drill
        drill_dir = os.path.join(tmp, "drill")
        port = str(_free_port())
        ranks = []
        common = [sys.executable, "-m", "eadgan_tpu_torch.cli.rp", *rp_argv, "--max_steps", "2000",
                  "--data_parallel", "--out_dir", os.path.join(drill_dir, "images"),
                  "--ckpt_dir", drill_dir]
        with contextlib.ExitStack() as stack:
            for r in range(2):
                ranks.append(stack.enter_context(Child(common, robust_env(
                    EADGAN_SYNTH_POS="8", EADGAN_DIST_BACKEND="gloo", EADGAN_MP_PROCESS_ID=str(r),
                    EADGAN_MP_NUM_PROCESSES="2", EADGAN_MP_COORDINATOR=f"localhost:{port}"))))
            ranks[0].wait_line(lambda l: logged_step(l, 3840 // GANG_BATCH) >= 0, timeout=300)
            t_sig = time.perf_counter()
            ranks[1].proc.send_signal(signal.SIGTERM)
            rcs = [c.wait(timeout=180) for c in ranks]
            t_exit = time.perf_counter()
            outs = [c.text("out") for c in ranks]
            errs = [c.text("err") for c in ranks]
        check(rcs == [86, 86], f"gang stop: exits {rcs}, stderr tails {[e[-2000:] for e in errs]}")
        saving = [l for l in outs[0].splitlines()
                  if l.startswith("graceful shutdown: saving final train state at step ")]
        stopped = [l for l in outs[1].splitlines()
                   if l.startswith("graceful shutdown: rank 1 stopped at step ")]
        check(len(saving) == len(stopped) == 1, f"stop lines {saving} {stopped}")
        s0, s1 = int(saving[0].rsplit(" ", 1)[1]), int(stopped[0].rsplit(" ", 1)[1])
        check(s0 == s1 > 0, f"the ranks stopped at steps {s0} and {s1}")
        check(saved_steps(drill_dir, "rp_train_state") == [s0, 0],
              f"drill train states {saved_steps(drill_dir, 'rp_train_state')}")
        jsonl = os.path.join(drill_dir, "resumed.jsonl")
        with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS="8"):
            run_module(torch, "eadgan_tpu_torch.cli.rp", [
                *rp_argv, "--resume", "auto", "--max_steps", "4", "--out_dir",
                os.path.join(drill_dir, "images"), "--ckpt_dir", drill_dir, "--jsonl", jsonl])
        resumed = [r["step"] for r in read_records(jsonl, RP_KEYS)]
        check(resumed == list(range(s0, s0 + 4)), f"--resume auto after the gang stop: {resumed}")
        record.update({"drill_stopped_at": s0, "drill_exits": rcs,
                       "drill_sigterm_to_exits_s": t_exit - t_sig, "drill_resumed_steps": resumed})
    emit(record)
    return sum(by_rank.values()), record


def phase_data_parallel(torch):
    """(a), the refusals, (b); returns the warp's launches on the two new
    paths."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    try:
        celeba_dp, _ = dp_world1(torch)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    dp_refusals(torch)
    rp_gang, _ = dp_gang(torch)
    emit({"data_parallel_phase_s": time.perf_counter() - t0})
    return {"celeba_dp": celeba_dp, "rp_gang": rp_gang}


# --- phase 8: the model axis ----------------------------------------------------

TP_WORLD1_STEPS, TP_WORLD1_BATCH = 16, 128  # (a): CelebA bf16 on a (1, 1) grid
TP_SHARED = dict(grid=(1, 2), batch=128, steps=4)  # (b), f32 as every tp_check run
TP_ZERO = dict(grid=(2, 2), zero_opt=True, batch=32, steps=3, save_at=2,  # (c)
               resume_grid=(1, 2))


def tp_world1(torch):
    """(a) A NCCL group of one as a (1, 1) grid: the CelebA bf16 step at
    batch 128 for 16 steps from copies of one state, plain against
    ``data_parallel_step(step, mesh)`` after ``replicate`` and
    ``shard_model_params`` (which cut nothing at model 1), under
    deterministic cuDNN: every loss and state tensor bit-equal, no
    model-axis collective.  Its warp launches (one a step) count toward
    the path ``celeba_tp``."""
    import torch.distributed as dist

    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.parallel.mesh import model_collectives, reset_model_collectives
    from eadgan_tpu_torch.tools.chain_check import _cudnn_deterministic
    from eadgan_tpu_torch.tools.dp_check import _equal
    from eadgan_tpu_torch.tools.tp_check import inputs
    from eadgan_tpu_torch.train.chain import snapshot_state
    from eadgan_tpu_torch.train.checkpoint import train_state_payload
    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

    check(not dist.is_initialized(), "a process group is still joined")
    device = parallel.join_local("cuda")
    try:
        check(parallel.multihost.backend() == "nccl", "the group of one is not NCCL")
        mesh = parallel.default_mesh(1)
        config = CelebaConfig(batch_size=TP_WORLD1_BATCH)
        state = init_celeba_gan_state(config, device=device, seed=0, dtype=torch.bfloat16)
        twin = snapshot_state(state)
        parallel.replicate(twin)
        parallel.shard_model_params(mesh, twin)
        imgs = torch.from_numpy(inputs(TP_WORLD1_BATCH, 0)[0]).to(device)
        plain, grid = make_celeba_gan_step(config), parallel.data_parallel_step(
            make_celeba_gan_step(config), mesh)
        losses, equal, launches = [], True, 0
        with _cudnn_deterministic():
            reset_model_collectives()
            for _ in range(TP_WORLD1_STEPS):
                state, m = plain(state, imgs)
                before = stn_cuda.launch_count  # the grid's launches only
                twin, m_grid = grid(twin, imgs)
                launches += stn_cuda.launch_count - before
                equal &= all(torch.equal(m[k], m_grid[k]) for k in m)
                losses.append({k: float(v) for k, v in m_grid.items()})
            torch.cuda.synchronize()
        collectives = model_collectives()
        states_equal = _equal(train_state_payload(state), train_state_payload(twin))
    finally:
        dist.destroy_process_group()
    record = {"tp_world1": "celeba", "grid": [1, 1], "compute": "bf16", "batch": TP_WORLD1_BATCH,
              "steps": TP_WORLD1_STEPS, "losses_equal": bool(equal), "states_equal": states_equal,
              "model_collectives": collectives, "warp_launches": launches,
              "last_losses": losses[-1]}
    emit(record)
    check(equal and states_equal, "a (1, 1) grid against no grid: not bit-equal")
    check(all(v["count"] == 0 for v in collectives.values()),
          f"a (1, 1) grid issued model collectives {collectives}")
    check(launches == TP_WORLD1_STEPS, f"the (1, 1) grid launched the warp {launches} times")
    return launches, record


def tp_gang(torch, label, settings):
    """``tools/tp_check.py`` on the card with ``settings``: ranks sharing
    the card over gloo, the CelebA f32 step per step against one rank in
    this process at the JAX 2-D test's bars, the per-rank bytes and the
    model-axis collectives a step.  Every rank must exit 0; the warp's
    launches of all ranks (one a step each, resumed ranks included) are
    returned for the ``kernels`` line."""
    from eadgan_tpu_torch.tools.tp_check import run_tp_check

    report = run_tp_check(device="cuda", **settings)
    emit({label: report})
    steps = settings["steps"]
    world = settings["grid"][0] * settings["grid"][1]
    launches = report["warp_launches_by_rank"]
    check(report["ok"], f"{label}: the grid against one rank {report}")
    check(report["backend"] == "gloo", f"{label}: the shared card ran {report['backend']}")
    check(sorted(launches.values()) == [steps] * world, f"{label}: warp launches {launches}")
    total = sum(launches.values())
    if "resume" in report:
        resumed = report["resume"]["warp_launches_by_rank"]
        check(sorted(resumed.values()) == [steps - settings["save_at"]] * len(resumed),
              f"{label}: resumed warp launches {resumed}")
        total += sum(resumed.values())
    return total, report


def phase_model_axis(torch):
    """(a), (b), (c); returns the warp's launches on the two new paths."""
    t0 = time.perf_counter()
    world1, _ = tp_world1(torch)
    shared, _ = tp_gang(torch, "tp_shared_1x2", TP_SHARED)
    zero, _ = tp_gang(torch, "tp_zero_2x2_resume_1x2", TP_ZERO)
    emit({"model_axis_phase_s": time.perf_counter() - t0})
    return {"celeba_tp": world1 + shared, "celeba_tp_zero": zero}

# --- phase 9: the host-fed data path and DCI ----------------------------------

BATCHER_ROWS = 8192  # rows of each stand-in dataset the batcher gathers from (100 MB at CelebA's)
BATCHER_REPEATS = 20  # gathers timed a case, median
FEED_FACES = 640  # (c): CelebA's per-step run, 5 batches an epoch
FEED_STEPS = 40
RAWWIN_FACES, RAWWIN_STEPS = 8192, 64  # (d): 64 batches an epoch, one epoch


def _median_ms(fn, repeats=BATCHER_REPEATS) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def feed_batcher(torch):
    """(a) The native gathers on the card's host, bit-equal to their plain
    versions at CelebA's (128, 64, 64, 3) with mixed flips, at gray rp's
    (128, 64, 64) and colorized; ms a batch at 1, 2, 4 and 8 threads
    beside numpy's (host clock, median of 20).  Then one CelebA batch onto the
    card the old way (the numpy gather, a pageable copy) against the new
    (the native gather into pinned memory, an asynchronous copy on the
    stager's stream), each to a synchronize, and the new way's enqueue."""
    import numpy as np

    from eadgan_tpu_torch.data import native
    from eadgan_tpu_torch.data.loader import PinnedStager
    from eadgan_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_host_library()
    lib = _build.HOST_LIBRARY
    emit({"host_batcher": lib.path.name, "build_s": lib.build_seconds,
          "load_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    faces = rng.integers(0, 256, (BATCHER_ROWS, 64, 64, 3), np.uint8)
    sprites = rng.integers(0, 2, (BATCHER_ROWS, 64, 64), np.uint8)
    idx = rng.permutation(BATCHER_ROWS)[:128]
    mask = rng.random(128) < 0.5
    gains = rng.uniform(0.2, 1.0, (128, 3)).astype(np.float32)
    cases = [
        ("celeba_flip", native.gather_normalize_flip, native.gather_normalize_flip_plain,
         (faces, idx, mask, 1.0 / 127.5, -1.0)),
        ("rp_gray", native.gather_normalize, native.gather_normalize_plain,
         (sprites, idx, 1.0, 0.0)),
        ("colorize", native.gather_colorize, native.gather_colorize_plain,
         (sprites, idx, gains, 1.0, 0.0)),
    ]
    for name, fast, plain, args in cases:
        want = plain(*args)
        for threads in (1, 8):
            got = fast(*args, n_threads=threads)
            check(got.shape == want.shape and np.array_equal(got, want),
                  f"batcher {name} at {threads} threads differs from its plain version")
        emit({"batcher": name, "shape": list(want.shape), "bit_equal": True,
              "ms_by_threads": {n: _median_ms(lambda n=n: fast(*args, n_threads=n))
                                for n in (1, 2, 4, 8)},
              "numpy_ms": _median_ms(lambda: plain(*args)), "host_cpus": os.cpu_count()})

    faces_args = cases[0][3]
    stager = PinnedStager("cuda")
    shape = (128, 64, 64, 3)

    def old():
        torch.from_numpy(native.gather_normalize_flip_plain(*faces_args)).to("cuda")
        torch.cuda.synchronize()

    def enqueue():
        return stager.stage([(shape, np.float32,
                              lambda out: native.gather_normalize_flip(*faces_args, out=out))])

    def new():
        (x,) = enqueue().get()
        torch.cuda.synchronize()
        return x

    check(torch.equal(new().cpu(), torch.from_numpy(cases[0][2](*faces_args))),
          "the staged batch differs from the plain gather")
    # in turns, old, new, new, old: the host's neighbours move both alike
    times = {"old": [], "new": []}
    for way, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        times[way].append(_median_ms(fn))
    emit({"batch_onto_card": "celeba (128, 64, 64, 3), flips", "old_ms_host_clock": times["old"],
          "new_ms_host_clock": times["new"], "new_enqueue_ms_host_clock": _median_ms(enqueue)})
    torch.cuda.synchronize()


def feed_chain_checks(torch):
    """(b) ``tools/chain_check.py`` for CelebA (flips, f32) and gray rp (the
    warp) at batch 128, 8 steps: per-step runs A and B on the prefetcher,
    chained C resident and D on raw windows, all bit-equal."""
    from eadgan_tpu_torch.tools.chain_check import run_check

    for pipeline in ("celeba", "rp"):
        report = run_check(pipeline, steps=8, chain=4, batch=128)
        emit(report)
        check(report["ok"] and report["err_raw"] == 0,
              f"chain_check {pipeline} with raw windows: {report}")


def feed_per_step(torch, tmp):
    """(c) The per-step engine on the prefetcher through the CLIs, batch
    128: ``cli.celeba --chain 1 --compute bf16`` for 40 steps (640 faces),
    then ``cli.pxy`` (4 chained steps, for its aligner file) and ``cli.rp
    --chain 1 --compute f32`` for 20 steps on it: loop step ms (host clock
    between log records) and the main thread's median wait for a batch
    (the ``EADGAN_TRACE`` file's ``engine.feed`` spans), from step 2 on; the warp's
    launches held exactly.  Returns the launches by path."""
    from eadgan_tpu_torch.ops import stn_cuda

    launches = {}

    def run(label, module, argv, keys, steps, warps, **env):
        jsonl = os.path.join(tmp, f"{label}.jsonl")
        trace = os.path.join(tmp, f"{label}_trace.json")
        stn_cuda.reset_launch_count()  # counts from here read this run only
        t0 = time.perf_counter()
        with environ(EADGAN_PLATFORM="cuda", EADGAN_TRACE=trace, **env):
            run_module(torch, module, ["--batch_size", "128", "--data_dir", tmp, "--ckpt_dir", tmp,
                                       "--out_dir", os.path.join(tmp, label), "--jsonl", jsonl,
                                       *argv])
        wall = time.perf_counter() - t0
        records = read_records(jsonl, keys)
        check([r["step"] for r in records] == list(range(steps)), f"{label} steps")
        check(stn_cuda.launch_count == warps,
              f"{label}: warp launched {stn_cuda.launch_count} times, expected {warps}")
        launches[label] = stn_cuda.launch_count
        recorded = read_trace(trace)
        check(recorded["counters"].get("engine.steps") == steps,
              f"{label}: counters {recorded['counters']}")
        waits = [span_s(f) for f in trace_spans(recorded, "engine.feed") if f.get("s", -1) >= 2]
        emit({"per_step_run": label, "module": module, "steps": steps, "wall_s": wall,
              "loop_step_ms_host_clock": loop_ms(records),
              "batch_wait_ms_median": statistics.median(waits) * 1e3,
              "batch_wait_ms_max": max(waits) * 1e3, "warp_launches": stn_cuda.launch_count,
              "last": records[-1]})

    run("celeba_per_step", "eadgan_tpu_torch.cli.celeba",
        ["--chain", "1", "--compute", "bf16", "--max_steps", str(FEED_STEPS), "--n_epochs", "8",
         "--sample_interval", "1000", "--keep_states", "1"],
        ("d_loss", "g_loss"), FEED_STEPS, FEED_STEPS + 1, EADGAN_SYNTH_N=str(FEED_FACES))
    with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS="3"):
        run_module(torch, "eadgan_tpu_torch.cli.pxy",
                   ["--batch_size", "128", "--max_steps", "4", "--sample_interval", "4",
                    "--data_dir", tmp, "--ckpt_dir", tmp, "--out_dir", os.path.join(tmp, "pxy")])
    pxy_file = os.path.join(tmp, "encoder_pxy_0.pt")
    check(os.path.isfile(pxy_file), "encoder_pxy_0.pt")
    run("rp_per_step", "eadgan_tpu_torch.cli.rp",
        ["--encoder_pxy", pxy_file, "--chain", "1", "--compute", "f32", "--n_epochs", "5",
         "--max_steps", str(RP_STEPS), "--sample_interval", str(RP_STEPS), "--keep_states", "1"],
        RP_KEYS, RP_STEPS, 3 * RP_STEPS + RP_GRID_WARPS, EADGAN_SYNTH_POS="3")
    check(os.path.isfile(os.path.join(tmp, "encoder_0.pt")), "encoder_0.pt")
    return launches, pxy_file


def feed_raw_windows(torch, tmp):
    """(d) ``cli.celeba --compute bf16`` at its default ``--chain 32`` for 64
    steps on 8,192 faces, resident, then with ``EADGAN_DEVICE_DATA_MAX=0``
    (raw windows gathered on the prefetch thread): the loop step ms from
    the ``EADGAN_TRACE`` file and its split, the largest relative difference
    of their losses (cuDNN is left to its defaults here, as in a user's
    run: (b) holds the paths bit for bit), the warp once a step plus the
    step-0 grid's."""
    import numpy as np

    from eadgan_tpu_torch.ops import stn_cuda

    out, launches, losses = {}, {}, {}
    for label, limit in (("celeba_resident", None), ("celeba_rawwin", "0")):
        jsonl = os.path.join(tmp, f"{label}.jsonl")
        trace = os.path.join(tmp, f"{label}_trace.json")
        env = {"EADGAN_PLATFORM": "cuda", "EADGAN_SYNTH_N": str(RAWWIN_FACES),
               "EADGAN_TRACE": trace}
        if limit is not None:
            env["EADGAN_DEVICE_DATA_MAX"] = limit
        stn_cuda.reset_launch_count()  # counts from here read this run only
        t0 = time.perf_counter()
        with environ(**env):
            run_module(torch, "eadgan_tpu_torch.cli.celeba",
                       ["--batch_size", "128", "--compute", "bf16", "--max_steps", str(RAWWIN_STEPS),
                        "--sample_interval", "1000", "--keep_states", "1", "--data_dir", tmp,
                        "--ckpt_dir", os.path.join(tmp, label),
                        "--out_dir", os.path.join(tmp, label, "images"), "--jsonl", jsonl])
        wall = time.perf_counter() - t0
        records = read_records(jsonl)
        check([r["step"] for r in records] == list(range(RAWWIN_STEPS)), f"{label} steps")
        check(stn_cuda.launch_count == RAWWIN_STEPS + 1,
              f"{label}: warp launched {stn_cuda.launch_count} times, expected {RAWWIN_STEPS + 1}")
        launches[label] = stn_cuda.launch_count
        losses[label] = [(r["d_loss"], r["g_loss"]) for r in records]
        out[label] = {"wall_s": wall, **chained_loop_ms(trace, CELEBA_ADAMS), "last": records[-1]}
    a, b = (np.array(losses[k]) for k in ("celeba_rawwin", "celeba_resident"))
    emit({"raw_windows": "cli.celeba bf16 --chain 32, 64 steps", "runs": out,
          "loss_max_rel_diff": float(np.max(np.abs(a - b) / np.abs(b))),
          "rawwin_over_resident": out["celeba_rawwin"]["loop_step_ms_host_clock"]
          / out["celeba_resident"]["loop_step_ms_host_clock"]})
    return {"celeba_rawwin": launches["celeba_rawwin"]}


def feed_dci(torch, tmp, pxy_file):
    """(e) ``cli.score --metric DCI`` with ``--dci_regressor LassoCV``, then
    ``RandomForest``, on the per-step rp run's aligner and encoder, on
    61,440 synthetic sprites, without scikit-learn: wall seconds and the
    scores (printed, not gated, as phase 4's)."""
    for regressor in ("LassoCV", "RandomForest"):
        out_json = os.path.join(tmp, f"dci_{regressor}.json")
        t0 = time.perf_counter()
        with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS=str(SCORE_SYNTH_POS)), \
                contextlib.redirect_stdout(io.StringIO()):
            run_module(torch, "eadgan_tpu_torch.cli.score",
                       ["--metric", "DCI", "--dci_regressor", regressor, "--encoder_pxy", pxy_file,
                        "--encoder", os.path.join(tmp, "encoder_0.pt"), "--data_dir", tmp,
                        "--json_out", out_json])
        wall = time.perf_counter() - t0
        with open(out_json) as f:
            scores = json.load(f)
        keys = {f"DCI_{regressor}_disent_metric", f"DCI_{regressor}_complete_metric"}
        # random weights after 20 steps: the scores are printed, not gated (a
        # code no regressor uses makes DCI's entropy NaN, in the JAX package too)
        check(set(scores) == keys and not any(math.isinf(v) for v in scores.values()),
              f"DCI {regressor}: {scores}")
        check("sklearn" not in sys.modules, f"DCI {regressor} imported scikit-learn")
        emit({"dci_cli": regressor, "wall_s": wall, "scores": scores})


def phase_host_feed(torch):
    """(a)-(e); returns the warp's launches on the new paths."""
    t0 = time.perf_counter()
    feed_batcher(torch)
    feed_chain_checks(torch)
    with tempfile.TemporaryDirectory(prefix="eadgan_feed_") as tmp:
        launches, pxy_file = feed_per_step(torch, tmp)
        launches.update(feed_raw_windows(torch, tmp))
        feed_dci(torch, tmp, pxy_file)
    emit({"host_feed_phase_s": time.perf_counter() - t0})
    return launches


JAX_FILES_FACES = 4096  # phase 10's CelebA stand-in: 32 batches an epoch at batch 128
JAX_FILES_STEPS, JAX_FILES_INTERVAL = 64, 4  # the first CelebA run: states saved at steps 0 and 60
JAX_FILES_SAVED = 60  # the newest state --keep_states 1 keeps (its step counter: 61)
JAX_FILES_RESUMED = 32  # steps of each resumed run
JAX_FILES_RP_POS = 8  # gray rp on 3,840 sprites, 30 batches an epoch
JAX_FILES_BUDGET_S = 120.0


def state_tensors(torch, state) -> dict:
    """Every tensor a train state holds, by name: each model's parameters
    and buffers (``u``/``sigma``, BatchNorm statistics), each optimizer's
    moments and step count per parameter, and the step."""
    import dataclasses

    out = {"step": torch.tensor(int(state.step))}
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, torch.nn.Module):
            out.update({f"{f.name}.{k}": v for k, v in value.state_dict().items()})
        elif isinstance(value, torch.optim.Optimizer):
            params = [p for g in value.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                for k, v in value.state.get(p, {}).items():
                    out[f"{f.name}[{i}].{k}"] = v
    return out


def compare_states(torch, written, restored) -> dict:
    """The two states' tensors, bit for bit; BatchNorm's
    ``num_batches_tracked`` is not in the JAX format (nothing reads it)."""
    a, b = state_tensors(torch, written), state_tensors(torch, restored)
    skipped = sorted(k for k in a if k.endswith("num_batches_tracked"))
    names = [k for k in a if k not in skipped]
    mismatched = [k for k in names if k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape or not torch.equal(a[k], b[k].to(a[k].device))]
    extra = sorted(set(b) - set(a))
    check(not mismatched and not extra, f"restored from the JAX format: mismatched "
          f"{mismatched[:8]} of {len(names)}, extra {extra[:8]}")
    return {"tensors_compared": len(names), "mismatched": mismatched,
            "not_in_the_format": len(skipped)}


def jax_files_celeba(torch, tmp):
    """(a), (b) and (d) on CelebA bf16 at batch 128; returns the warp's
    launches of the resumed run and the int8 kernels' of ``gen_imgs
    --quant int8`` on the JAX-format ``checkpoint_%d.tar``."""
    from eadgan_tpu_torch.interop import flax_msgpack, jax_state
    from eadgan_tpu_torch.ops import quant_cuda, stn_cuda
    from eadgan_tpu_torch.train import checkpoint as ck
    from eadgan_tpu_torch.train.config import CelebaConfig
    from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state

    module, stem, saved = "eadgan_tpu_torch.cli.celeba", "celeba_train_state", JAX_FILES_SAVED
    run1, run2, jdir = (os.path.join(tmp, d) for d in ("celeba", "celeba_resumed", "celeba_jax"))

    def fresh():  # as cli.celeba builds it before --resume
        return init_celeba_gan_state(CelebaConfig(batch_size=128), device="cuda", seed=0,
                                     dtype=torch.bfloat16)

    with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_N=str(JAX_FILES_FACES)):
        common = ["--batch_size", "128", "--compute", "bf16", "--data_dir", tmp]
        t0 = time.perf_counter()
        run_module(torch, module, common + [
            "--max_steps", str(JAX_FILES_STEPS), "--sample_interval", str(JAX_FILES_INTERVAL),
            "--keep_states", "1", "--out_dir", os.path.join(run1, "images"), "--ckpt_dir", run1,
            "--jsonl", os.path.join(run1, "m.jsonl")])
        train_s = time.perf_counter() - t0
        check(ck.saved_steps(run1, stem) == [saved], f"kept states {ck.saved_steps(run1, stem)}")
        written = ck.restore_train_state(os.path.join(run1, f"{stem}_{saved}.ckpt"), fresh())
        check(written.step == saved + 1, f"the kept state's step {written.step}")

        # (a) the JAX format, restored as --resume restores it
        t0 = time.perf_counter()
        path = ck.save_jax_train_state(jdir, stem, saved, written)
        save_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            check(flax_msgpack.is_flax_msgpack(f.read(4)), "save_jax_train_state wrote no msgpack map")
        restored = ck.restore_train_state(path, fresh())
        compared = compare_states(torch, written, restored)
        key = jax_state.key_from_generator(written.rng)

        # (d) the pieces, on a second copy
        timing_file, state2 = os.path.join(jdir, "timing.ckpt"), fresh()
        torch.cuda.synchronize()
        ts = [time.perf_counter()]
        tree = ck.jax_train_state(written)  # encode: off the card, into flax's layout
        ts.append(time.perf_counter())
        n_bytes = ck.write_jax_tree(timing_file, tree)  # write: pack, fsync, rename
        ts.append(time.perf_counter())
        del tree
        with open(timing_file, "rb") as f:  # read
            data = f.read()
        ts.append(time.perf_counter())
        payload = jax_state.state_from_jax(flax_msgpack.unpackb(data), state2)  # decode
        ts.append(time.perf_counter())
        del data, payload
        ck.restore_train_state(timing_file, state2)  # what --resume does: all of it, onto the card
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        os.unlink(timing_file)
        timing = {"bytes": n_bytes, **{f"{name}_s": b - a for name, a, b in zip(
            ("encode", "write", "read", "decode", "restore_onto_card"), ts[:-1], ts[1:])}}
        check(n_bytes == os.path.getsize(path), f"{n_bytes} bytes against the file's")

        stn_cuda.reset_launch_count()  # counts from here read the resumed run only
        t0 = time.perf_counter()
        run_module(torch, module, common + [
            "--resume", path, "--max_steps", str(JAX_FILES_RESUMED), "--sample_interval", "1000",
            "--out_dir", os.path.join(run2, "images"), "--ckpt_dir", run2,
            "--jsonl", os.path.join(run2, "m.jsonl")])
        resume_s = time.perf_counter() - t0
        warps = stn_cuda.launch_count
        records = read_records(os.path.join(run2, "m.jsonl"))
        steps = [r["step"] for r in records]
        check(steps == list(range(saved + 1, saved + 1 + JAX_FILES_RESUMED)),
              f"resumed from the JAX file at {steps[:1]}..{steps[-1:]}")
        check(warps == JAX_FILES_RESUMED, f"warp launches {warps} in {JAX_FILES_RESUMED} steps")

        emit({"jax_files_celeba": {
            "state": f"{stem}_{saved}.ckpt", "compute": "bf16", "batch_size": 128,
            "first_run_steps": JAX_FILES_STEPS, "first_run_s": train_s, **compared,
            "key_written": [int(k) for k in key], "save_jax_train_state_s": save_s,
            "resumed_steps": [steps[0], steps[-1]], "resumed_run_s": resume_s,
            "resumed_warp_launches": warps, "last": records[-1]}})
        emit({"jax_files_timing": timing})

        # (b) that state's models in a JAX-format checkpoint_%d.tar against
        # the run's own checkpoint_60.tar of the same weights: the same
        # tensors read from both, and the same grids under deterministic
        # cuDNN (its transposed convs may otherwise pick atomics)
        tars = {"jax": os.path.join(jdir, f"checkpoint_{saved}.tar"),
                "port": os.path.join(run1, f"checkpoint_{saved}.tar")}
        ck.save_jax_model(tars["jax"], {"discriminator_state_dict": written.d,
                                        "generator_state_dict": written.g,
                                        "epoch": saved // (JAX_FILES_FACES // 128),
                                        "batches_done": saved})
        read = {kind: ck.load_celeba_checkpoint(tar) for kind, tar in tars.items()}
        n_tensors = 0
        for part in ("generator_state_dict", "discriminator_state_dict"):
            a, b = read["jax"][part], read["port"][part]
            names = [k for k in b if not k.endswith("num_batches_tracked")]
            n_tensors += len(names)
            check(all(torch.equal(a[k], b[k]) for k in names), f"{part}: the two tars differ")
        grids, int8 = {}, {}
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for quant in ("none", "int8"):
                for kind, tar in tars.items():
                    out = os.path.join(tmp, f"gen_{quant}_{kind}")
                    quant_cuda.reset_launch_count()  # counts from here read this run only
                    run_module(torch, "eadgan_tpu_torch.cli.gen_imgs",
                               ["--checkpoint", tar, "--out_dir", out, "--quant", quant])
                    if quant == "int8" and kind == "jax":
                        int8 = dict(quant_cuda.launch_count)
                    grids[quant, kind] = [open(os.path.join(out, f"varying_c{k}", "0.png"), "rb").read()
                                          for k in range(1, 9)]
                check(grids[quant, "jax"] == grids[quant, "port"],
                      f"gen_imgs --quant {quant}: the JAX-format tar's grids differ from the port's")
        finally:
            torch.backends.cudnn.deterministic = deterministic
        check(int8 == {"int8_convt": 24, "quantize_int8": 32}, f"int8 launches {int8}")
    emit({"jax_files_tar": {"tensors_equal": n_tensors, "gen_imgs_bit_equal": ["none", "int8"],
                            "grids": 8, "int8_launches_jax_tar": int8}})
    return warps, int8


def jax_files_rp(torch, tmp):
    """(c): a gray rp state (``opt_g`` None, ``opt_info`` over G and E)
    through the same round trip, resumed by ``cli.rp``; returns the warp's
    launches of the resumed run (3 a step)."""
    from eadgan_tpu_torch.ops import stn_cuda
    from eadgan_tpu_torch.train import checkpoint as ck
    from eadgan_tpu_torch.train.config import SpritesGanConfig
    from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state
    from eadgan_tpu_torch.train.pretrain import pxy_encoder

    module, stem = "eadgan_tpu_torch.cli.rp", "rp_train_state"
    run1, run2, jdir = (os.path.join(tmp, d) for d in ("rp", "rp_resumed", "rp_jax"))

    def fresh():  # as cli.rp builds it before --resume
        return init_sprites_gan_state(SpritesGanConfig.for_dataset(False, batch_size=128),
                                      pxy_encoder(False, seed=1), device="cuda", seed=0)

    with environ(EADGAN_PLATFORM="cuda", EADGAN_SYNTH_POS=str(JAX_FILES_RP_POS)):
        common = ["--batch_size", "128", "--compute", "f32", "--allow_fresh_pxy", "--data_dir", tmp,
                  "--sample_interval", "1000"]
        run_module(torch, module, common + ["--max_steps", "8", "--out_dir", os.path.join(run1, "img"),
                                            "--ckpt_dir", run1, "--jsonl", os.path.join(run1, "m.jsonl")])
        check(ck.saved_steps(run1, stem) == [0], f"rp states {ck.saved_steps(run1, stem)}")
        written = ck.restore_train_state(os.path.join(run1, f"{stem}_0.ckpt"), fresh())
        path = ck.save_jax_train_state(jdir, stem, 0, written)
        tree = ck.read_file(path)[1]
        check(tree["opt_g"] is None and sorted(tree["opt_info"]["0"]["mu"]) == ["e", "g"],
              "the rp state's optimizers in the JAX layout")
        del tree
        compared = compare_states(torch, written, ck.restore_train_state(path, fresh()))
        stn_cuda.reset_launch_count()  # counts from here read the resumed run only
        run_module(torch, module, common + [
            "--resume", path, "--max_steps", str(JAX_FILES_RESUMED),
            "--out_dir", os.path.join(run2, "img"), "--ckpt_dir", run2,
            "--jsonl", os.path.join(run2, "m.jsonl")])
        warps = stn_cuda.launch_count
        records = read_records(os.path.join(run2, "m.jsonl"), RP_KEYS)
        steps = [r["step"] for r in records]
        check(steps == list(range(1, 1 + JAX_FILES_RESUMED)), f"rp resumed at {steps[:1]}..{steps[-1:]}")
        check(warps == 3 * JAX_FILES_RESUMED, f"rp warp launches {warps} in {JAX_FILES_RESUMED} steps")
    emit({"jax_files_rp": {"state": f"{stem}_0.ckpt", "bytes": os.path.getsize(path), **compared,
                           "resumed_steps": [steps[0], steps[-1]], "resumed_warp_launches": warps,
                           "last": records[-1]}})
    return warps


def phase_jax_files(torch):
    """(a)-(e) in a temporary directory it removes; returns the warp's
    launches by path and the int8 kernels' on the JAX-format tar."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="eadgan_jax_files_") as tmp:
        celeba_warps, int8 = jax_files_celeba(torch, tmp)
        rp_warps = jax_files_rp(torch, tmp)
    phase_s = time.perf_counter() - t0
    emit({"jax_files_phase_s": phase_s})
    check(phase_s < JAX_FILES_BUDGET_S, f"phase 10 took {phase_s:.1f} s (budget {JAX_FILES_BUDGET_S} s)")
    return {"celeba_jax": celeba_warps, "rp_jax": rp_warps}, int8


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    print("== phase 1: environment and kernel build", flush=True)
    phase_environment(torch)
    print("== phase 2: kernels vs plain versions on the card", flush=True)
    errs = phase_kernel_vs_plain(torch)
    print("== phase 3: train steps, CPU vs CUDA (CelebA; dSprites pxy and rp; MNIST and its "
          "approximator), chained vs per step, folded bf16 and int8 generators vs eval, the "
          "scorer's Representer CPU vs CUDA", flush=True)
    phase_step_parity(torch)
    phase_step_parity_dsprites(torch)
    phase_step_parity_mnist(torch)
    phase_chain_parity(torch)
    phase_infer_parity(torch)
    phase_representer_parity(torch)
    print("== phase 4: main paths (the CelebA trainer and gen_imgs none|bf16|int8, its save "
          "window inline vs the event worker, the dSprites trainers and the scorer, the MNIST "
          "pipeline and generate_image, then the fused conv's probe)", flush=True)
    celeba = phase_trainer(torch)
    phase_save_window(torch)
    warp_by_path = {"celeba": celeba["warp_affine"], **phase_dsprites_trainers(torch),
                    "mnist": phase_mnist_trainers(torch)}
    probe_launches, probe = phase_probe(torch)
    print("== phase 5: timing", flush=True)
    int8_launches = {k: celeba[k] for k in ("int8_convt", "quantize_int8")}
    kernels = phase_timing(torch, errs, probe, int8_launches)
    print("== phase 6: robustness (a graceful stop against a run to the same step, the CelebA "
          "trainer under SIGTERM and --resume auto, a supervised watchdog stall and restart, "
          "the cost of the guard and the watchdog)", flush=True)
    warp_by_path["celeba_stop"] = phase_robustness(torch)
    print("== phase 7: data-parallel training (CelebA bf16 in a NCCL group of one, plain vs "
          "data-parallel vs ZeRO-1, bit for bit and timed; the shared-card refusals; two gray rp "
          "ranks sharing the card over gloo against one rank, and their gang stop)", flush=True)
    warp_by_path.update(phase_data_parallel(torch))
    print("== phase 8: the model axis (CelebA bf16 on a (1, 1) NCCL grid vs no grid, bit for bit; "
          "two gloo ranks sharing the card as (1, 2) and four as (2, 2) with ZeRO-1 against one "
          "rank, the (2, 2) save resumed as (1, 2))", flush=True)
    warp_by_path.update(phase_model_axis(torch))
    print("== phase 9: the host-fed data path (the native batcher on the card's host, the chained "
          "engine's raw windows against the per-step engine on its prefetcher, the per-step CLIs, "
          "EADGAN_DEVICE_DATA_MAX=0 against the resident dataset) and DCI's LassoCV and "
          "RandomForest without scikit-learn)", flush=True)
    warp_by_path.update(phase_host_feed(torch))
    print("== phase 10: the JAX package's files (a CelebA bf16 train state and a gray rp one "
          "written in its format, restored bit for bit and resumed by the CLIs; gen_imgs none|int8 "
          "on a JAX-format checkpoint_%d.tar against its port-format twin)", flush=True)
    jax_warps, jax_int8 = phase_jax_files(torch)
    warp_by_path.update(jax_warps)
    # the warp's paths by the Pallas body the TPU took there: _kernel for
    # C * W > 128 (CelebA, colored dSprites), _kernel_pair otherwise
    paths = {"warp_affine": ("celeba", "pxy_color", "rp_color", "score_color", "celeba_stop",
                             "celeba_dp", "celeba_tp", "celeba_tp_zero", "celeba_per_step",
                             "celeba_rawwin", "celeba_jax"),
             "warp_affine_pair": ("pxy", "rp", "rp_resumed_bf16", "rp_long", "mnist", "score_gray",
                                  "rp_gang", "rp_per_step", "rp_jax")}
    check(sorted(p for v in paths.values() for p in v) == sorted(warp_by_path),
          f"warp paths {sorted(warp_by_path)}")
    for k in kernels:
        if k["name"] in paths:
            by_path = {p: warp_by_path[p] for p in paths[k["name"]]}
            k["launches"] = sum(by_path.values())
            k["launches_by_path"] = by_path
        elif k["name"] in probe_launches:
            k.update(launches=probe_launches[k["name"]])
        elif k["name"] == "adam_fused":  # the CelebA trainer's chained f32 run, 3 a step
            k["launches"] = celeba["adam_fused"]
        elif k["name"] == "spectral_norm":  # the same run, the census's launches a step
            k["launches"] = celeba["spectral_norm"]
        elif k["name"] in jax_int8:  # gen_imgs --quant int8 on the port's tar, then the JAX one
            k["launches_by_path"] = {"gen_imgs": k["launches"], "gen_imgs_jax": jax_int8[k["name"]]}
            k["launches"] = sum(k["launches_by_path"].values())
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
        if k["name"] == "warp_affine_pair":
            # from the gray rp and MNIST CLIs' runs, each counted from 0 just before it
            k["launches_per_rp_step"] = (warp_by_path["rp"] - RP_GRID_WARPS) / RP_STEPS
            k["launches_per_mnist_step"] = (warp_by_path["mnist"] - MNIST_GRID_WARPS) / MNIST_STEPS
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s", flush=True)
    emit({"kernels": kernels})
    print(nvidia_smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
