"""The spectral norm on the card: its kernels against the plain version
and their bound, in a step and alone, and the size at which one block
stops paying.

``python -m eadgan_tpu_torch.tools.sn_bench [--out f.json]`` (needs a
CUDA card; prints one JSON line and writes it to ``--out``), for a
CelebA step at batch 16 and a gray rp step at batch 128, bf16 as the
benchmark's cells run them:

- ``census``: the layers' calls a step (:func:`census`), shape, compute
  type and forwards and backwards each;
- ``timing`` (:func:`time_step_calls`): a step's spectral-norm calls
  captured in a CUDA graph and replayed, the kernels' forwards and
  backwards apart, against the bound of the bytes that must move (6 an
  element forward, W read and Wn written in bf16; 10 backward, G and W
  read, dW written) and the plain version's forwards and backwards;
- ``in_step`` (:func:`in_step`): the same kernels inside the chained
  engine's replayed step, profiled, against the step's kernel time;
- ``threshold`` (:func:`sweep_one_block`): forward plus backward of one
  layer at 512 to 262,144 elements, by one block and by the large path,
  so ``ops/sn_cuda.py::ONE_BLOCK_MAX`` can be set where one block stops
  being faster.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import statistics

import torch

__all__ = ["census", "launches_per_step", "kernel_vs_plain", "time_step_calls", "in_step",
           "sweep_one_block", "main"]

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet)
CELLS = (("celeba", 16), ("rp", 128))  # the pipelines and batches of the cells
SWEEP = ((32, 16), (32, 48), (32, 128), (64, 128), (32, 512), (64, 512), (64, 1024), (128, 1024),
         (256, 1024))


def _pipeline_step(pipeline: str, batch: int, device):
    from eadgan_tpu_torch.utils.profiler import build_step, step_args

    state, step, data, prep = build_step(pipeline, batch, torch.bfloat16, device=device)
    return state, step, step_args(data, prep, batch, device)


def census(pipeline: str, batch: int, device="cpu") -> list:
    """The spectral-norm layers' calls in one step of ``pipeline`` (bf16
    compute), in the order the step first calls them: ``shape``,
    ``dtype`` (the layer's compute type), ``forward`` (the normalized
    weights made) and ``backward`` (those a gradient reached)."""
    from eadgan_tpu_torch.models.layers import _SpectralNorm

    state, step, args = _pipeline_step(pipeline, batch, device)
    layers = [m for model in vars(state).values() if isinstance(model, torch.nn.Module)
              for m in model.modules() if isinstance(m, _SpectralNorm)]
    calls = {}

    def counted(layer):
        normalized = layer.normalized_weight

        def call():
            dt = layer.compute_dtype
            record = calls.setdefault(id(layer), {"shape": list(layer.weight.shape),
                                                  "dtype": "bf16" if dt == torch.bfloat16 else "f32",
                                                  "forward": 0, "backward": 0})
            record["forward"] += 1
            w = normalized()
            if w.requires_grad:
                w.register_hook(lambda grad: record.update(backward=record["backward"] + 1))
            return w

        return call

    for layer in layers:
        layer.normalized_weight = counted(layer)  # on the instance, for this step only
    try:
        step(state, *args)
    finally:
        for layer in layers:
            del layer.normalized_weight
    return list(calls.values())


def launches_per_step(layers: list) -> int:
    """The spectral norm's kernel launches in a step whose calls are
    ``layers`` (:func:`census`)."""
    from eadgan_tpu_torch.ops.sn_cuda import launches_per_call

    total = 0
    for layer in layers:
        forward, backward = launches_per_call(torch.Size(layer["shape"]).numel())
        total += layer["forward"] * forward + layer["backward"] * backward
    return total


def _graph_ms(fn, replays: int = 20, repeats: int = 5) -> float:
    """ms of one ``fn()`` captured in a CUDA graph, by CUDA events over
    ``replays`` back-to-back replays (median of ``repeats``)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()  # eager first: libraries' handles and workspaces before capture
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / replays)
    return statistics.median(samples)


def _kernel_breakdown(fn, replays: int = 5) -> dict:
    """µs a call of ``fn`` (captured in a CUDA graph, replayed
    ``replays`` times under ``torch.profiler``) by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()
    by_name = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation",
                                                                           False):
            name = re.search(r"sn_\w+(<[^>]*>)?", e.name)
            by_name[name.group(0) if name else e.name[:60]] += e.time_range.elapsed_us() / replays
    return dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


def _layer_tensors(shape, dtype, gen, device="cuda"):
    """A weight drawn as torch's default init draws it (uniform within
    1/sqrt(fan_in)), a unit ``u``, sigma 1 and a normal gradient in
    ``dtype``."""
    from eadgan_tpu_torch.ops.sn_cuda import l2n

    fan_in = torch.Size(shape[1:]).numel()
    w = ((torch.rand(shape, generator=gen, device=device) * 2 - 1) / fan_in**0.5).requires_grad_()
    u = l2n(torch.randn(shape[0], generator=gen, device=device))
    sigma = torch.ones((), device=device)
    g = (torch.randn(shape, generator=gen, device=device) * 1e-3).to(dtype)
    return w, u, sigma, g


def kernel_vs_plain(shape, dtype, device="cuda", seed: int = 0, zero: bool = False) -> dict:
    """One training-mode call of the kernels on a weight of ``shape``
    (``dtype`` the output type, None for float32) against the plain
    version from the same ``u`` (``zero``: an all-zero weight, sigma 0):
    sigma's and ``u'``'s gaps relative to the plain version's, whether
    the normalized weight holds the bits of ``(W / s).to(dtype)`` for the
    kernels' own sigma, and the weight's gradient for one bf16 or float32
    ``G`` against autograd through the plain version (``grad_gap``,
    relative to its largest element) and against the closed form on the
    kernels' own ``u'``, ``v`` and sigma in float64 (``closed_form_gap``);
    ``grad_equal_g``: the gradient equals ``G`` bit for bit (sigma 0)."""
    from eadgan_tpu_torch.ops import sn_cuda

    gen = torch.Generator(device=device).manual_seed(seed)
    w, u, sigma, g = _layer_tensors(shape, dtype or torch.float32, gen, device)
    if zero:
        w = torch.zeros_like(w).requires_grad_()
    ref_u, ref_sigma = u.clone(), sigma.clone()
    ref = sn_cuda.spectral_norm_plain(w, ref_u, ref_sigma, dtype, True)
    (ref_grad,) = torch.autograd.grad(ref, w, g)
    out, v, u_new, sig = sn_cuda._forward(w.detach(), u, sigma, dtype, True)
    grad = sn_cuda._backward(g, w.detach(), u_new, v, sig)
    s = torch.where(sig[0] != 0, sig[0], torch.ones_like(sig[0]))
    expect = w.detach() / s
    expect = expect if dtype is None else expect.to(dtype)
    closed = sn_cuda.spectral_norm_grad_plain(g.double(), w.detach().double(), u_new.double(),
                                              v.double(), sig[0].double())

    def gap(a, b):
        return ((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-30)).item()

    return {
        "shape": list(shape), "dtype": "bf16" if dtype == torch.bfloat16 else "f32",
        "sigma": float(sig[0]), "sigma_gap": abs(float(sig[0]) - float(ref_sigma))
        / max(abs(float(ref_sigma)), 1e-30),
        "u_gap": (u_new - ref_u).abs().max().item(),
        "state_written": bool(torch.equal(u, u_new) and torch.equal(sigma.view(1), sig)),
        "wn_bit_equal": bool(out.dtype == expect.dtype and torch.equal(out, expect)),
        "grad_gap": gap(grad, ref_grad), "closed_form_gap": gap(grad, closed),
        "grad_equal_g": bool(torch.equal(grad, g.float())),
    }


def _bytes(numel: int, dtype, forwards: int, backwards: int) -> int:
    low = 2 if dtype == torch.bfloat16 else 4
    return numel * (forwards * (4 + low) + backwards * (low + 4 + 4))


def time_step_calls(layers: list) -> dict:
    """A step's spectral-norm calls (``layers`` from :func:`census`) on the
    card, each layer's forwards and backwards in a CUDA graph, replayed:
    the kernels' forwards (``forward_ms``) and backwards (``backward_ms``,
    on the forwards' saved vectors), the plain version's forwards and its
    forwards with backwards (the backward by difference), the bound and
    the kernels' launches a step."""
    from eadgan_tpu_torch.ops import sn_cuda

    gen = torch.Generator(device="cuda").manual_seed(0)
    made = []
    for layer in layers:
        dtype = torch.bfloat16 if layer["dtype"] == "bf16" else None
        made.append((layer, dtype, *_layer_tensors(layer["shape"], dtype or torch.float32, gen)))

    rounds = max(layer["forward"] for layer in layers)  # the layers in turn, as a step calls them

    def kernel_forwards():
        return [sn_cuda._forward(w.detach(), u, s, dt, True) for i in range(rounds)
                for layer, dt, w, u, s, g in made if i < layer["forward"]]

    saved = [sn_cuda._forward(w.detach(), u, s, dt, True)[1:] for layer, dt, w, u, s, g in made]

    def kernel_backwards():
        for i in range(rounds):
            for (layer, dt, w, u, s, g), vectors in zip(made, saved):
                if i < layer["backward"]:
                    sn_cuda._backward(g, w.detach(), *vectors)

    def plain(backward: bool):
        def run():
            for i in range(rounds):
                for layer, dt, w, u, s, g in made:
                    if i < layer["forward"]:
                        out = sn_cuda.spectral_norm_plain(w, u, s, dt, True)
                        if backward and i < layer["backward"]:
                            torch.autograd.grad(out, w, g)
        return run

    before = sn_cuda.launch_count
    kernel_forwards()
    kernel_backwards()
    torch.cuda.synchronize()
    launches = sn_cuda.launch_count - before
    by_kernel = _kernel_breakdown(lambda: (kernel_forwards(), kernel_backwards()))
    per_layer = []
    for (layer, dt, w, u, s, g), vectors in zip(made, saved):
        numel = w.numel()
        forward_us = _graph_ms(lambda: [sn_cuda._forward(w.detach(), u, s, dt, True)
                                        for _ in range(10)]) * 100
        backward_us = _graph_ms(lambda: [sn_cuda._backward(g, w.detach(), *vectors)
                                         for _ in range(10)]) * 100
        per_layer.append({"shape": layer["shape"], "forward_us": forward_us,
                          "backward_us": backward_us,
                          "forward_bound_us": _bytes(numel, g.dtype, 1, 0) / HBM_BYTES_PER_S * 1e6,
                          "backward_bound_us": _bytes(numel, g.dtype, 0, 1) / HBM_BYTES_PER_S * 1e6})
    plain_forward = _graph_ms(plain(False))
    total_bytes = sum(_bytes(torch.Size(l["shape"]).numel(), dt or torch.float32, l["forward"],
                             l["backward"]) for l, dt, *_ in made)
    record = {
        "forward_ms": _graph_ms(kernel_forwards), "backward_ms": _graph_ms(kernel_backwards),
        "plain_forward_ms": plain_forward,
        "plain_backward_ms": _graph_ms(plain(True)) - plain_forward,
        "bound_ms": total_bytes / HBM_BYTES_PER_S * 1e3, "bytes": total_bytes,
        "launches_per_step": launches, "per_layer": per_layer, "by_kernel_us": by_kernel,
        "calls_per_step": [sum(l["forward"] for l in layers), sum(l["backward"] for l in layers)],
    }
    record["ms"] = record["forward_ms"] + record["backward_ms"]
    record["plain_ms"] = record["plain_forward_ms"] + record["plain_backward_ms"]
    record["bound_share"] = record["bound_ms"] / record["ms"]
    return record


def in_step(pipeline: str, batch: int, chain: int = 8) -> dict:
    """The spectral norm's kernels inside the chained engine's replayed
    step (bf16, ``utils/profiler.py::chained_replays``), one window of
    ``chain`` replays under ``torch.profiler``: their ms and launches a
    step, beside the step's kernel time (the union of the kernels'
    intervals) and launches."""
    from torch.profiler import ProfilerActivity, profile

    from eadgan_tpu_torch.utils.profiler import busy_union_us, build_step, chained_replays

    state, step, data, prep = build_step(pipeline, batch, torch.bfloat16)
    run = chained_replays(state, step, data, prep, batch, chain)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    sn = [e for e in kernels if re.search(r"::sn_\w+", e.name)]
    return {
        "pipeline": pipeline, "batch": batch, "steps": chain,
        "sn_ms_per_step": sum(e.time_range.elapsed_us() for e in sn) / 1e3 / chain,
        "sn_launches_per_step": len(sn) / chain,
        "step_busy_ms": busy_union_us([(e.time_range.start, e.time_range.end) for e in kernels])
        / 1e3 / chain,
        "step_launches": len(kernels) / chain,
    }


def sweep_one_block(shapes=SWEEP, calls: int = 20) -> list:
    """Forward plus backward of one bf16 layer of each shape, ``calls``
    times in a CUDA graph, by one block and by the large path: µs a
    call each."""
    from eadgan_tpu_torch.ops import sn_cuda

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = []
    for shape in shapes:
        w, u, s, g = _layer_tensors(shape, torch.bfloat16, gen)
        w = w.detach()
        row = {"shape": list(shape), "numel": w.numel()}
        for key, single in (("one_block_us", True), ("large_path_us", False)):

            def run():
                for _ in range(calls):
                    vectors = sn_cuda._forward(w, u, s, torch.bfloat16, True, single)[1:]
                    sn_cuda._backward(g, w, *vectors, single)

            row[key] = _graph_ms(run) / calls * 1e3
        out.append(row)
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", type=str, default="")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the spectral norm's timing needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = {"device": torch.cuda.get_device_name(0), "timing": {}}
    for pipeline, batch in CELLS:
        layers = census(pipeline, batch, "cuda")
        record["timing"][pipeline] = {"census": layers, **time_step_calls(layers),
                                      "in_step": in_step(pipeline, batch)}
    record["threshold"] = sweep_one_block()
    line = json.dumps(record)
    print(line, flush=True)
    if opt.out:
        os.makedirs(os.path.dirname(opt.out) or ".", exist_ok=True)
        with open(opt.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
