"""CelebA's three Adam steps on the card: the Adam kernel
(``ops/adam_cuda.py``) against its plain version, its bound and torch's
two capturable Adams.

``python -m eadgan_tpu_torch.tools.adam_bench [--steps 5] [--out
f.json]``.  On CelebA's real parameters (``init_celeba_gan_state``, 26.9
M parameters; ``opt_g``, ``opt_d`` and ``opt_info`` update 51.84 M
elements a step), with fresh normal gradients (standard deviation 1e-2)
before every optimizer step, in the train step's order
(:func:`kernel_vs_plain`): each optimizer's state and every parameter
after ``--steps`` steps of the three, the kernel against the plain
version run beside it on the card from the same start and the same
gradients.  Then
(:func:`time_optimizers`) the three ``step()`` calls timed by CUDA
events (``utils/timing.py::device_ms``) beside their bound (28 bytes an
element at 3.35 TB/s), the plain version's time, and torch's
``Adam(fused=True, capturable=True)`` and the foreach
``Adam(capturable=True)`` the train steps ran before the kernel, over
the same tensors; the port calls neither.

Prints one JSON line (and writes it to ``--out``); needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json

import torch

from eadgan_tpu_torch.ops.adam_cuda import BYTES_PER_ELEMENT, adam_plain
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state

__all__ = ["celeba_optimizers", "kernel_vs_plain", "time_optimizers", "bound_ms", "main"]

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM (NVIDIA data sheet)
GRAD_SCALE = 1e-2


def celeba_optimizers(device, seed: int = 0) -> dict:
    """CelebA's optimizers on ``device`` in the train step's order, over
    the parameters of a fresh state (``init_celeba_gan_state``)."""
    state = init_celeba_gan_state(CelebaConfig(), device=device, seed=seed)
    return {"opt_g": state.opt_g, "opt_d": state.opt_d, "opt_info": state.opt_info}


def _params(opt) -> list:
    return list(opt.param_groups[0]["params"])


def bound_ms(opts: dict) -> float:
    """The least time the card could take for one step of ``opts``: their
    elements' bytes at the card's memory rate."""
    elements = sum(p.numel() for opt in opts.values() for p in _params(opt))
    return elements * BYTES_PER_ELEMENT / HBM_BYTES_PER_S * 1e3


class _Plain:
    """The plain version's own moments and step counts for ``opts``'
    parameters, and copies of those parameters, stepped by
    :func:`adam_plain`."""

    def __init__(self, opts: dict, copies=True):
        params = {id(p): p for opt in opts.values() for p in _params(opt)}
        self.params = {k: p.detach().clone() if copies else p for k, p in params.items()}
        self.opts = opts
        self.state = {(name, id(p)): (torch.zeros_like(p), torch.zeros_like(p),
                                      torch.zeros((), device=p.device))
                      for name, opt in opts.items() for p in _params(opt)}

    def step(self, name: str) -> None:
        group = self.opts[name].param_groups[0]
        ps = _params(self.opts[name])
        m, v, s = zip(*(self.state[(name, id(p))] for p in ps))
        adam_plain([self.params[id(p)] for p in ps], [p.grad for p in ps], m, v, s,
                   group["lr"], *group["betas"], group["eps"])


@torch.no_grad()
def kernel_vs_plain(device, steps: int = 5, seed: int = 0) -> dict:
    """The largest differences, kernel against plain version, after
    ``steps`` steps of CelebA's three optimizers: absolute for the
    parameters and step counts, relative to each tensor's largest for
    the moments."""
    opts = celeba_optimizers(device, seed)
    plain = _Plain(opts)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for _ in range(steps):
        for name, opt in opts.items():
            for p in _params(opt):
                p.grad = torch.randn(p.shape, generator=gen, device=device) * GRAD_SCALE
            opt.step()
            plain.step(name)
    errs = {"param": 0.0, "exp_avg": 0.0, "exp_avg_sq": 0.0, "step": 0.0}
    for name, opt in opts.items():
        for p in _params(opt):
            errs["param"] = max(errs["param"], (p - plain.params[id(p)]).abs().max().item())
            st, (m, v, s) = opt.state[p], plain.state[(name, id(p))]
            for key, ref in (("exp_avg", m), ("exp_avg_sq", v)):
                gap = (st[key] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
                errs[key] = max(errs[key], gap)
            errs["step"] = max(errs["step"], abs(float(st["step"]) - float(s)), abs(float(s) - steps))
    return errs


def time_optimizers(cycles_per_ms: float, device="cuda") -> dict:
    """ms of one step of CelebA's three optimizers on the card by CUDA
    events: the kernel (``ms``), its bound, the plain version, torch's
    fused capturable Adam and its foreach capturable Adam (the port's
    step before the kernel), all over the same parameters and gradients."""
    from eadgan_tpu_torch.utils.timing import device_ms

    opts = celeba_optimizers(device)
    gen = torch.Generator(device=device).manual_seed(2)
    for p in {id(p): p for opt in opts.values() for p in _params(opt)}.values():
        p.grad = torch.randn(p.shape, generator=gen, device=device) * GRAD_SCALE

    def torch_adams(**kw):
        return [torch.optim.Adam(_params(opt), lr=opt.param_groups[0]["lr"], betas=(0.5, 0.999),
                                 eps=1e-8, capturable=True, **kw) for opt in opts.values()]

    plain = _Plain(opts, copies=False)
    runs = {"ms": list(opts.values()), "fused_library_ms": torch_adams(fused=True),
            "foreach_library_ms": torch_adams(foreach=True)}
    record = {"bound_ms": bound_ms(opts), "elements": sum(p.numel() for opt in opts.values()
                                                          for p in _params(opt))}
    for key, adams in runs.items():
        record[key] = device_ms(lambda: [opt.step() for opt in adams], 50, cycles_per_ms)
    record["plain_ms"] = device_ms(lambda: [plain.step(name) for name in opts], 10, cycles_per_ms)
    record["bound_share"] = record["bound_ms"] / record["ms"]
    return record


def main(argv=None) -> None:
    from eadgan_tpu_torch.ops import adam_cuda
    from eadgan_tpu_torch.utils.timing import sleep_cycles_per_ms

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", type=str, default="")
    opt = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the Adam kernel needs the card")
    before = adam_cuda.launch_count
    errs = kernel_vs_plain(torch.device("cuda"), opt.steps)
    launches = adam_cuda.launch_count - before
    record = {"device": torch.cuda.get_device_name(0), "steps": opt.steps,
              "kernel_vs_plain": errs, "launches": launches,
              "timing": time_optimizers(sleep_cycles_per_ms())}
    line = json.dumps(record)
    print(line, flush=True)
    if opt.out:
        with open(opt.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
