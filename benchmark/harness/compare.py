"""The comparison that decides ``correct``: the program's first steps
against the reference's, from the same weights, rows, flips and draws.
Four numbers, each the worst case of its kind:

- ``loss_gap``: each logged loss of each step, |program - reference| over
  |reference|;
- ``grad_gap``: each optimizer's first gradient, leaf by leaf (the
  program's worked out from its Adam moments after one step), the gap
  between the two norms over the reference's norm of that leaf or of the
  optimizer's median leaf, whichever is larger;
- ``replay_grad_gap``: the same of each later step's gradients, the steps
  the engine replays from its captured graph as the measured window does
  (the first is its eager step).  The program's gradient of step ``k`` is
  worked out from its first moments after steps ``k - 1`` and ``k``,
  ``(m_k - b1 m_(k-1)) / (1 - b1)``, with the ``b1`` of that step's
  optimizer (``optimizer.b1``: one number, or one for each optimizer).
  The reference follows the program step by step: it takes step ``k``
  from the program's own state after step ``k - 1`` (parameters,
  spectral-norm and BatchNorm buffers, Adam's moments and counts, and
  the reference's Adams built with the same ``b1`` each), since two runs
  in different precisions part after
  Adam's first, sign-like step and their later gradients would differ by
  more than a fault does.  The start, which this skips, is what
  ``grad_gap``, ``loss_gap`` and ``change_gap`` check from the seed;
- ``change_gap``: each parameter's change over the first steps, the gap
  between the two norms over the reference's norm of that leaf or of the
  median leaf, whichever is larger.  Parameters whose reference gradient
  is under a thousandth of their optimizer's median leaf in every
  optimizer that steps them (a bias before a BatchNorm, whose gradient is
  nought to rounding) move under Adam by round-off alone and are left out.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from harness.weights import part

NEGLIGIBLE_GRAD = 1e-3


def _norm(t: torch.Tensor) -> float:
    return float(t.detach().double().norm())


def host_state(models: Dict[str, torch.nn.Module], opts: Dict[str, torch.optim.Optimizer]) -> dict:
    """A copy on the host of a train state: each model's state dict and
    each Adam's per-parameter state (``exp_avg``, ``exp_avg_sq``,
    ``step``), keyed ``"<model>.<parameter>"``."""
    names = {id(t): f"{k}.{n}" for k, m in models.items() for n, t in m.named_parameters()}
    return {
        "models": {k: {n: t.detach().to("cpu", copy=True) for n, t in m.state_dict().items()}
                   for k, m in models.items()},
        "adam": {o: {names[id(t)]: {k: v.detach().to("cpu", copy=True) for k, v in opt.state.get(t, {}).items()}
                     for group in opt.param_groups for t in group["params"]}
                 for o, opt in opts.items()},
    }


def b1_of(b1, opt: str) -> float:
    """The first-moment decay of the optimizer ``opt`` from a
    configuration's ``optimizer.b1``: one number for every Adam, or a map
    from each optimizer's name to its own."""
    if isinstance(b1, dict):
        if opt not in b1:
            raise KeyError(f"optimizer.b1 names no b1 for {opt!r}: {sorted(b1)}")
        return float(b1[opt])
    return float(b1)


def step_grads(states: list, b1) -> list:
    """``[{opt: {param: |g_k|}}]`` of each step ``k`` from the host states
    after each step: ``g_k = (m_k - b1 m_(k-1)) / (1 - b1)``, ``m_(-1) = 0``,
    with each optimizer's own ``b1`` (:func:`b1_of`); a parameter with no
    moment took no gradient."""
    out = []
    for k, st in enumerate(states):
        grads = {}
        for opt, leaves in st["adam"].items():
            grads[opt] = {}
            b1_opt = b1_of(b1, opt)
            for name, s in leaves.items():
                if "exp_avg" not in s:
                    grads[opt][name] = 0.0
                    continue
                g = s["exp_avg"].double()
                if k > 0 and "exp_avg" in states[k - 1]["adam"][opt][name]:
                    g = g - b1_opt * states[k - 1]["adam"][opt][name]["exp_avg"].double()
                grads[opt][name] = _norm(g) / (1.0 - b1_opt)
        out.append(grads)
    return out


def change_norms(params: Dict[str, torch.Tensor], start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {name: _norm(params[name].detach().float() - start[name]) for name in start}


def _reference(ref, cfg: dict, device, quant=None):
    from reference import plain

    plain.no_tf32()
    models = ref.build(cfg, device)
    if quant is not None:
        for model in models.values():
            plain.set_quant(model, quant)
    names = {id(p): f"{k}.{n}" for k, m in models.items() for n, p in m.named_parameters()}
    return models, names


def _optimizers(ref, models, cfg: dict) -> dict:
    """The reference's optimizers, each held to its own ``b1`` of the
    configuration, from which the program's gradients are worked out."""
    opts = ref.optimizers(models, cfg)
    for name, opt in opts.items():
        b1 = b1_of(cfg["optimizer"]["b1"], name)
        for group in opt.param_groups:
            if group["betas"][0] != b1:
                raise ValueError(f"the reference's {name} steps with b1 {group['betas'][0]}, "
                                 f"the configuration states {b1}")
    return opts


def _batch(ref, cfg: dict, rows, mask, device):
    return ref.prepare(torch.as_tensor(rows).to(device),
                       None if mask is None else torch.as_tensor(mask).to(device), cfg["data"])


def reference_first_steps(ref, cfg: dict, weights, batches, rng_seed: int, device, quant=None,
                          keep_states: bool = False) -> dict:
    """The reference's readings over ``batches`` (``[(rows uint8, mask)]``)
    from ``weights``, drawing from a generator seeded ``rng_seed`` as the
    program's step draws.  ``quant`` computes it in a lower precision
    (the control); ``keep_states`` keeps its host state after each step
    (``"states"``), as the program's are kept, to be followed, and the
    steps' gradients worked out from them (``"steps"``)."""
    models, names = _reference(ref, cfg, device, quant)
    for name, model in models.items():
        model.load_state_dict(part(weights, name))
    opts = _optimizers(ref, models, cfg)
    start = {names[id(p)]: p.detach().clone() for m in models.values() for p in m.parameters()}
    gen = torch.Generator(device=device).manual_seed(rng_seed)
    out = {"losses": {}, "grads": {}, "change": {}, "states": []}

    def on_grads(opt_name, opt):
        out["grads"][opt_name] = {names[id(p)]: (_norm(p.grad) if p.grad is not None else 0.0)
                                  for group in opt.param_groups for p in group["params"]}

    for step, (rows, mask) in enumerate(batches):
        real = _batch(ref, cfg, rows, mask, device)
        draws = ref.draw(gen, real.shape[0], cfg, device)
        losses = ref.step(models, opts, real, draws, cfg, on_grads if step == 0 else None)
        out["losses"][step] = {k: float(v) for k, v in losses.items()}
        if keep_states:
            out["states"].append(host_state(models, opts))
    if keep_states:
        out["steps"] = step_grads(out["states"], cfg["optimizer"]["b1"])
    params = {names[id(p)]: p for m in models.values() for p in m.parameters()}
    out["change"] = change_norms(params, start)
    del models, opts
    return out


def followed_grads(ref, cfg: dict, weights, states: list, batches, rng_seed: int, device) -> list:
    """``[{opt: {param: |g_k|}}]`` of the float32 reference's steps ``k =
    1 .. n-1``, each taken from ``states[k - 1]``, the followed run's own
    host state after the step before (models not in a state, such as a
    frozen aligner, from ``weights``)."""
    out = []
    for k in range(1, len(batches)):
        models, names = _reference(ref, cfg, device)
        for name, model in models.items():
            model.load_state_dict(states[k - 1]["models"].get(name, part(weights, name)))
        opts = _optimizers(ref, models, cfg)
        for o, opt in opts.items():
            saved = states[k - 1]["adam"][o]
            for group in opt.param_groups:
                for p in group["params"]:
                    s = saved[names[id(p)]]
                    if s:
                        opt.state[p] = {"step": torch.tensor(float(s["step"])),
                                        "exp_avg": s["exp_avg"].to(device, torch.float32),
                                        "exp_avg_sq": s["exp_avg_sq"].to(device, torch.float32)}
        gen = torch.Generator(device=device).manual_seed(rng_seed)
        for j in range(k):
            ref.draw(gen, batches[j][0].shape[0], cfg, device)
        grads = {}

        def on_grads(opt_name, opt):
            grads[opt_name] = {names[id(p)]: (_norm(p.grad) if p.grad is not None else 0.0)
                               for group in opt.param_groups for p in group["params"]}

        real = _batch(ref, cfg, *batches[k], device)
        ref.step(models, opts, real, ref.draw(gen, real.shape[0], cfg, device), cfg, on_grads)
        out.append(grads)
        del models, opts
    return out


def _leaf_gaps(prog: Dict[str, Dict[str, float]], ref: Dict[str, Dict[str, float]]) -> Dict[str, list]:
    """Each leaf's gap between two ``{opt: {param: norm}}``, over the
    reference's norm of that leaf or of its optimizer's median leaf."""
    out = {}
    for opt, leaves in ref.items():
        median = statistics.median(leaves.values())
        out[opt] = [abs(prog[opt].get(name, 0.0) - r) / max(r, median, 1e-30) for name, r in leaves.items()]
    return out


def _worst(gaps: Dict[str, list]) -> float:
    return max((max(v) for v in gaps.values() if v), default=0.0)


def train_gaps(prog: dict, ref: dict, followed: list) -> Dict[str, float]:
    """The four numbers (module docstring) of ``prog`` (``losses``,
    ``steps``, the :func:`step_grads` of its states, and ``change``)
    against ``ref`` (:func:`reference_first_steps`) and ``followed``
    (:func:`followed_grads` from ``prog``'s states)."""
    grads = prog["steps"]
    loss_gap = 0.0
    for s, losses in prog["losses"].items():
        for k, v in losses.items():
            r = ref["losses"][int(s)][k]
            loss_gap = max(loss_gap, abs(v - r) / max(abs(r), 1e-12))
    counted = counted_leaves(ref["grads"])
    changes = [ref["change"][n] for n in counted]
    median = statistics.median(changes) if changes else 0.0
    change_gap = 0.0
    for name in counted:
        r = ref["change"][name]
        change_gap = max(change_gap, abs(prog["change"][name] - r) / max(r, median, 1e-30))
    replay = max((_worst(_leaf_gaps(g, r)) for g, r in zip(grads[1:], followed)), default=0.0)
    return {"loss_gap": loss_gap, "grad_gap": _worst(_leaf_gaps(grads[0], ref["grads"])),
            "replay_grad_gap": replay, "change_gap": change_gap}


def counted_leaves(ref_grads: Dict[str, Dict[str, float]]) -> list:
    """Parameters whose reference gradient reaches a thousandth of its
    optimizer's median leaf in at least one optimizer that steps them."""
    keep = set()
    for leaves in ref_grads.values():
        median = statistics.median(leaves.values())
        keep |= {n for n, g in leaves.items() if g >= NEGLIGIBLE_GRAD * median}
    return sorted(keep)


def with_limits(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """The numbers the cell compares (those its limits file names), each
    beside its limit."""
    return {k: {"value": values[k], "limit": limit} for k, limit in limits.items()}

