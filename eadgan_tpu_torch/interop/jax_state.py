"""Train states and model files in the JAX package's layout.

The trees ``eadgan_tpu/train/checkpoint.py`` writes (as
``flax.serialization.to_state_dict`` gives them, ``interop/flax_msgpack``
packs them) against the port's objects:

* a model file is ``{"params", "stats"}`` of one model (``ModelVars``),
  carried by ``interop/from_jax.py`` / ``to_jax.py``;
* a train state is the fields of ``GanTrainState`` (``step, rng, g, d,
  opt_g, opt_d, opt_info, e, pxy, approx``) or ``EncoderTrainState``
  (``step, rng, model, opt``) of ``eadgan_tpu/train/state.py`` in that
  order, None for an absent model or optimizer (``opt_g`` of dSprites);
* an optimizer is optax Adam's state ``(ScaleByAdamState(count, mu, nu),
  EmptyState())``, i.e. ``{"0": {"count", "mu", "nu"}, "1": {}}``, with
  ``mu``/``nu`` laid out as the parameters of its model, or as
  ``{"d": ..., "g": ...}`` / ``{"e": ..., "g": ...}`` for an optimizer over
  two models (``opt_info``).  They map to ``torch.optim.Adam``'s
  ``exp_avg`` / ``exp_avg_sq`` (each in its parameter's layout) and
  ``step`` = ``count`` for every parameter, matched by identity to the
  port optimizer's parameter order.

**The key.**  A ``torch.Generator`` cannot hold JAX's threefry key
``(k0, k1)`` (two uint32 words).  Reading, the port seeds its generator
with ``k0 * 2**32 + k1``.  Writing, a generator still at the start of
its seed's stream (its state equals a fresh generator's with that seed)
writes ``(seed >> 32, seed & 0xffffffff)``, so a JAX file read and
written back keeps its key; a generator that has drawn writes two
uint32 words drawn from a copy of it.  So draws after a JAX resume are
not the JAX run's draws (a standing divergence, ROADMAP §3).

A tree that does not fit the state (another trainer's, other widths or
colour channels) raises ``ValueError`` naming the first path that
differs, in file terms (``d/params/SNConv_0/Conv_0/kernel``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from eadgan_tpu_torch.interop.from_jax import from_flax, leaves, model_layers
from eadgan_tpu_torch.interop.to_jax import sorted_tree, to_flax
from eadgan_tpu_torch.train.state import EncoderTrainState, GanTrainState

__all__ = [
    "JAX_FIELDS",
    "model_to_jax",
    "model_from_jax",
    "state_to_jax",
    "state_from_jax",
    "seed_from_key",
    "key_from_generator",
]

JAX_FIELDS = {
    GanTrainState: ("step", "rng", "g", "d", "opt_g", "opt_d", "opt_info", "e", "pxy", "approx"),
    EncoderTrainState: ("step", "rng", "model", "opt"),
}
StateDict = Dict[str, torch.Tensor]


# --- the key ----------------------------------------------------------------


def seed_from_key(key) -> int:
    """The generator seed of the JAX key ``(k0, k1)``: ``k0 * 2**32 + k1``."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"rng: a JAX key is uint32 (2,), got {k.dtype} {k.shape}")
    return (int(k[0]) << 32) | int(k[1])


def key_from_generator(gen: torch.Generator) -> np.ndarray:
    """The JAX key written for ``gen`` (module docstring)."""
    seed = gen.initial_seed()
    fresh = torch.Generator(device=gen.device)
    fresh.manual_seed(seed)
    if torch.equal(gen.get_state(), fresh.get_state()):
        return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)
    copy = torch.Generator(device=gen.device)
    copy.set_state(gen.get_state())
    words = torch.randint(0, 2**32, (2,), generator=copy, device=gen.device, dtype=torch.int64)
    return words.cpu().numpy().astype(np.uint32)


# --- models -----------------------------------------------------------------


def _shown(where: str, path: Tuple[str, ...]) -> str:
    """A flax-variables path as the file names it (``stats`` for
    ``batch_stats``)."""
    parts = ("stats",) + path[1:] if path[0] == "batch_stats" else path
    return where + "/".join(parts)


def _walk(tree, path=()):
    """(path, leaf) of every non-dict value of ``tree``, in its order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    else:
        yield path, tree


def _as_numpy(x, where: str) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # bfloat16, as the codec reads it
        return x.float().numpy()
    if not isinstance(x, np.ndarray):
        raise ValueError(f"{where}: {type(x).__name__} where an array belongs")
    return x


def _checked(layers, variables, shapes: Dict[str, torch.Size], where: str, params_only: bool):
    """``variables`` checked against the leaves of ``layers``: every
    array present, none extra, each of the port shape once mapped."""
    table = {leaf.path: leaf for leaf in leaves(layers) if leaf.param or not params_only}
    seen = set()
    for path, value in _walk(variables):
        leaf = table.get(path)
        if leaf is None:
            raise ValueError(f"{_shown(where, path)}: no such array in the port's model")
        arr = _as_numpy(value, _shown(where, path))
        try:
            shape = leaf.to_port(np.empty(arr.shape, np.float32)).shape
        except (ValueError, IndexError):
            shape = None
        if shape != tuple(shapes[leaf.key]):
            raise ValueError(f"{_shown(where, path)}: shape {arr.shape} does not fit the port's "
                             f"{leaf.key} {tuple(shapes[leaf.key])}")
        seen.add(path)
    for path in table:
        if path not in seen:
            raise ValueError(f"{_shown(where, path)}: missing from the file")


def _shapes(model: nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in model.state_dict().items()}


def model_from_jax(tree, model: nn.Module, where: str = "") -> StateDict:
    """A model tree ``{"params", "stats"}`` as ``model``'s state_dict
    (float32 on the CPU; ``num_batches_tracked`` 0)."""
    if not isinstance(tree, dict) or set(tree) != {"params", "stats"}:
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"{where or '/'}: a model is {{params, stats}}, the file holds {got}")
    variables = {"params": tree["params"], "batch_stats": tree["stats"]}
    layers = model_layers(model)
    _checked(layers, variables, _shapes(model), where, params_only=False)
    return from_flax(layers, variables)


def model_to_jax(model: nn.Module, sd: StateDict = None) -> dict:
    """``model`` (or its state_dict ``sd``) as a model tree
    ``{"params", "stats"}``."""
    variables = to_flax(model_layers(model), model.state_dict() if sd is None else sd)
    return {"params": variables["params"], "stats": variables["batch_stats"]}


# --- optimizers -------------------------------------------------------------


def _models(state) -> Dict[str, nn.Module]:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), nn.Module)}


def _param_index(state, opt) -> List[Tuple[str, str]]:
    """(model field, parameter key) of each parameter of ``opt``, in its
    order (the indices of its ``state_dict``)."""
    names = {id(p): (field, key) for field, m in _models(state).items()
             for key, p in m.named_parameters()}
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError("an optimizer steps a tensor of no model of the state")
            out.append(names[id(p)])
    return out


def _fields_of(index) -> List[str]:
    return sorted({field for field, _ in index})


def _adam_to_jax(state, opt, saved, payload) -> dict:
    index = _param_index(state, opt)
    fields = _fields_of(index)
    mu: Dict[str, StateDict] = {f: {} for f in fields}
    nu: Dict[str, StateDict] = {f: {} for f in fields}
    steps = []
    for i, (field, key) in enumerate(index):
        st = saved["state"].get(i)
        if st:
            mu[field][key], nu[field][key] = st["exp_avg"], st["exp_avg_sq"]
            steps.append(int(st["step"]))
        else:  # never stepped: optax holds zeros
            mu[field][key] = nu[field][key] = torch.zeros_like(payload[field][key])
    models = _models(state)

    def tree(moments):
        per = {f: to_flax(model_layers(models[f]), moments[f], params_only=True)["params"]
               for f in fields}
        return per[fields[0]] if len(fields) == 1 else sorted_tree(per)

    count = np.asarray(max(steps, default=0), dtype=np.int32)
    return {"0": {"count": count, "mu": tree(mu), "nu": tree(nu)}, "1": {}}


def _adam_from_jax(tree, state, opt, where: str) -> Dict[str, Any]:
    if (not isinstance(tree, dict) or set(tree) != {"0", "1"} or tree["1"] != {}
            or not isinstance(tree["0"], dict) or set(tree["0"]) != {"count", "mu", "nu"}):
        raise ValueError(f"{where}: not optax Adam's state {{0: {{count, mu, nu}}, 1: {{}}}}")
    index = _param_index(state, opt)
    fields = _fields_of(index)
    models = _models(state)
    count = int(np.asarray(tree["0"]["count"]))
    moments = {}
    for name in ("mu", "nu"):
        sub = tree["0"][name]
        if len(fields) > 1:
            if not isinstance(sub, dict) or sorted(sub) != fields:
                got = sorted(sub) if isinstance(sub, dict) else type(sub).__name__
                raise ValueError(f"{where}/0/{name}: over {got}, the port's optimizer over {fields}")
            per = sub
        else:
            per = {fields[0]: sub}
        moments[name] = {}
        for f in fields:
            at = f"{where}/0/{name}/" + (f"{f}/" if len(fields) > 1 else "")
            layers = model_layers(models[f])
            _checked(layers, {"params": per[f]}, _shapes(models[f]), at, params_only=True)
            moments[name][f] = from_flax(layers, {"params": per[f]}, params_only=True)
    state_out = {}
    if count > 0:
        for i, (field, key) in enumerate(index):
            state_out[i] = {"step": torch.tensor(float(count)),
                            "exp_avg": moments["mu"][field][key],
                            "exp_avg_sq": moments["nu"][field][key]}
    groups, start = [], 0
    for group in opt.param_groups:
        n = len(group["params"])
        groups.append({**{k: v for k, v in group.items() if k != "params"},
                       "params": list(range(start, start + n))})
        start += n
    return {"state": state_out, "param_groups": groups}


# --- train states -----------------------------------------------------------


def _fields(state) -> Tuple[str, ...]:
    for cls, fields in JAX_FIELDS.items():
        if isinstance(state, cls):
            return fields
    raise TypeError(f"{type(state).__name__} is not a train state")


def state_to_jax(state, payload: Dict[str, Any]) -> dict:
    """The JAX tree of ``state``, from its train-state ``payload``
    (``train/checkpoint.py::train_state_payload``: the host copies, model
    shards and ZeRO slices gathered)."""
    tree = {}
    for name in _fields(state):
        value = getattr(state, name)
        if value is None:
            tree[name] = None
        elif name == "step":
            tree[name] = np.asarray(int(value), dtype=np.int32)
        elif name == "rng":
            tree[name] = key_from_generator(value)
        elif isinstance(value, nn.Module):
            tree[name] = model_to_jax(value, payload[name])
        else:
            tree[name] = _adam_to_jax(state, value, payload[name], payload)
    return tree


def state_from_jax(tree, state) -> Dict[str, Any]:
    """A JAX train-state tree as the port's train-state payload for
    ``state`` (what ``train/checkpoint.py`` applies); raises naming the
    first path that does not fit."""
    fields = _fields(state)
    if not isinstance(tree, dict) or list(tree) != list(fields):
        got = list(tree) if isinstance(tree, dict) else type(tree).__name__
        raise ValueError(f"/: a JAX {type(state).__name__} holds {list(fields)}, the file {got}")
    payload: Dict[str, Any] = {}
    for name in fields:
        value, saved = getattr(state, name), tree[name]
        if (value is None) != (saved is None):
            raise ValueError(f"{name}: the file holds {'none' if saved is None else 'one'}, "
                             f"this state {'none' if value is None else 'one'}")
        if value is None:
            continue
        if name == "step":
            step = np.asarray(saved)
            if step.shape != () or step.dtype.kind not in "iu":
                raise ValueError(f"step: an integer scalar, got {step.dtype} {step.shape}")
            payload[name] = int(step)
        elif name == "rng":
            gen = torch.Generator(device=value.device)
            gen.manual_seed(seed_from_key(saved))
            payload[name] = gen.get_state()
        elif isinstance(value, nn.Module):
            payload[name] = model_from_jax(saved, value, where=f"{name}/")
        else:
            payload[name] = _adam_from_jax(saved, state, value, name)
    return payload
