"""The ``data`` and ``model`` axes: sliced batches, global statistics,
output-channel-sharded layers.

PyTorch counterpart of ``eadgan_tpu/parallel/mesh.py``.  There, batches
are sharded over the ``data`` mesh axis, the large kernels over the
``model`` axis on their output features (:func:`shard_model_params`),
everything else is replicated, and XLA's SPMD partitioner inserts the
collectives.  Here each rank is one process on a (data, model) grid
(``multihost.default_mesh``) and the collectives are written out.

**The data axis is the grid's data group**: the ranks that hold the same
model shards and different rows (the whole process group when there is
no model axis).  Each keeps its slice of the global batch, and three
reductions run over that group:

* the gradients, averaged before each optimizer step: one all-reduce of
  a flat buffer per step (:func:`mean_gradients`, from a step pre-hook
  :func:`replicate` registers on each ``opt*`` optimizer);
* the BatchNorm statistics (``models/layers.py::TorchBatchNorm``), through
  :func:`global_mean`, whose backward all-reduces the gradient;
* the logged metrics (:func:`data_parallel_step`).

The random draws of a step (codes, noise, colours) are made at the global
batch from the step's generator, identical on every rank, and each rank
keeps its data index's rows (:func:`local_rows`): a step on the grid
computes what one rank computes on the global batch.

**The model axis** shards each large layer's weight on its output
features (:func:`shard_model_params`, the JAX rule): the ranks of a model
group hold the same rows and compute one replicated loss, so a sharded
layer (``models/layers.py``) runs column-parallel through three autograd
functions, unlike the data axis's sum of per-rank losses: its input
passes :func:`copy_to_model` (backward: the input gradient summed over
the group), its output :func:`gather_from_model` (backward: this rank's
slice of the replicated gradient), and spectral norm's partial sums
:func:`reduce_from_model` (backward: identity).  The replicated
parameters' gradients are made the model group's first rank's before
each optimizer step (:func:`mean_gradients`), so the replicas never
drift apart, whatever order a kernel sums in.

All of this is active only inside :func:`data_axis`, which the engine
enters around each train step on the thread that runs it (a sharded
layer issues its collectives wherever it runs, so ``run_epochs`` refuses
a sharded state: rank 0's grids would wait for the others).  Rank 0's
sample grids and saves run outside it and alone.  At a data axis of 1
and no model axis every number is bit-equal to the step without a group:
a sum over one rank and a division by 1.0 are exact, and no layer is
sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from eadgan_tpu_torch.parallel.multihost import Mesh, default_mesh, process_count

__all__ = [
    "data_axis",
    "axis_size",
    "local_rows",
    "global_mean",
    "all_reduce_mean",
    "mean_gradients",
    "replicate",
    "shard_batch",
    "shard_window",
    "data_parallel_step",
    "collective_count",
    "ModelShard",
    "copy_to_model",
    "gather_from_model",
    "reduce_from_model",
    "model_collectives",
    "reset_model_collectives",
    "model_shard_plan",
    "shard_model_params",
    "model_shards",
    "has_model_shards",
    "placed_tensors",
    "state_shardings",
    "gathering",
    "full_tensor",
    "gathered_state_dict",
    "gather_optimizer_state",
]

_AXIS = threading.local()  # .axis: (mesh, ids of the stepped state's model shards)
_GATHER = threading.local()
_COUNT = [0]  # collectives issued from Python (a captured graph replays them uncounted)
# model-axis collectives by function: [count, bytes]
_MODEL = {"copy": [0, 0], "gather": [0, 0], "reduce": [0, 0], "sync": [0, 0]}


def collective_count() -> int:
    """Collectives the data axis has issued in this process so far (a
    CUDA-graph replay runs the captured ones without counting)."""
    return _COUNT[0]


def _all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    _COUNT[0] += 1
    dist.all_reduce(t, group=group)
    return t


@contextlib.contextmanager
def data_axis(mesh: Optional[Mesh] = None, state=None):
    """Inside the block, on this thread: BatchNorm statistics and the
    gradients of optimizer steps are reduced over the data axis (the
    data group of ``mesh``, by default ``default_mesh()``: the whole
    process group), and the steps' draws are sliced to this rank's rows.
    On a model axis the block steps ``state``: the gradients of its
    model-sharded weights stay this rank's own, and every other gradient
    is made the model group's first rank's (:func:`mean_gradients`)."""
    if not dist.is_initialized():
        raise RuntimeError("the data axis needs a process group (parallel.initialize or join_local)")
    mesh = mesh or default_mesh()
    if mesh.model > 1 and state is None:
        raise ValueError("a model axis steps a train state: data_axis(mesh, state)")
    prev = getattr(_AXIS, "axis", None)
    _AXIS.axis = (mesh, frozenset(model_shards(state)) if mesh.model > 1 else frozenset())
    try:
        yield
    finally:
        _AXIS.axis = prev


def _mesh() -> Optional[Mesh]:
    axis = getattr(_AXIS, "axis", None)
    return axis[0] if axis else None


def axis_size() -> int:
    """The data axis's size inside :func:`data_axis`, 0 outside it."""
    mesh = _mesh()
    return mesh.data if mesh else 0


def local_rows(x, local_batch: int):
    """This rank's ``local_batch`` rows of ``x``, a draw (or a ``fixed=``
    input) made at the global batch.  Outside :func:`data_axis`, ``x``
    itself: the global batch is the local one."""
    n = axis_size()
    if not n or len(x) == local_batch:
        return x
    if len(x) != n * local_batch:
        raise ValueError(f"a draw of {len(x)} rows for {n} ranks of {local_batch}")
    start = _mesh().data_index * local_batch
    return x[start : start + local_batch]


def global_batch(local_batch: int) -> int:
    """The global batch a step's draws are made at: ``local_batch`` times
    the data axis's size (``local_batch`` outside it)."""
    return local_batch * (axis_size() or 1)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the data axis; the backward sums the gradient over it
    (each rank's loss depends on every rank's input through the sum).
    The group rides on ``ctx``: on the card the backward runs on
    autograd's own thread, outside :func:`data_axis`."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.group), None


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the data axis of ``x``, each rank's mean over its
    equal slice of the batch, so the mean over the global batch;
    differentiable.  Outside :func:`data_axis`, ``x`` itself."""
    mesh = _mesh()
    if not mesh:
        return x
    return _AllReduceSum.apply(x, mesh.data_group) / float(mesh.data)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data axis in place (no autograd; the whole
    process group outside :func:`data_axis`)."""
    mesh = _mesh() or default_mesh()
    return _all_reduce(x, mesh.data_group).div_(float(mesh.data))


def _flat(grads, reduce) -> None:
    """``reduce`` one flat buffer of ``grads`` in place, copied back."""
    if not grads:
        return
    flat = reduce(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def _from_first_model_rank(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    _count("sync", flat)
    dist.broadcast(flat, src=mesh.data_index * mesh.model, group=mesh.model_group)
    return flat


def mean_gradients(params) -> None:
    """Average the gradients of ``params`` over the data axis: one
    all-reduce of one flat buffer, then a division by its size, copied
    back.  Parameters without a gradient are left alone (the same on
    every rank: each runs the same graph).

    On a model axis the replicated parameters' gradients (all but the
    model-sharded weights of the state :func:`data_axis` steps) are then
    broadcast in one flat buffer from the first rank of the model group:
    the ranks of a group compute them from the same bits, but a kernel
    that sums in a varying order (cuDNN's non-deterministic algorithms,
    atomic adds) may round them apart, and replicas must not drift.  With
    deterministic kernels no bit changes."""
    _flat([p.grad for p in params if p.grad is not None], all_reduce_mean)
    mesh = _mesh()
    if mesh is not None and mesh.model > 1:
        sharded = _AXIS.axis[1]
        _flat([p.grad for p in params if p.grad is not None and id(p) not in sharded],
              lambda flat: _from_first_model_rank(flat, mesh))


def _params(opt):
    return [p for group in opt.param_groups for p in group["params"]]


def _mean_gradients_hook(opt, args, kwargs):
    if axis_size():
        mean_gradients(_params(opt))


def _state_values(state):
    return [getattr(state, f.name) for f in dataclasses.fields(state)
            if getattr(state, f.name) is not None]


def replicate(state):
    """Make a train state data-parallel in place; returns it.  Every
    parameter and buffer of its models (spectral-norm ``u``/``sigma``,
    BatchNorm statistics), the Adam state of its optimizers and its
    generator's state are broadcast from rank 0, so a fresh or restored
    state is identical on every rank (nothing moves at a world size of
    1); each ``opt*`` optimizer gets the step pre-hook that averages its
    gradients inside :func:`data_axis`.  It comes before
    :func:`shard_model_params`, so the shards are cut from one state."""
    if has_model_shards(state):
        raise ValueError("replicate a state before shard_model_params: a broadcast from rank 0 "
                         "would overwrite the other model ranks' shards")
    broadcast = process_count() > 1
    for value in _state_values(state):
        if isinstance(value, nn.Module):
            if broadcast:
                for t in value.state_dict().values():
                    dist.broadcast(t, src=0)
        elif isinstance(value, torch.optim.Optimizer):
            if broadcast:
                for p in _params(value):
                    for k in sorted(value.state.get(p, {})):
                        if torch.is_tensor(value.state[p][k]):
                            dist.broadcast(value.state[p][k], src=0)
            if not getattr(value, "_eadgan_mean_gradients", False):
                value.register_step_pre_hook(_mean_gradients_hook)
                value._eadgan_mean_gradients = True
        elif isinstance(value, torch.Generator) and broadcast:
            rng = value.get_state()
            dist.broadcast(rng, src=0)
            value.set_state(rng)
    return state


def shard_batch(batch: np.ndarray, rows: slice) -> np.ndarray:
    """This rank's ``rows`` of a host batch's leading (batch) axis."""
    return batch[rows]


def shard_window(window: np.ndarray, rows: slice) -> np.ndarray:
    """This rank's ``rows`` of a (K, B, ...) window's batch axis: each
    step of the window then sees the slice :func:`shard_batch` gives."""
    return window[:, rows]


def data_parallel_step(step_fn: Callable, mesh: Optional[Mesh] = None) -> Callable:
    """``step_fn`` run inside :func:`data_axis` of ``mesh`` and the state
    it steps, its metrics averaged over the data axis in one all-reduce
    (the means over the global batch; a model group computes them once,
    replicated)."""

    def step(state, *batch, **kwargs):
        with data_axis(mesh, state):
            state, metrics = step_fn(state, *batch, **kwargs)
            keys = sorted(metrics)
            packed = all_reduce_mean(torch.stack([metrics[k].float().reshape(()) for k in keys]))
        return state, {k: packed[i] for i, k in enumerate(keys)}

    return step


# --- the model axis -------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShard:
    """A layer's weight cut on dimension ``dim`` over ``mesh``'s model
    group: this rank holds the contiguous ``full_shape[dim] // mesh.model``
    rows at its model index."""

    dim: int
    mesh: Mesh
    full_shape: tuple

    def __deepcopy__(self, memo):
        return self

    @property
    def rows(self) -> slice:
        k = self.full_shape[self.dim] // self.mesh.model
        return slice(self.mesh.model_index * k, (self.mesh.model_index + 1) * k)


def _count(kind: str, t: torch.Tensor) -> None:
    _MODEL[kind][0] += 1
    _MODEL[kind][1] += t.numel() * t.element_size()


def model_collectives() -> Dict[str, Dict[str, int]]:
    """The model-axis collectives this process has issued since
    :func:`reset_model_collectives`, by function: ``count`` and ``bytes``
    (the all-reduced tensor, or the gathered full one; ``sync``: the
    replicated gradients :func:`mean_gradients` broadcasts)."""
    return {k: {"count": c, "bytes": b} for k, (c, b) in _MODEL.items()}


def reset_model_collectives() -> None:
    for v in _MODEL.values():
        v[0] = v[1] = 0


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the input gradient over the model
    group (each rank's rows of the layer saw all of the input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        _count("copy", grad)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather along ``dim``; the backward keeps this rank's slice of
    the gradient, which is the same on every rank of the group (one
    replicated loss), so no collective."""

    @staticmethod
    def forward(ctx, y, dim, group, size, index):
        ctx.dim, ctx.index, ctx.k = dim, index, y.shape[dim]
        y = y.contiguous()
        parts = [torch.empty_like(y) for _ in range(size)]
        dist.all_gather(parts, y, group=group)
        out = torch.cat(parts, dim=dim)
        _count("gather", out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.k, ctx.k), None, None, None, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce sum over the model group; the backward passes the
    (replicated) gradient through to this rank's part."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        _count("reduce", x)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A sharded layer's input: ``x``, whose gradient the backward sums
    over ``mesh``'s model group."""
    return _CopyToModel.apply(x, mesh.model_group)


def gather_from_model(y: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """A sharded layer's output: the model group's slices of ``y``
    concatenated along ``dim`` in model order."""
    return _GatherFromModel.apply(y, dim, mesh.model_group, mesh.model, mesh.model_index)


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over ``mesh``'s model group (spectral norm's
    partial dot products); the backward is the identity."""
    return _ReduceFromModel.apply(x, mesh.model_group)


def model_shard_plan(module: nn.Module, model_parallel: int, min_channels: int = 256) -> Dict[str, int]:
    """``{weight name: output dimension}`` of the layers of ``module``
    that the JAX rule shards over a model axis of ``model_parallel``: a
    weight of two or more dimensions whose output features number at
    least ``min_channels`` and divide by ``model_parallel``.  The output
    features are dimension 0 of a conv's or a dense's weight and 1 of a
    transposed conv's (the layers' ``out_dim``), the last dimension of
    the flax kernels; every weight of two or more dimensions in the
    port's models is one of those layers'.  Empty at
    ``model_parallel == 1``."""
    if model_parallel <= 1:
        return {}
    plan = {}
    for name, layer in module.named_modules():
        dim = getattr(layer, "out_dim", None)
        if dim is None:
            continue
        out = layer.weight.shape[dim]
        if out >= min_channels and out % model_parallel == 0:
            plan[f"{name}.weight" if name else "weight"] = dim
    return plan


def _modules_of(target):
    if isinstance(target, nn.Module):
        return [target]
    values = _state_values(target) if dataclasses.is_dataclass(target) else vars(target).values()
    return [v for v in values if isinstance(v, nn.Module)]


def _optimizers_of(target):
    if isinstance(target, nn.Module):
        return {}
    return {f.name: getattr(target, f.name) for f in dataclasses.fields(target)
            if f.name.startswith("opt") and getattr(target, f.name) is not None}


def shard_model_params(mesh: Mesh, target, min_channels: int = 256):
    """Shard the large layers of ``target`` (a model, or a train state's
    models) over ``mesh``'s model axis in place; returns ``target``.

    Each weight :func:`model_shard_plan` names is replaced by this rank's
    contiguous rows on its output dimension, and its layer records a
    :class:`ModelShard`, which turns its forward column-parallel.  In a
    train state the new parameter takes the old one's place in every
    ``opt*`` optimizer that held it (CelebA's ``opt_info`` holds G's and
    D's), and Adam moments already there (a restored state) are cut
    with it.  Everything else stays replicated; at ``mesh.model == 1``
    nothing changes.  Comes after :func:`replicate` and before
    ``zero.zero_place``."""
    swapped = {}
    for module in _modules_of(target):
        for name, dim in model_shard_plan(module, mesh.model, min_channels).items():
            layer = module.get_submodule(name.rpartition(".")[0])
            if layer.model_shard is not None:
                raise ValueError(f"{name} is already sharded")
            old = layer.weight
            shard = ModelShard(dim, mesh, tuple(old.shape))
            layer.weight = nn.Parameter(old.detach()[(slice(None),) * dim + (shard.rows,)].clone(),
                                        requires_grad=old.requires_grad)
            layer.model_shard = shard
            swapped[id(old)] = (old, layer.weight, shard)
    for name, opt in _optimizers_of(target).items():
        if not isinstance(opt, torch.optim.Optimizer):
            raise ValueError(f"{name} is not a plain optimizer: shard_model_params comes before "
                             "zero_place")
        for group in opt.param_groups:
            for i, p in enumerate(group["params"]):
                if id(p) not in swapped:
                    continue
                old, new, shard = swapped[id(p)]
                group["params"][i] = new
                st = opt.state.pop(old, None)
                if st:
                    cut = (slice(None),) * shard.dim + (shard.rows,)
                    opt.state[new] = {k: (v[cut].clone() if torch.is_tensor(v) and v.shape == old.shape
                                          else v) for k, v in st.items()}
    return target


def model_shards(target) -> Dict[int, ModelShard]:
    """``{id(weight): ModelShard}`` of the sharded layers of ``target``
    (a model or a train state)."""
    return {id(m.weight): m.model_shard for module in _modules_of(target)
            for m in module.modules() if getattr(m, "model_shard", None) is not None}


def has_model_shards(target) -> bool:
    return bool(model_shards(target))


def placed_tensors(state):
    """``(name, placement, tensor)`` of each tensor of a train state: its
    models' parameters and buffers and its optimizers' Adam moments (a
    ZeRO optimizer's slices), ``placement`` the ``(axis, dim)`` pairs the
    tensor is cut on, ``("model", d)`` for a sharded weight and its
    moments, ``("data", d)`` for a ZeRO slice, empty when replicated."""
    shards = model_shards(state)
    for name, value in ((f.name, getattr(state, f.name)) for f in dataclasses.fields(state)):
        if isinstance(value, nn.Module):
            sharded = {f"{n}.weight": m.model_shard for n, m in value.named_modules()
                       if getattr(m, "model_shard", None) is not None}
            for key, t in value.state_dict(keep_vars=True).items():
                place = (("model", sharded[key].dim),) if key in sharded else ()
                yield f"{name}.{key}", place, t
        elif name.startswith("opt") and value is not None:
            zero = getattr(value, "dims", None)  # a ZeroAdam's data dims
            for i, p in enumerate(_params(value)):
                st = value.inner.state.get(value.shards[i], {}) if zero else value.state.get(p, {})
                model = (("model", shards[id(p)].dim),) if id(p) in shards else ()
                data = (("data", zero[i]),) if zero and zero[i] is not None else ()
                for k, v in sorted(st.items()):
                    if torch.is_tensor(v) and v.dim():
                        yield f"{name}.state.{i}.{k}", model + data, v


def state_shardings(state) -> Dict[str, tuple]:
    """Each tensor of a train state by name, as ``(placement, local
    shape)`` (:func:`placed_tensors`).  A step must leave it unchanged:
    the contract the JAX package's ``constrain_like`` pins on a step's
    outputs.  ``constrain_like`` itself has no counterpart: the port
    never re-places a tensor, it updates each in place."""
    return {name: (place, tuple(t.shape)) for name, place, t in placed_tensors(state)}


@contextlib.contextmanager
def gathering():
    """Inside the block, on this thread, model shards (and ZeRO slices)
    may be gathered into full tensors, a collective: every rank must be
    in it (``multihost.save_on_coordinator``)."""
    _GATHER.on = True
    try:
        yield
    finally:
        _GATHER.on = False


def _check_gathering() -> None:
    if not getattr(_GATHER, "on", False):
        raise RuntimeError(
            "the state is sharded over the ranks: gather it on every rank at once "
            "(parallel.save_on_coordinator / checkpoint.save_train_state_sync)")


def full_tensor(t: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """The model group's shards of ``t`` concatenated along
    ``shard.dim``: a collective, only inside :func:`gathering`."""
    _check_gathering()
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(shard.mesh.model)]
    dist.all_gather(parts, t.detach().contiguous(), group=shard.mesh.model_group)
    return torch.cat(parts, dim=shard.dim)


def gathered_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with each sharded weight gathered whole
    (:func:`full_tensor`): the one-rank layout."""
    sd = module.state_dict()
    for name, m in module.named_modules():
        if getattr(m, "model_shard", None) is not None:
            key = f"{name}.weight" if name else "weight"
            sd[key] = full_tensor(sd[key], m.model_shard)
    return sd


def gather_optimizer_state(saved: Dict, params, shards: Dict[int, ModelShard]) -> Dict:
    """An optimizer's ``state_dict`` ``saved`` (over ``params``, in
    order) with the moments of each model-sharded parameter gathered
    whole (:func:`full_tensor`); returns it.  Each such entry is a new
    dict: ``state_dict`` hands out the optimizer's own."""
    for i, p in enumerate(params):
        shard = shards.get(id(p))
        if shard is None or i not in saved["state"]:
            continue
        saved["state"][i] = {k: (full_tensor(v, shard) if torch.is_tensor(v) and v.shape == p.shape
                                 else v) for k, v in saved["state"][i].items()}
    return saved
