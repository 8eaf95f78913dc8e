"""ZeRO-1: Adam moments sharded over the data axis.

PyTorch counterpart of ``eadgan_tpu/parallel/zero.py``.  Replicated data
parallelism keeps every Adam moment on every rank; the moments are most
of a train state (CelebA's three Adam partitions are ~395 MiB of ~494
MiB, with ``opt_info`` holding its own moments of G and D beside
``opt_g``'s and ``opt_d``'s).  Under ZeRO-1 each ``opt*`` optimizer of a
state keeps moments only for its rank's slice of each parameter
(:func:`zero_spec`, the JAX package's rule), while parameters stay
replicated.  :class:`ZeroAdam` steps so:

1. the gradients are averaged over the ranks as in replicated data
   parallelism (``mesh.mean_gradients``: one all-reduce of a flat
   buffer);
2. each rank copies its slice of every parameter and gradient into leaf
   tensors of its own and runs the optimizer's own ``torch.optim.Adam``
   (same hyperparameters, ``capturable`` on the card) over them;
3. the updated slices are all-gathered back into the full parameters.

Adam is elementwise and each element sees the same gradient and the same
arithmetic as under replicated data parallelism, so the two agree bit
for bit (the JAX package's reduce-scatter lets the summation order
differ, hence its rtol of 2e-4; this design does not need it).  A saved
file always holds the full, gathered moments in ``torch.optim.Adam``'s
own layout, and restores under any world size, with or without ZeRO.

On a (data, model) grid ZeRO-1 composes with the model shard, as the
JAX package's ``base`` spec does: a sharded weight's moments keep their
model cut and gain a data cut on another dimension (:func:`zero_spec`'s
``exclude``), so each rank holds 1/(data * model) of them; the slices
are cut and gathered over the grid's data group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist

from eadgan_tpu_torch.parallel.mesh import (
    _check_gathering,
    gathering,
    mean_gradients,
    model_shards,
)
from eadgan_tpu_torch.parallel.multihost import Mesh, default_mesh

__all__ = ["zero_spec", "ZeroAdam", "zero_place", "gathering"]


def zero_spec(shape, n_shards: int, min_elems: int = 1024,
              exclude: Optional[int] = None) -> Optional[int]:
    """The dimension of a leaf of global ``shape`` that is sharded over
    ``n_shards`` data ranks: the largest one that divides by ``n_shards``
    (the first of equals) other than ``exclude`` (the model shard's
    dimension: the JAX ``base`` spec's claimed axis), or None for a
    scalar, a leaf of fewer than ``min_elems`` elements (biases: sharding
    buys nothing and costs a collective) or a leaf no free dimension of
    which divides."""
    shape = tuple(shape)
    size = 1
    for d in shape:
        size *= d
    if not shape or size < min_elems:
        return None
    candidates = [i for i, d in enumerate(shape) if d % n_shards == 0 and i != exclude]
    if not candidates:
        return None
    return max(candidates, key=lambda i: shape[i])


class ZeroAdam:
    """A ``torch.optim.Adam`` whose moments live as rank slices.

    Built from the replicated optimizer ``opt`` (its hyperparameters, and
    its moments when a restored state has them); exposes what the train
    steps and the checkpoints use: ``param_groups``, ``zero_grad``,
    ``step``, ``state_dict`` and ``load_state_dict``."""

    def __init__(self, opt: torch.optim.Adam, rank: Optional[int] = None,
                 world: Optional[int] = None, mesh: Optional[Mesh] = None,
                 shards: Optional[Dict] = None):
        mesh = mesh or default_mesh()
        self.rank = mesh.data_index if rank is None else rank
        self.world = mesh.data if world is None else world
        self.group = mesh.data_group
        shards = shards or {}
        self.template = type(opt)([dict(g, params=list(g["params"])) for g in opt.param_groups],
                                  **opt.defaults)
        self.param_groups = self.template.param_groups
        self.params = [p for g in self.param_groups for p in g["params"]]
        # on the global shape, the model shard's dimension excluded
        self.dims = [zero_spec(shards[id(p)].full_shape, self.world, exclude=shards[id(p)].dim)
                     if id(p) in shards else zero_spec(p.shape, self.world) for p in self.params]
        self.shards = []
        for i, p in enumerate(self.params):
            shard = self._slice(p, i).detach().clone()
            shard.grad = torch.zeros_like(shard)
            self.shards.append(shard)
        groups, i = [], 0
        for g in self.param_groups:
            n = len(g["params"])
            groups.append(dict(g, params=self.shards[i : i + n]))
            i += n
        self.inner = type(opt)(groups, **opt.defaults)
        if opt.state:
            self.load_state_dict(opt.state_dict())

    def _slice(self, t: torch.Tensor, i: int) -> torch.Tensor:
        d = self.dims[i]
        if d is None:
            return t
        k = t.shape[d] // self.world
        return t.narrow(d, self.rank * k, k)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        """Average the gradients, step this rank's slices, gather them."""
        mean_gradients(self.params)
        stepped = []
        for i, (p, shard) in enumerate(zip(self.params, self.shards)):
            if p.grad is None:
                shard.grad = None  # Adam skips it, as it skips p
                continue
            if shard.grad is None:
                shard.grad = torch.zeros_like(shard)
            shard.copy_(self._slice(p, i))
            shard.grad.copy_(self._slice(p.grad, i))
            stepped.append(i)
        self.inner.step()
        for i in stepped:
            self._gather_into(self.params[i], self.shards[i], self.dims[i])

    def _gather_into(self, full: torch.Tensor, shard: torch.Tensor, d: Optional[int]) -> None:
        if d is None or self.world == 1:
            full.copy_(shard)
            return
        parts = [torch.empty_like(shard) for _ in range(self.world)]
        dist.all_gather(parts, shard.contiguous(), group=self.group)
        full.copy_(torch.cat(parts, dim=d))

    def _full(self, shard: torch.Tensor, d: Optional[int]) -> torch.Tensor:
        if d is None or self.world == 1:
            return shard
        _check_gathering()
        parts = [torch.empty_like(shard) for _ in range(self.world)]
        dist.all_gather(parts, shard.contiguous(), group=self.group)
        return torch.cat(parts, dim=d)

    def state_dict(self) -> Dict:
        """The state in ``torch.optim.Adam``'s layout, the moments gathered
        over the data axis (those of a model-sharded parameter stay its
        model shard's: ``mesh.gather_optimizer_state`` gathers the rest):
        a file of it loads into a plain Adam over the same parameters, or
        a :class:`ZeroAdam` of any world size."""
        out = self.template.state_dict()
        state = {}
        for i, shard in enumerate(self.shards):
            st = self.inner.state.get(shard)
            if not st:
                continue
            state[i] = {k: (self._full(v, self.dims[i]) if torch.is_tensor(v) and v.dim() else v)
                        for k, v in st.items()}
        out["state"] = state
        return out

    def load_state_dict(self, saved: Dict) -> None:
        """Take the full state ``saved`` (Adam's layout) and keep this
        rank's slices of its moments; the groups' settings stay this
        optimizer's (``capturable`` as it was built)."""
        self.inner.state.clear()
        capturable = {id(s): g.get("capturable", False)
                      for g in self.inner.param_groups for s in g["params"]}
        for key, st in saved["state"].items():
            i = int(key)
            shard = self.shards[i]
            entry = {}
            for k, v in st.items():
                if k == "step":
                    entry[k] = torch.as_tensor(v, dtype=torch.float32).clone().to(
                        shard.device if capturable[id(shard)] else "cpu")
                elif torch.is_tensor(v) and v.dim():
                    entry[k] = self._slice(v, i).to(shard.device, copy=True).contiguous()
                else:
                    entry[k] = v
            self.inner.state[shard] = entry


def zero_place(state, mesh: Optional[Mesh] = None) -> None:
    """Replace every ``opt*`` optimizer of a replicated (and, on a grid,
    model-sharded) train state with a :class:`ZeroAdam` of it over
    ``mesh``'s data axis (by default ``default_mesh()``'s: the process
    group), in place;
    models, generator and step stay."""
    shards = model_shards(state)
    if shards and mesh is None:
        raise ValueError("a model-sharded state needs its mesh: zero_place(state, mesh)")
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if f.name.startswith("opt") and isinstance(value, torch.optim.Optimizer):
            setattr(state, f.name, ZeroAdam(value, mesh=mesh, shards=shards))
