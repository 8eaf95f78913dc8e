"""Process bootstrap and host-side collectives of a multi-process gang.

PyTorch counterpart of ``eadgan_tpu/parallel/multihost.py``.  A JAX
device on the ``data`` axis is a torch *rank* here, one process per
card, so what the JAX package does over the devices of one process the
port does over processes:

* every process calls :func:`initialize` before it touches the card (a
  no-op outside a cluster); it joins one ``torch.distributed`` process
  group over ``tcp://`` and returns the rank's device;
* :func:`default_mesh` lays the ranks out as a (data, model) grid, the
  JAX ``mesh.py::default_mesh`` reshape, with a process group for each
  row and each column of it;
* every rank computes the same global batch order from ``--seed`` and
  gathers only its data slice of each batch (:func:`host_batch_slice`);
* one process (rank 0) writes files and log lines
  (:func:`is_coordinator`); a final save is collective
  (:func:`save_on_coordinator`), and a graceful stop is a gang decision
  (:func:`any_process_flag`).

The backend is NCCL on the card (with gloo beside it for the host-side
flags and barriers, which then never wait for the card) and gloo on the
CPU.  Ranks take card ``LOCAL_RANK`` (or ``EADGAN_MP_PROCESS_ID``);
NCCL refuses two ranks on one card, so ranks that would share one raise
before they join, unless ``EADGAN_DIST_BACKEND=gloo`` asks for gloo on
the card, the only way ranks may share it (per-step engine only: a gloo
collective cannot be captured in a CUDA graph).
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "any_process_flag",
    "backend",
    "default_mesh",
    "initialize",
    "join_local",
    "host_batch_slice",
    "host_barrier",
    "is_coordinator",
    "process_count",
    "process_index",
    "save_on_coordinator",
    "sync",
]

# Explicit coordinator markers, as in the JAX package (scheduler variables
# such as SLURM_JOB_ID are set for single-process allocations too), plus
# torchrun's MASTER_ADDR.
_CLUSTER_ENV_VARS = (
    "EADGAN_MP_COORDINATOR",
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
    "MEGASCALE_COORDINATOR_ADDRESS",
)
_BARRIERS = itertools.count()


def rank_environment(coordinator_address=None, num_processes=None, process_id=None):
    """``(coordinator "host:port" or None, world size or None, rank or
    None, local rank or None)`` from the arguments, then the
    ``EADGAN_MP_*`` triple that ``cli.supervise --ranks N`` sets, the
    coordinator variables of the JAX package, and torchrun's
    ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``."""
    env = os.environ
    if coordinator_address is None:
        named = [env[v] for v in _CLUSTER_ENV_VARS if env.get(v)]
        if named:
            coordinator_address = named[0]
        elif env.get("MASTER_ADDR"):
            coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        n = env.get("EADGAN_MP_NUM_PROCESSES") or env.get("WORLD_SIZE")
        num_processes = int(n) if n else None
    if process_id is None:
        r = env.get("EADGAN_MP_PROCESS_ID") or env.get("RANK")
        process_id = int(r) if r else None
    local = env.get("LOCAL_RANK")
    local_rank = int(local) if local else process_id
    return coordinator_address, num_processes, process_id, local_rank


def wants_gang() -> bool:
    """Whether the environment names more than one process: a world size
    above 1, or a coordinator address without a world size."""
    coord, world, _, _ = rank_environment()
    return (world or 0) > 1 or (coord is not None and world is None)


def check_rank_environment(coordinator_address=None, num_processes=None, process_id=None):
    """:func:`rank_environment` when it names a gang, None when it names
    none (no coordinator, or a world size of 1); raises ``ValueError``
    for a gang without its coordinator, world size or rank."""
    coord, world, rank, local_rank = rank_environment(coordinator_address, num_processes, process_id)
    if world is not None and world <= 1:
        return None
    if coord is None:
        if world is None:
            return None
        raise ValueError(f"a gang of {world} processes names no coordinator address "
                         "(EADGAN_MP_COORDINATOR, or torchrun's MASTER_ADDR)")
    if world is None or rank is None:
        raise ValueError(f"coordinator {coord} without a world size and a rank "
                         "(EADGAN_MP_NUM_PROCESSES and EADGAN_MP_PROCESS_ID, or WORLD_SIZE and RANK)")
    return coord, world, rank, local_rank


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join the gang the arguments or the environment name
    (:func:`rank_environment`) and return this rank's device: ``device``
    itself on the CPU, the card ``LOCAL_RANK`` (or the process id) on a
    CUDA machine.  A true no-op that returns ``device`` when there is no
    cluster: no coordinator, or a world size of 1.  A world size above 1
    without a coordinator or a rank, or a coordinator without a world
    size, raises ``ValueError``; so do NCCL ranks that would share a card
    (:func:`_card`)."""
    device = torch.device(device)
    gang = check_rank_environment(coordinator_address, num_processes, process_id)
    if gang is None:
        return device
    coord, world, rank, local_rank = gang
    if dist.is_initialized():
        return _joined_device(device)
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    if not local_world and coord.rsplit(":", 1)[0] in ("localhost", "127.0.0.1"):
        local_world = world  # every rank of the gang is on this host
    device = _card(device, local_rank if local_rank is not None else rank,
                   int(local_world) if local_world else None)
    _join(f"tcp://{coord}", world, rank, device)
    return device


def join_local(device) -> torch.device:
    """A group of one process on ``device``, unless one exists: the port's
    counterpart of a mesh over one process's devices, which puts the data
    axis's collectives on a single-process ``--data_parallel`` run's
    path (on the card, inside the replayed graph).  Returns the device."""
    device = torch.device(device)
    if dist.is_initialized():
        return _joined_device(device)
    if device.type == "cuda":
        device = _card(device, device.index or 0, 1)
    _join(None, 1, 0, device)
    return device


def _joined_device(device: torch.device) -> torch.device:
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _card(device: torch.device, local_rank: int, local_world: Optional[int]) -> torch.device:
    """The card of local rank ``local_rank`` (made current).  Under NCCL,
    more local ranks than cards raise here, before any rank joins, so a
    gang that would share a card stops at its start and never deadlocks
    in a half-joined group."""
    if device.type != "cuda":
        return device
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device available for this rank (EADGAN_PLATFORM=cpu for the CPU)")
    shared = local_rank >= cards or (local_world or 0) > cards
    if shared and _backend_choice(device) != "gloo":
        raise RuntimeError(
            f"local rank {local_rank} of {local_world or '?'} on {cards} card(s): NCCL cannot run two "
            "ranks on one card; give each rank its own card, or set EADGAN_DIST_BACKEND=gloo to "
            "share it (per-step engine, --chain 1)")
    card = torch.device("cuda", local_rank % cards)
    torch.cuda.set_device(card)
    return card


def _backend_choice(device: torch.device) -> str:
    choice = os.environ.get("EADGAN_DIST_BACKEND", "").lower()
    if choice not in ("", "nccl", "gloo"):
        raise ValueError(f"EADGAN_DIST_BACKEND={choice!r}: expected nccl or gloo")
    if device.type != "cuda":
        if choice == "nccl":
            raise ValueError("EADGAN_DIST_BACKEND=nccl needs the card")
        return "gloo"
    return choice or "nccl"


def _join(init_method, world: int, rank: int, device: torch.device) -> None:
    choice = _backend_choice(device)
    kwargs = dict(world_size=world, rank=rank, timeout=datetime.timedelta(minutes=30))
    if init_method is None:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    if choice == "nccl":
        # a collective captured in a CUDA graph must not be polled by the
        # error-handling watchdog (torch's CUDA-graph notes)
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
        dist.init_process_group("cpu:gloo,cuda:nccl", device_id=device, **kwargs)
    else:
        dist.init_process_group("gloo", **kwargs)


def backend() -> str:
    """``"nccl"`` (card collectives on NCCL), ``"gloo"``, or ``""``
    outside a group."""
    if not dist.is_initialized():
        return ""
    return "nccl" if "nccl" in str(dist.get_backend()).lower() else "gloo"


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) grid of ``data * model``
    ranks: rank ``r`` sits at data index ``r // model`` and model index
    ``r % model``.  ``data_group`` joins the ranks of this rank's model
    index (they hold the same shards and different rows), ``model_group``
    those of its data index (the same rows, different shards); None is the
    default group (the world at ``model == 1``) or, for ``model_group``
    at ``model == 1``, no group at all (nothing is sharded).  A copy of a
    mesh is the mesh itself: its groups are the process's handles."""

    data: int
    model: int
    data_index: int
    model_index: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    def __deepcopy__(self, memo):
        return self


def default_mesh(model_parallel: int = 1) -> Mesh:
    """The (data, model) grid over the process group (one process
    without a group): the world's ranks reshaped row-major to
    ``(world // model_parallel, model_parallel)``, as the JAX
    ``default_mesh`` reshapes its devices, so a model group is adjacent
    ranks (adjacent cards).  Raises ``ValueError`` when the world does
    not divide.  With ``model_parallel > 1`` it builds every data group
    and every model group with ``dist.new_group``, a collective: every
    rank calls it, in the same order, or the gang hangs."""
    world, rank = process_count(), process_index()
    if model_parallel < 1 or world % model_parallel != 0:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    data = world // model_parallel
    mesh = dict(data=data, model=model_parallel, data_index=rank // model_parallel,
                model_index=rank % model_parallel)
    if model_parallel == 1:
        return Mesh(**mesh)
    if not dist.is_initialized():
        raise RuntimeError("a model axis needs a process group (parallel.initialize)")
    data_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model_parallel + m for d in range(data)] for m in range(model_parallel)])
    model_group, _ = dist.new_subgroups_by_enumeration(
        [[d * model_parallel + m for m in range(model_parallel)] for d in range(data)])
    return Mesh(**mesh, data_group=data_group, model_group=model_group)


def host_batch_slice(global_batch: int, mesh: Optional[Mesh] = None) -> slice:
    """The half-open rows of the global batch this rank feeds: its data
    index's slice on ``mesh`` (by default ``default_mesh()``, whose data
    axis is the whole world), the same on every rank of a model group.
    Raises when the global batch does not divide over the data axis: a
    silent truncation would train at a smaller batch than configured."""
    mesh = mesh or default_mesh()
    if global_batch % mesh.data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis size {mesh.data}")
    per_rank = global_batch // mesh.data
    start = mesh.data_index * per_rank
    return slice(start, start + per_rank)


def is_coordinator() -> bool:
    """True on the process that owns the side effects: rank 0 writes the
    checkpoints, sample grids and log lines.  The train state is
    replicated, so its files equal a one-process run's and restore under
    any process count."""
    return process_index() == 0


def _host_all_reduce(values, op) -> torch.Tensor:
    """All-reduce of a small int64 CPU tensor: through gloo in either
    backend, so it never waits for the card."""
    t = torch.as_tensor(values, dtype=torch.int64).reshape(-1).clone()
    dist.all_reduce(t, op=op)
    return t


def sync() -> None:
    """Barrier of every rank (no-op in one process): keeps the ranks that
    do not write alive until the coordinator's file is complete, and
    orders a restore after a write.  A host collective (gloo): the card's
    queue is not drained."""
    if process_count() > 1:
        _host_all_reduce([0], dist.ReduceOp.SUM)


def host_barrier(tag: str = "eadgan", timeout_s: int = 1800) -> None:
    """Barrier on the group's key-value store, which runs no collective and
    so is safe before the first one (the ranks' kernel builds and first
    steps may be minutes apart).  No-op in one process."""
    n = process_count()
    if n <= 1:
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"eadgan_barrier/{tag}/{next(_BARRIERS)}"
    store.set(f"{key}/{process_index()}", b"1")
    store.wait([f"{key}/{r}" for r in range(n)], datetime.timedelta(seconds=timeout_s))


def any_process_flag(flag: bool) -> bool:
    """Cross-process OR of a host-side flag, the gang's stop consensus:
    every rank calls it at the same loop boundary with its own flag
    ("my SIGTERM handler fired") and all get the same answer, so a gang
    whose step holds collectives stops at one boundary.  It is itself a
    collective (a MAX all-reduce of one int, on gloo), so every rank must
    call it the same number of times at the same points.  One process:
    ``bool(flag)``, no communication."""
    if process_count() <= 1:
        return bool(flag)
    return bool(_host_all_reduce([1 if flag else 0], dist.ReduceOp.MAX).item() > 0)


def save_on_coordinator(path: str, state) -> None:
    """Write the train state ``state`` to ``path`` from rank 0 only, then a
    barrier, so no rank runs past an incomplete file.  Every rank must
    call it: ZeRO-1 moments (``parallel/zero.py``), of which each rank
    holds a slice, and model shards (``parallel/mesh.py``) are first
    gathered, collectives.  The file equals a one-process save and
    restores under any process count and any grid."""
    from eadgan_tpu_torch.parallel.mesh import gathering
    from eadgan_tpu_torch.train.checkpoint import save_checkpoint, train_state_payload

    with gathering():
        payload = train_state_payload(state)
    if is_coordinator():
        save_checkpoint(path, payload)
    sync()
