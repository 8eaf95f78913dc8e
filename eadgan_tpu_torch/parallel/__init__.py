"""Data-parallel, tensor-parallel and multi-process training.

PyTorch counterpart of ``eadgan_tpu/parallel``.  A JAX device is a torch
rank here, one process per card, and the ranks form the JAX package's
(data, model) grid (``multihost.default_mesh``: rank ``r`` at data
``r // M``, model ``r % M``, a process group for each row and column):

* the ``data`` axis (``mesh.py``), over the grid's data group: batches
  sliced by data index, gradients, BatchNorm statistics and metrics
  averaged over it;
* the ``model`` axis (``mesh.py``): the large layers' weights cut on
  their output features (``shard_model_params``, the JAX rule) and run
  column-parallel (``models/layers.py``), their collectives in
  hand-written autograd functions;
* process bootstrap and the gang's host-side collectives
  (``multihost.py``: ``initialize``, the gang stop, the collective save
  whose file holds the one-rank layout and restores under any grid);
* ZeRO-1 (``zero.py``), composed with the model shard.

A step on a grid computes what one rank computes on the global batch.
"""

from eadgan_tpu_torch.parallel.mesh import (
    data_axis,
    data_parallel_step,
    global_mean,
    local_rows,
    replicate,
    shard_batch,
    shard_model_params,
    shard_window,
    state_shardings,
)
from eadgan_tpu_torch.parallel.multihost import (
    Mesh,
    any_process_flag,
    default_mesh,
    host_barrier,
    host_batch_slice,
    initialize,
    is_coordinator,
    join_local,
    save_on_coordinator,
    sync,
)
from eadgan_tpu_torch.parallel.zero import ZeroAdam, zero_place, zero_spec

__all__ = [
    "any_process_flag",
    "data_axis",
    "data_parallel_step",
    "default_mesh",
    "global_mean",
    "host_barrier",
    "host_batch_slice",
    "initialize",
    "is_coordinator",
    "join_local",
    "local_rows",
    "Mesh",
    "replicate",
    "save_on_coordinator",
    "shard_batch",
    "shard_model_params",
    "shard_window",
    "state_shardings",
    "sync",
    "ZeroAdam",
    "zero_place",
    "zero_spec",
]
