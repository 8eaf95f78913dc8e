"""Data-parallel and multi-process training.

PyTorch counterpart of ``eadgan_tpu/parallel``: the ``data`` axis
(``mesh.py``: replicated state, batches sliced by rank, gradients,
BatchNorm statistics and metrics averaged over the ranks), process
bootstrap and the gang's host-side collectives (``multihost.py``), and
ZeRO-1 (``zero.py``).  A JAX device on the ``data`` axis is a torch rank
here, one process per card.  The ``model`` axis is not ported.
"""

from eadgan_tpu_torch.parallel.mesh import (
    data_axis,
    data_parallel_step,
    global_mean,
    local_rows,
    replicate,
    shard_batch,
    shard_window,
)
from eadgan_tpu_torch.parallel.multihost import (
    any_process_flag,
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
    "global_mean",
    "host_barrier",
    "host_batch_slice",
    "initialize",
    "is_coordinator",
    "join_local",
    "local_rows",
    "replicate",
    "save_on_coordinator",
    "shard_batch",
    "shard_window",
    "sync",
    "ZeroAdam",
    "zero_place",
    "zero_spec",
]
