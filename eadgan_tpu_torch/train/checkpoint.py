"""Checkpoints: the reference-contract model files and the train state.

PyTorch counterpart of ``eadgan_tpu/train/checkpoint.py``.  The port
writes its own ``torch.save`` format; it reads that and the JAX
package's flax msgpack files under the same names, told apart by
content (:func:`read_file`: a zip header is the port's, a msgpack map
the JAX package's, ``interop/flax_msgpack.py`` and ``jax_state.py``).
:func:`save_jax_model` and :func:`save_jax_train_state` write the JAX
package's format (no CLI flag does).  Two kinds of file:

* **model files** under the reference's names: the CelebA trainer's
  ``checkpoint_%d.tar`` (both models plus epoch/batches_done), and one
  model's ``state_dict`` (:func:`save_model` / :func:`restore_model`) for
  the dSprites trainers' ``encoder_pxy_%d.pt``,
  ``encoder_pxy_color_%d.pt``, ``encoder_%d.pt`` and ``generator_%d.pt``;
* **train-state files** (``<stem>_%d.ckpt``): one entry per field of the
  state that is not None (``train/state.py``): each model's state_dict
  (parameters, BatchNorm statistics, spectral-norm ``u``/``sigma``),
  each optimizer's state_dict (Adam moments and step counts), the step
  and the ``torch.Generator`` state, so a run resumes bit for bit.  A
  file loads only into a state with the same fields.

Writes are atomic: a temporary file in the same directory, fsynced, then
``os.replace``, then the directory fsynced so the rename survives a
power loss; a crash mid-write leaves the previous file intact.  On
restore, :func:`restore_latest` skips a newest file that does not load
(damaged on disk, or truncated by a writer older than the atomic one)
and falls back to the next.  ``EADGAN_FAULT_KILL_SAVE_STEP`` is the
drill of that recovery (:func:`_maybe_fault_kill_mid_write`).  In a
multi-process gang :func:`save_train_state_sync` is the collective save.
Every reader takes a path or a binary file object.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import sys
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from eadgan_tpu_torch.interop import flax_msgpack
from eadgan_tpu_torch.interop.jax_state import model_from_jax, model_to_jax, state_from_jax, state_to_jax
from eadgan_tpu_torch.parallel.mesh import (
    gather_optimizer_state,
    gathered_state_dict,
    has_model_shards,
    model_shards,
)
from eadgan_tpu_torch.utils import trace

__all__ = [
    "save_checkpoint",
    "read_file",
    "load_model_file",
    "load_celeba_checkpoint",
    "save_model",
    "restore_model",
    "save_jax_model",
    "save_jax_train_state",
    "write_jax_tree",
    "cpu_state_dict",
    "save_train_state",
    "restore_train_state",
    "train_state_payload",
    "jax_train_state",
    "restore_latest",
    "saved_steps",
    "latest_step",
    "prune_saved",
    "save_train_state_sync",
]

def cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every tensor detached and on the CPU,
    so the file loads on any machine.  The weights of a model sharded
    over a model axis are gathered whole (``parallel.mesh.gathering``:
    a collective every rank must enter; outside it, this raises)."""
    return {k: v.detach().cpu() for k, v in gathered_state_dict(model).items()}


def _maybe_fault_kill_mid_write(path: str, obj: Any) -> None:
    """The crash-recovery drill's hook, after the JAX package's: with
    ``EADGAN_FAULT_KILL_SAVE_STEP=N`` set, a save of a train-state file
    ``<stem>_M.ckpt`` with ``M >= N`` writes the first half of its bytes
    straight to the final path, as a writer killed mid-write without the
    atomic rename would leave it, and exits with the watchdog's stall
    code 87 for ``cli.supervise`` to relaunch.  One-shot: with
    ``EADGAN_FAULT_KILL_SAVE_MARKER=<path>`` it creates that file, and a
    process that finds it already there saves normally.  Unset, it costs
    one environment lookup."""
    step_env = os.environ.get("EADGAN_FAULT_KILL_SAVE_STEP", "")
    if not step_env:
        return
    m = re.search(r"_(\d+)\.ckpt$", path)
    if not m or int(m.group(1)) < int(step_env):
        return
    marker = os.environ.get("EADGAN_FAULT_KILL_SAVE_MARKER", "")
    if marker and os.path.exists(marker):
        return
    if marker:
        open(marker, "w").close()
    buf = io.BytesIO()
    torch.save(obj, buf)
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data[: max(1, len(data) // 2)])
        f.flush()
        os.fsync(f.fileno())
    print(f"fault injection: truncated mid-write of {path}, exiting 87", flush=True)
    os._exit(87)  # utils.watchdog.STALL_EXIT_CODE


def save_checkpoint(path: str, obj: Any) -> None:
    """``torch.save(obj)`` to ``path`` atomically, then the directory
    fsynced (where the file system allows it).  Traced as a
    ``checkpoint.save`` span (``utils/trace.py``)."""
    with trace.span("checkpoint.save"):
        _save(path, obj)


def _save(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _maybe_fault_kill_mid_write(path, obj)
    _atomic_write(path, lambda f: torch.save(obj, f))


def _atomic_write(path: str, write) -> None:
    """``write(f)`` into a temporary file beside ``path``, fsynced, renamed
    over ``path``; then the directory fsynced.  Each file counts one
    ``checkpoint.saves`` and its size in ``checkpoint.bytes``."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write(f)
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        os.replace(tmp, path)
        trace.count("checkpoint.saves")
        trace.count("checkpoint.bytes", size)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    try:
        dfd = os.open(directory, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def _cpu(obj):
    """Every tensor in a nested dict/list moved to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def read_file(source) -> Tuple[str, Any]:
    """A checkpoint file (a path or a binary file object) as
    ``("flax", tree)`` when it starts with a msgpack map (the JAX
    package's format, decoded by ``interop/flax_msgpack.py``), else
    ``("torch", object)`` from ``torch.load`` (the port's zip, starting
    ``PK\\x03\\x04``).  Damaged files raise."""
    if isinstance(source, (str, os.PathLike)):
        with open(source, "rb") as f:
            return read_file(f)
    start = source.tell()
    head = source.read(4)
    source.seek(start)
    if not flax_msgpack.is_flax_msgpack(head):
        return "torch", torch.load(source, map_location="cpu", weights_only=True)
    if isinstance(source, io.BytesIO):  # decode in place: no copy of the buffer
        return "flax", flax_msgpack.unpackb(source.getbuffer()[start:])
    return "flax", flax_msgpack.unpackb(source.read())


def load_model_file(source, model: nn.Module) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` a model file of either format holds for
    ``model`` (not loaded into it)."""
    kind, obj = read_file(source)
    return model_from_jax(obj, model) if kind == "flax" else obj


def load_celeba_checkpoint(source, parts=("generator", "discriminator")) -> Dict[str, Any]:
    """A ``checkpoint_%d.tar`` of either format in the port's layout:
    ``{"<part>_state_dict": state_dict, "epoch", "batches_done"}``.  Of a
    JAX file only ``parts`` are read, as the JAX ``gen_imgs`` reads only
    the generator's subtree."""
    kind, obj = read_file(source)
    if kind == "torch":
        return obj
    from eadgan_tpu_torch.models import CelebaDiscriminator, CelebaGenerator

    if not isinstance(obj, dict) or "generator_state_dict" not in obj:
        raise ValueError("not a CelebA checkpoint_%d.tar (no generator_state_dict)")
    out = {"epoch": int(obj.get("epoch", 0)), "batches_done": int(obj.get("batches_done", 0))}
    for part in parts:
        model = (CelebaGenerator if part == "generator" else CelebaDiscriminator)()
        key = f"{part}_state_dict"
        out[key] = model_from_jax(obj[key], model, where=f"{key}/")
    return out


def save_model(path: str, model: nn.Module) -> None:
    """Save one model's ``state_dict`` to ``path`` atomically."""
    save_checkpoint(path, cpu_state_dict(model))


def restore_model(path, model: nn.Module) -> nn.Module:
    """Load a model file of either format into ``model`` (strict) in
    place; returns it."""
    model.load_state_dict(load_model_file(path, model))
    return model


def save_jax_model(path: str, obj) -> int:
    """Write a model file in the JAX package's format atomically:
    ``obj`` is a model (its ``{"params", "stats"}``) or a dict whose
    model values become such trees, others kept (the CelebA
    ``checkpoint_%d.tar``: both models, ``epoch``, ``batches_done``).
    Returns the bytes written."""
    if isinstance(obj, nn.Module):
        tree = model_to_jax(obj, cpu_state_dict(obj))
    else:
        tree = {k: model_to_jax(v, cpu_state_dict(v)) if isinstance(v, nn.Module) else v
                for k, v in obj.items()}
    return write_jax_tree(path, tree)


def write_jax_tree(path: str, tree) -> int:
    """Pack a JAX state-dict tree (``interop/flax_msgpack.py``) into
    ``path`` atomically; returns the bytes written."""
    sizes = []
    _atomic_write(path, lambda f: sizes.append(flax_msgpack.pack_into(f, tree)))
    return sizes[0]


def _is_optimizer(value) -> bool:
    from eadgan_tpu_torch.parallel.zero import ZeroAdam

    return isinstance(value, (torch.optim.Optimizer, ZeroAdam))


def _fields(state) -> Dict[str, Any]:
    """The state's fields that are not None, by name."""
    return {
        f.name: getattr(state, f.name)
        for f in dataclasses.fields(state)
        if getattr(state, f.name) is not None
    }


def train_state_payload(state) -> Dict[str, Any]:
    """What a train-state file holds: each field of ``state`` copied to
    the host (models' and optimizers' state_dicts on the CPU, the
    generator's state, the step).  On the card the copies run on the
    current stream, after the work already issued there.  A ZeRO
    optimizer (``parallel/zero.py``) gives its state gathered over the
    data axis, and model shards (weights and their moments) are
    gathered whole, so the file is that of a one-rank run; with shards
    or slices, only inside ``gathering()`` on every rank."""
    out = {}
    shards = model_shards(state)
    for name, value in _fields(state).items():
        if isinstance(value, nn.Module):
            out[name] = cpu_state_dict(value)
        elif _is_optimizer(value):
            params = [p for group in value.param_groups for p in group["params"]]
            out[name] = _cpu(gather_optimizer_state(value.state_dict(), params, shards))
        elif isinstance(value, torch.Generator):
            out[name] = value.get_state()
        else:
            out[name] = int(value)  # the step
    return out


def _load_optimizer(opt: torch.optim.Optimizer, saved: Dict[str, Any]) -> None:
    """``opt.load_state_dict(saved)``, keeping ``opt``'s own ``capturable``
    setting: ``load_state_dict`` takes the saved groups' settings, so a
    file written on the card (capturable Adam, the step count on the
    card) would otherwise leave a CPU optimizer capturable, and a CPU
    file a card optimizer unfit for graph replay.  The step counts go
    where each group wants them: on its parameters' device as float32
    when capturable, on the CPU otherwise."""
    capturable = [group.get("capturable", False) for group in opt.param_groups]
    opt.load_state_dict(saved)
    for group, keep in zip(opt.param_groups, capturable):
        group["capturable"] = keep
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "step" in st:
                st["step"] = st["step"].to(torch.float32).to(p.device if keep else "cpu")


def _apply(state, payload: Dict[str, Any]):
    """Load a train-state payload into ``state`` in place; returns it.
    A file holds the one-rank layout, so a model-sharded state is
    refused: restore into the full state, then re-cut it
    (``replicate``, ``shard_model_params``, ``zero_place``)."""
    if has_model_shards(state):
        raise ValueError("a train-state file restores into an unsharded state; shard it after "
                         "(parallel.shard_model_params)")
    for name, value in _fields(state).items():
        if isinstance(value, nn.Module):
            value.load_state_dict(payload[name])
        elif isinstance(value, torch.optim.Optimizer):
            _load_optimizer(value, payload[name])
        elif _is_optimizer(value):
            value.load_state_dict(payload[name])  # ZeRO: this rank's slices
        elif isinstance(value, torch.Generator):
            value.set_state(payload[name])
        else:
            setattr(state, name, int(payload[name]))
    return state


def _load(source, state) -> Dict[str, Any]:
    kind, payload = read_file(source)
    if kind == "flax":
        return state_from_jax(payload, state)
    if not isinstance(payload, dict) or set(payload) != set(_fields(state)):
        raise ValueError(f"{source} is not a train-state file of this state's fields")
    return payload


def restore_train_state(source, state):
    """Load a train-state file of either format (a path or a binary file
    object) into ``state`` (built by the trainer's init for the same
    configuration) in place; returns it."""
    return _apply(state, _load(source, state))


def jax_train_state(state) -> dict:
    """``state`` as the JAX package's train-state tree
    (``interop/jax_state.py``); with model shards or ZeRO slices, only
    inside ``gathering()`` on every rank."""
    return state_to_jax(state, train_state_payload(state))


def saved_steps(directory: str, prefix: str, suffix: str = ".ckpt") -> List[int]:
    """All saved steps of ``<prefix>_%d<suffix>`` files, newest first."""
    steps = []
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith(prefix + "_") and name.endswith(suffix):
                middle = name[len(prefix) + 1 : -len(suffix)]
                if middle.isdigit():
                    steps.append(int(middle))
    return sorted(steps, reverse=True)


def latest_step(directory: str, prefix: str, suffix: str = ".ckpt") -> int:
    """The newest saved step of ``<prefix>_%d<suffix>`` files; -1 if none."""
    steps = saved_steps(directory, prefix, suffix)
    return steps[0] if steps else -1


def prune_saved(
    directory: str,
    prefix: str,
    keep: int,
    suffix: str = ".ckpt",
    current_step: Optional[int] = None,
) -> List[str]:
    """Delete all but the ``keep`` newest ``<prefix>_%d<suffix>`` files;
    ``keep < 1`` keeps every saved file.  Returns the removed paths.

    ``current_step`` (what :func:`save_train_state` passes) anchors
    "newest" to the step just written: after a fallback resume past a
    damaged newest file, files above ``current_step`` belong to the
    abandoned timeline and go first, and the retained set is the ``keep``
    newest at or below it.  Temporary files of this prefix left by a
    writer that no longer runs (``<prefix>_N<suffix>.tmp.<pid>``) are
    swept in the same pass, whatever ``keep`` is.  Files that vanish
    meanwhile are tolerated."""
    steps = saved_steps(directory, prefix, suffix) if keep >= 1 else []
    if current_step is not None:
        retained = [s for s in steps if s <= current_step][:keep]
    else:
        retained = steps[:keep]
    removed = []
    for step in steps:
        if step in retained:
            continue
        path = os.path.join(directory, f"{prefix}_{step}{suffix}")
        try:
            os.unlink(path)
            removed.append(path)
        except OSError:
            pass
    orphan = re.compile(re.escape(prefix) + r"_\d+" + re.escape(suffix) + r"\.tmp\.(\d+)$")
    for name in os.listdir(directory) if os.path.isdir(directory) else []:
        m = orphan.match(name)
        if not m:
            continue
        try:
            os.kill(int(m.group(1)), 0)
            continue  # its writer still runs
        except ProcessLookupError:
            pass
        except OSError:
            continue  # e.g. EPERM: a live process has that pid
        try:
            os.unlink(os.path.join(directory, name))
            removed.append(os.path.join(directory, name))
        except OSError:
            pass
    return removed


def save_train_state(ckpt_dir: str, stem: str, step: int, state, keep: int = 0) -> str:
    """Save ``state`` as ``<stem>_<step>.ckpt`` atomically, then keep the
    ``keep`` newest such files (``keep=0``: all).  The trainers'
    ``--keep_states`` flag routes here."""
    path = os.path.join(ckpt_dir, f"{stem}_{step}.ckpt")
    with trace.span("checkpoint.save"):
        _save(path, train_state_payload(state))
        prune_saved(ckpt_dir, stem, keep, current_step=step)
    return path


def save_jax_train_state(ckpt_dir: str, stem: str, step: int, state, keep: int = 0) -> str:
    """:func:`save_train_state` in the JAX package's format: the file
    ``eadgan_tpu.train.checkpoint.save_train_state`` would write for the
    same state (the key as ``interop/jax_state.py`` states it)."""
    path = os.path.join(ckpt_dir, f"{stem}_{step}.ckpt")
    write_jax_tree(path, jax_train_state(state))
    prune_saved(ckpt_dir, stem, keep, current_step=step)
    return path


def save_train_state_sync(ckpt_dir: str, stem: str, step: int, state, keep: int = 0) -> str:
    """:func:`save_train_state` for a multi-process gang: every rank must
    call it, as the engine's ``on_shutdown`` does on every rank.  ZeRO
    moments are gathered (a collective), rank 0 writes and prunes, and a
    barrier holds the other ranks until the file is complete
    (``parallel.save_on_coordinator``); the file equals a one-process
    save.  In one process it is :func:`save_train_state`.  Cadence saves
    from ``on_batch`` keep :func:`save_train_state`: the engine runs
    ``on_batch`` on rank 0 alone, where a collective would wait forever."""
    from eadgan_tpu_torch.parallel.multihost import is_coordinator, process_count, save_on_coordinator

    if process_count() <= 1:
        return save_train_state(ckpt_dir, stem, step, state, keep=keep)
    path = os.path.join(ckpt_dir, f"{stem}_{step}.ckpt")
    save_on_coordinator(path, state)
    if is_coordinator():
        prune_saved(ckpt_dir, stem, keep, current_step=step)
    return path


def restore_latest(directory: str, prefix: str, state, suffix: str = ".ckpt") -> Tuple[Any, int]:
    """Restore the newest *loadable* ``<prefix>_%d<suffix>`` file into
    ``state``.  A file that fails to load is skipped with a warning and
    the next-newest is tried.  Returns ``(state, step)``, with step -1
    (and ``state`` untouched) when no file loads."""
    for step in saved_steps(directory, prefix, suffix):
        path = os.path.join(directory, f"{prefix}_{step}{suffix}")
        try:
            payload = _load(path, state)
        except Exception as exc:  # noqa: BLE001 — any failure to read the file
            print(
                f"warning: checkpoint {path} failed to load ({exc!r}); "
                "falling back to the previous checkpoint",
                file=sys.stderr,
                flush=True,
            )
            continue
        return _apply(state, payload), step
    return state, -1
