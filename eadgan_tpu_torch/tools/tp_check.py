"""The CelebA step on a (data, model) grid of rank processes against one
rank.

``python -m eadgan_tpu_torch.tools.tp_check --grid D M [--zero_opt]
[--batch 128] [--steps 4] [--device cuda|cpu]
[--save_at S --resume_grid D2 M2]``
is the port's counterpart of ``tools/multiprocess_drive.py``'s
``celeba2d`` pipeline and ``run_steps``.  From one seeded float32 CelebA
state at its published widths (``init_celeba_gan_state(seed=0)``) and
seeded images and draws at the global batch ``--batch``, it runs:

1. one rank in this process, ``--steps`` steps (the reference);
2. ``D * M`` rank processes (``--rank``, this module again), joined over
   a localhost ``tcp://`` coordinator: gloo on the CPU or when the ranks
   share a card (more ranks than cards), NCCL across cards.  Each lays
   the ranks out with ``parallel.default_mesh(M)``, cuts the state
   (``replicate``, ``shard_model_params``, with ``--zero_opt``
   ``zero_place``) and runs the steps per step through
   ``parallel.data_parallel_step(step, mesh)`` (gloo cannot be captured
   in a CUDA graph), saving the train state collectively after step 0
   and, with ``--save_at S``, after step S - 1;
3. with ``--resume_grid``, ``D2 * M2`` more ranks restore that file into
   a full state, re-cut it for their grid, save it again before any step
   (which must equal the file bit for bit) and run the steps after S,
   held against the writer's own.

It checks the bars of the JAX package's 2-D test
(``tests/test_parallel.py::test_celeba_step_2d_mesh``) against the one
rank: losses rtol 2e-4 / atol 1e-5 at step 0, rtol 1e-3 at step 1 and
1e-2 after (atol 1e-4); G's and D's parameters after step 0 within 2.1
Adam steps (a step's sign flipped on a near-zero gradient), fewer than
0.5% of elements beyond half a step, where a step is the sum of the
rates of the optimizers that move the model in one train step (G:
``opt_g`` and ``opt_info``: the JAX test writes its bound with ``g_lr``
alone, which the port's data axis alone exceeds at a global batch of 32
by a flip under both); D's numbers by the same rule are reported, not
held, as the JAX test holds G alone (for each, the elements beyond
half a step whose gradient changed sign between the runs, and how large
those gradients are against their tensor's largest); every rank's losses
equal, and every tensor no model shard cuts (parameters, buffers, Adam
moments) bit-equal on the ranks that hold it; a resumed grid's steps at
the step-0 bar against the writer's.  And it reports, by rank, the warp's
launches, the bytes of parameters and of Adam moments each holds, and
the model-axis collectives each step issues, by function
(``parallel.mesh.model_collectives``: the gathered bytes of layer
outputs, the all-reduced bytes of input gradients and spectral norm's
sums, the broadcast bytes of replicated gradients).  TF32 off, cuDNN deterministic.  Prints one JSON line; exits
non-zero when a rank fails or a bar is missed.
"""

from __future__ import annotations

import argparse
import copy
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from eadgan_tpu_torch.ops import stn_cuda
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

__all__ = ["LOSS_BARS", "inputs", "run_tp_check", "main"]

# (rtol, atol) of the grid's losses against one rank, by step (the last
# holds for every later step)
LOSS_BARS = ((2e-4, 1e-5), (1e-3, 1e-4), (1e-2, 1e-4))
PARAM_BOUND, PARAM_SHARE = 2.1, 0.005  # Adam steps; share beyond half a step
# the optimizers that move each model in a step: a first Adam step moves
# an element by at most its rate, so "a step" is the sum of their rates
RATES = {"g": ("g_lr", "info_lr"), "d": ("d_lr", "info_lr")}
# the checkout's root: rank processes import this package from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def inputs(batch: int, steps: int, seed: int = 0):
    """Seeded images (``batch``, 64, 64, 3) in [-1, 1] and ``steps``
    draws at the global batch, as the parity tests make them."""
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(-1, 1, (batch, 64, 64, 3)).astype(np.float32)
    draws = [{"z": rng.standard_normal((batch, 200)).astype(np.float32),
              "sampled_labels": rng.integers(0, 10, batch).astype(np.int64),
              "code": rng.uniform(-1, 1, (batch, 8)).astype(np.float32)} for _ in range(steps)]
    return imgs, draws


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _losses(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _local_bytes(state) -> dict:
    """Bytes of the parameters and of the Adam moments this rank holds."""
    params = sum(p.numel() * p.element_size() for m in (state.g, state.d) for p in m.parameters())
    moments = 0
    for name in ("opt_g", "opt_d", "opt_info"):
        opt = getattr(state, name)
        st = opt.inner.state if hasattr(opt, "inner") else opt.state
        moments += sum(v.numel() * v.element_size() for s in st.values() for v in s.values()
                       if torch.is_tensor(v) and v.dim())
    return {"params": params, "moments": moments}


def _replica_digests(state) -> dict:
    """``{name: [axes, sha256]}`` of each tensor of ``state`` that no
    model shard cuts (``axes``: ``["data"]`` for a ZeRO slice, else
    empty): the bits every rank holding the same part must share."""
    from eadgan_tpu_torch.parallel.mesh import placed_tensors

    out = {}
    for name, place, t in placed_tensors(state):
        axes = sorted({axis for axis, _ in place})
        if "model" not in axes:
            raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy()
            out[name] = [axes, hashlib.sha256(raw.tobytes()).hexdigest()]
    return out


# --- a rank ----------------------------------------------------------------------


def _rank_main(opt) -> None:
    """One rank of a grid: join, cut the state, step, save, report."""
    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.cli.common import disable_tf32
    from eadgan_tpu_torch.parallel.mesh import model_collectives, reset_model_collectives
    from eadgan_tpu_torch.train.checkpoint import restore_train_state

    if opt.world == 1:  # a group of one: initialize joins none
        device = parallel.join_local(opt.device)
    else:
        device = parallel.initialize(f"localhost:{opt.port}", opt.world, opt.rank, device=opt.device)
    parallel.host_barrier("tp_check start")  # on the store: the ranks' starts may be far apart
    disable_tf32()
    torch.backends.cudnn.deterministic = True
    mesh = parallel.default_mesh(opt.grid[1])
    config = CelebaConfig(batch_size=opt.batch // mesh.data)
    state = init_celeba_gan_state(config, device=device, seed=0)
    first = 0
    if opt.restore:
        restore_train_state(opt.restore, state)
        first = state.step
    parallel.replicate(state)
    parallel.shard_model_params(mesh, state)
    if opt.zero_opt:
        parallel.zero_place(state, mesh)
    if opt.restore:  # the re-cut state, gathered again: must be the file
        parallel.save_on_coordinator(os.path.join(opt.work, "recut.ckpt"), state)
    imgs, draws = inputs(opt.batch, first + opt.steps)
    rows = parallel.host_batch_slice(opt.batch, mesh)
    local = torch.from_numpy(np.ascontiguousarray(imgs[rows])).to(device)
    step = parallel.data_parallel_step(make_celeba_gan_step(config), mesh)
    stn_cuda.reset_launch_count()
    report = {"rank": opt.rank, "mesh": [mesh.data, mesh.model, mesh.data_index, mesh.model_index],
              "backend": parallel.multihost.backend(), "bytes": _local_bytes(state),
              "losses": [], "model_collectives": [], "step_s": []}
    for i in range(first, first + opt.steps):
        reset_model_collectives()
        t0 = time.perf_counter()
        state, metrics = step(state, local, draws[i])
        report["losses"].append(_losses(metrics))  # a host copy: the step has ended
        report["step_s"].append(time.perf_counter() - t0)
        report["model_collectives"].append(model_collectives())
        if i == 0:
            parallel.save_on_coordinator(os.path.join(opt.work, "step0.ckpt"), state)
            report["bytes"] = _local_bytes(state)  # with the moments the first step made
        if opt.save_at and i == opt.save_at - 1:
            parallel.save_on_coordinator(os.path.join(opt.work, f"step{opt.save_at}.ckpt"), state)
    report["warp_launches"] = stn_cuda.launch_count
    report["replicas"] = _replica_digests(state)
    with open(os.path.join(opt.work, f"rank{opt.rank}.json"), "w") as f:
        json.dump(report, f)
    parallel.sync()


# --- the parent ----------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _gang(grid, work: str, argv, device: str, timeout_s: float) -> list:
    """Run ``grid[0] * grid[1]`` rank processes of this module; returns
    their reports by rank.  A rank that exits non-zero, or outlives
    ``timeout_s``, fails the run (every rank is killed first)."""
    world = grid[0] * grid[1]
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ)
    for name in ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR"):
        env.pop(name, None)
    if device == "cuda" and world > torch.cuda.device_count():
        env["EADGAN_DIST_BACKEND"] = "gloo"  # ranks that share a card
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "eadgan_tpu_torch.tools.tp_check", "--rank", str(r), "--world",
         str(world), "--port", port, "--work", work, "--grid", *map(str, grid), "--device", device,
         *argv], env=env, cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, outs[r][1][-3000:]) for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"tp_check: ranks failed {bad}")
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _one_rank(config, device, imgs, draws):
    """The reference: one rank, every step of ``draws``; returns (losses,
    the state's payload after step 0, its bytes after the run)."""
    from eadgan_tpu_torch.train.checkpoint import train_state_payload

    state = init_celeba_gan_state(config, device=device, seed=0)
    step = make_celeba_gan_step(config)
    x = torch.from_numpy(imgs).to(device)
    losses, after0 = [], None
    for fixed in draws:
        state, metrics = step(state, x, fixed)
        losses.append(_losses(metrics))
        if after0 is None:  # a copy: on the CPU the payload's tensors are the state's own
            after0 = copy.deepcopy(train_state_payload(state))
    return losses, after0, _local_bytes(state)


def _replicas_agree(ranks) -> dict:
    """Every tensor that no model shard cuts, bit-equal on all ranks (a
    ZeRO slice: on the ranks of one data index, a model group)."""
    bad = set()
    for a in ranks:
        for b in ranks[a["rank"] + 1 :]:
            same_rows = a["mesh"][2] == b["mesh"][2]
            for name, (axes, digest) in a["replicas"].items():
                if (same_rows or "data" not in axes) and b["replicas"][name][1] != digest:
                    bad.add(name)
    return {"tensors": len(ranks[0]["replicas"]), "mismatched": sorted(bad)[:20], "ok": not bad}


def _loss_check(ref, got, bars=LOSS_BARS) -> dict:
    rel, ok = [], len(ref) == len(got)
    for s, (a, b) in enumerate(zip(ref, got)):
        rtol, atol = bars[min(s, len(bars) - 1)]
        rel.append(max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-12) for k in a))
        ok &= all(np.isfinite(b[k]) and abs(b[k] - a[k]) <= atol + rtol * abs(a[k]) for k in a)
    return {"rel_diff_by_step": rel, "ok": bool(ok)}


_BUFFERS = ("running_mean", "running_var", "num_batches_tracked", ".u", ".sigma")


def _first_moments(payload: dict, model: str) -> dict:
    """Each parameter of ``model`` ("g" or "d") of a train-state payload
    after one step, by name: the first Adam moments (``exp_avg``, 1 - b1
    times the step's gradient) of the optimizers that moved it, its own
    and ``opt_info`` (over G's parameters, then D's)."""
    names = [n for n in payload[model] if not n.endswith(_BUFFERS)]
    offset = 0 if model == "g" else sum(not n.endswith(_BUFFERS) for n in payload["g"])
    own, info = payload[f"opt_{model}"]["state"], payload["opt_info"]["state"]
    return {n: [st["exp_avg"] for st in (own.get(i), info.get(offset + i)) if st]
            for i, n in enumerate(names)}


def _param_check(config, ref: dict, got: dict) -> dict:
    """G's and D's parameters after step 0, grid (``got``, a gathered
    file's payload) against one rank: the JAX 2-D test's bar (``held``
    for G, as there).  A first Adam step moves an element by its rate
    times g / (|g| + eps), so an element lands beyond half a step when a
    gradient's sign differs between the two runs.  ``sign_flipped``
    counts those among the elements beyond, by optimizer (the model's
    own, then ``opt_info``, which steps after it and so sees its moves),
    and ``flipped_grad_rel`` is, by optimizer, the largest such gradient
    over its tensor's largest (rounding noise in a gradient that cancels
    is far below 1; a gradient that is zero but for rounding reads 1)."""
    out = {}
    for model, names in RATES.items():
        lr = sum(getattr(config, n) for n in names)
        moments_ref, moments_got = _first_moments(ref, model), _first_moments(got, model)
        by_name, beyond, total = {}, 0, 0
        either, flipped, rel_max = 0, [0, 0], [0.0, 0.0]
        for name, a in ref[model].items():
            if name.endswith(_BUFFERS):
                continue
            diff = (a.double() - got[model][name].double()).abs()
            far = diff > 0.5 * lr
            any_flip = torch.zeros_like(far)
            for k, (m_ref, m_got) in enumerate(zip(moments_ref[name], moments_got[name])):
                flip = far & (torch.sign(m_ref) != torch.sign(m_got))
                any_flip |= flip
                if flip.any():
                    flipped[k] += int(flip.sum())
                    scale = m_ref.abs().max().double().clamp_min(1e-30)
                    rel_max[k] = max(rel_max[k], (m_ref.abs().double()[flip] / scale).max().item())
            n_far, n_flip = int(far.sum()), int(any_flip.sum())
            by_name[name] = (diff.max().item(), n_far, n_flip, diff.numel())
            beyond, either, total = beyond + n_far, either + n_flip, total + diff.numel()
        worst = max(v[0] for v in by_name.values())
        out[model] = {"max_abs": worst, "bound": PARAM_BOUND * lr, "beyond_half_step": beyond,
                      "share_beyond_half_step": beyond / total,
                      "sign_flipped": {"any": either, "own": flipped[0], "opt_info": flipped[1]},
                      "flipped_grad_rel": {"own": rel_max[0], "opt_info": rel_max[1]},
                      "by_tensor": sorted(([n, *v] for n, v in by_name.items() if v[1]),
                                          key=lambda r: -r[2])[:6],
                      "held": model == "g",
                      "ok": worst <= PARAM_BOUND * lr and beyond / total < PARAM_SHARE}
    return out


def run_tp_check(grid=(1, 2), zero_opt: bool = False, batch: int = 128, steps: int = 4,
                 device: str = "cuda", save_at: int = 0, resume_grid=None,
                 timeout_s: float = 600) -> dict:
    """The reference, the grid, and (``resume_grid``) the resumed grid;
    returns the report (see the module docstring)."""
    if resume_grid and not save_at:
        raise ValueError("--resume_grid resumes the --save_at file")
    from eadgan_tpu_torch.cli.common import disable_tf32
    from eadgan_tpu_torch.tools.chain_check import _cudnn_deterministic
    from eadgan_tpu_torch.tools.dp_check import _equal

    disable_tf32()
    config = CelebaConfig(batch_size=batch)
    imgs, draws = inputs(batch, steps)
    report = {"tp_check": "celeba", "grid": list(grid), "zero_opt": zero_opt, "batch": batch,
              "steps": steps, "compute": "f32", "device": device}
    t0 = time.perf_counter()
    with _cudnn_deterministic():
        one, one_after0, one_bytes = _one_rank(config, torch.device(device), imgs, draws)
    report["one_rank_s"] = time.perf_counter() - t0

    def args(n_steps, *more):
        return ["--batch", str(batch), "--steps", str(n_steps), *more]

    with tempfile.TemporaryDirectory(prefix="eadgan_tp_") as work:
        t0 = time.perf_counter()
        ranks = _gang(grid, os.path.join(work, "grid"),
                      args(steps, "--save_at", str(save_at), *(["--zero_opt"] if zero_opt else [])),
                      device, timeout_s)
        report["gang_wall_s"] = time.perf_counter() - t0
        got = ranks[0]["losses"]
        report.update({
            "backend": ranks[0]["backend"],
            "losses": {"one_rank": one, "grid": got},
            "loss_bars": [list(b) for b in LOSS_BARS],
            "vs_one_rank": _loss_check(one, got),
            "ranks_agree": all(r["losses"] == got for r in ranks),
            "replicas_agree": _replicas_agree(ranks),
            "params_step0": _param_check(config, one_after0,
                                         _load(os.path.join(work, "grid", "step0.ckpt"))),
            "warp_launches_by_rank": {r["rank"]: r["warp_launches"] for r in ranks},
            "bytes_by_rank": {r["rank"]: r["bytes"] for r in ranks},
            "one_rank_bytes": one_bytes,
            "model_collectives_by_step": ranks[0]["model_collectives"],
            "grid_step_s": ranks[0]["step_s"],
        })
        ok = (report["vs_one_rank"]["ok"] and report["ranks_agree"]
              and report["replicas_agree"]["ok"] and all(v["ok"] for v in report["params_step0"].values() if v["held"]))
        if resume_grid:
            path = os.path.join(work, "grid", f"step{save_at}.ckpt")
            t0 = time.perf_counter()
            resumed = _gang(resume_grid, os.path.join(work, "resume"),
                            args(steps - save_at, "--restore", path), device, timeout_s)
            recut = _load(os.path.join(work, "resume", "recut.ckpt"))
            res = {"grid": list(resume_grid), "from_step": save_at,
                   "wall_s": time.perf_counter() - t0,
                   "recut_equals_file": _equal(recut, _load(path)),
                   "losses": resumed[0]["losses"], "writer_losses": got[save_at:],
                   "vs_writer": _loss_check(got[save_at:], resumed[0]["losses"], LOSS_BARS[:1]),
                   "ranks_agree": all(r["losses"] == resumed[0]["losses"] for r in resumed),
                   "replicas_agree": _replicas_agree(resumed),
                   "warp_launches_by_rank": {r["rank"]: r["warp_launches"] for r in resumed},
                   "bytes_by_rank": {r["rank"]: r["bytes"] for r in resumed}}
            report["resume"] = res
            ok &= (res["recut_equals_file"] and res["vs_writer"]["ok"] and res["ranks_agree"]
                   and res["replicas_agree"]["ok"])
    report["ok"] = bool(ok)
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--grid", type=int, nargs=2, default=[1, 2], metavar=("DATA", "MODEL"))
    parser.add_argument("--zero_opt", action="store_true")
    parser.add_argument("--batch", type=int, default=128, help="the global batch")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--save_at", type=int, default=0,
                        help="save collectively after this many steps (0: only after step 0)")
    parser.add_argument("--resume_grid", type=int, nargs=2, metavar=("DATA", "MODEL"))
    # a rank process's own arguments
    parser.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--port", help=argparse.SUPPRESS)
    parser.add_argument("--work", help=argparse.SUPPRESS)
    parser.add_argument("--restore", help=argparse.SUPPRESS)
    opt = parser.parse_args(argv)
    if opt.rank is not None:
        _rank_main(opt)
        return 0
    if opt.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device (--device cpu runs the check on the CPU)")
    report = run_tp_check(tuple(opt.grid), opt.zero_opt, opt.batch, opt.steps, opt.device,
                          opt.save_at, tuple(opt.resume_grid) if opt.resume_grid else None)
    print(json.dumps(report), flush=True)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
