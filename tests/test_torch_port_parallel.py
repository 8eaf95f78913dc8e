"""The port's ``parallel/`` in one process, against the JAX package's
``eadgan_tpu.parallel`` where both have the function, and the pieces of
data-parallel training a group of one can show:

* ``zero_spec`` picks the dimension the JAX rule shards;
* the single-process contract of ``initialize``, ``host_batch_slice``,
  ``is_coordinator`` and ``any_process_flag`` is the JAX one
  (``tests/test_parallel.py::test_multihost_single_process_contract``);
* under a world-1 gloo group ``TorchBatchNorm``, a data-parallel step
  and a ZeRO-1 step are bit-equal to the plain ones (a sum over one rank
  and a division by 1.0 are exact), and so is a whole chained
  ``run_epochs`` with ``data_parallel`` and ``zero_opt``;
* a ZeRO optimizer saves the full moments, which restore into a plain
  Adam;
* NCCL ranks that would share a card raise before they join, gloo ones
  may share it; incomplete rank environments raise;
* the CLIs' refusals: a multi-process run without ``--data_parallel``,
  ``--zero_opt`` in a multi-process run, ``--zero_opt`` without the
  chained engine;
* F1: an unset ``--compute`` is bf16 on the card and f32 on the CPU, and
  the pretrainers run f32 whatever it says.

Two-rank runs are in ``test_torch_port_multiprocess.py``.
"""

import argparse
import copy

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from eadgan_tpu.parallel import any_process_flag as jax_any_process_flag
from eadgan_tpu.parallel import host_batch_slice as jax_host_batch_slice
from eadgan_tpu.parallel import initialize as jax_initialize
from eadgan_tpu.parallel import is_coordinator as jax_is_coordinator
from eadgan_tpu.parallel import zero_spec as jax_zero_spec
from eadgan_tpu_torch import parallel
from eadgan_tpu_torch.cli.common import init_multiprocess, resolve_compute_dtype
from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
from eadgan_tpu_torch.models import TorchBatchNorm
from eadgan_tpu_torch.parallel import multihost
from eadgan_tpu_torch.train.checkpoint import restore_train_state, train_state_payload
from eadgan_tpu_torch.train.config import SpritesGanConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.gan_dsprites import init_sprites_gan_state, make_sprites_gan_step
from eadgan_tpu_torch.train.pretrain import pxy_encoder
from tests.test_torch_port_jax_files import drop_big_files

_RANK_ENV = ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
             "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MEGASCALE_COORDINATOR_ADDRESS",
             "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "EADGAN_DIST_BACKEND")


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.fixture(autouse=True)
def _no_rank_env(monkeypatch):
    for name in _RANK_ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def world1():
    """A gloo group of one process (``parallel.join_local``), destroyed
    after the test so no later test of the worker finds it."""
    assert not dist.is_initialized()
    device = parallel.join_local("cpu")
    yield device
    dist.destroy_process_group()


# --- zero_spec ----------------------------------------------------------------

SHAPES = [(), (7,), (1023,), (1024,), (4096,), (3, 3, 64, 128), (128, 64, 3, 3), (200, 8),
          (512, 1024, 4, 4), (6, 5, 7, 11), (10, 10, 10, 10), (1024, 3), (25, 41)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_zero_spec_matches_jax(shape, n):
    spec = tuple(jax_zero_spec(shape, n))
    want = spec.index("data") if "data" in spec else None
    assert parallel.zero_spec(shape, n) == want


# --- the single-process contract ------------------------------------------------


def test_multihost_single_process_contract(monkeypatch):
    """No cluster: ``initialize`` is a no-op (as JAX's), the host slice is
    the whole batch, this process is the coordinator and the stop flag is
    the local one; a simulated 8-rank job slices as JAX's does and both
    refuse a batch that does not divide."""
    jax_initialize()
    jax_initialize(num_processes=1)
    assert parallel.initialize(device="cpu") == torch.device("cpu")
    assert parallel.initialize(num_processes=1, device="cpu") == torch.device("cpu")
    assert not dist.is_initialized()

    for batch in (16, 3):
        jsl, sl = jax_host_batch_slice(batch), parallel.host_batch_slice(batch)
        assert (sl.start, sl.stop) == (jsl.start, jsl.stop) == (0, batch)
    assert parallel.is_coordinator() == jax_is_coordinator() is True
    for flag in (False, True):
        assert parallel.any_process_flag(flag) == jax_any_process_flag(flag) == flag
    parallel.sync()  # no-ops
    parallel.host_barrier()

    monkeypatch.setattr(jax, "process_count", lambda: 8)
    monkeypatch.setattr(jax, "process_index", lambda: 3)
    monkeypatch.setattr(multihost, "process_count", lambda: 8)
    monkeypatch.setattr(multihost, "process_index", lambda: 3)
    jsl, sl = jax_host_batch_slice(16), parallel.host_batch_slice(16)
    assert (sl.start, sl.stop) == (jsl.start, jsl.stop) == (6, 8)
    assert parallel.is_coordinator() == jax_is_coordinator() is False
    for bad in (jax_host_batch_slice, parallel.host_batch_slice):
        with pytest.raises(ValueError, match="not divisible"):
            bad(17)


@pytest.mark.parametrize("env,match", [
    ({"EADGAN_MP_NUM_PROCESSES": "2"}, "no coordinator"),
    ({"WORLD_SIZE": "4", "RANK": "1"}, "no coordinator"),
    ({"EADGAN_MP_COORDINATOR": "localhost:1"}, "without a world size"),
    ({"EADGAN_MP_COORDINATOR": "localhost:1", "EADGAN_MP_NUM_PROCESSES": "2"}, "without a world size"),
], ids=["mp_without_coordinator", "torchrun_without_master", "coordinator_alone", "no_rank"])
def test_incomplete_rank_environment_raises(env, match, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost.wants_gang()
    with pytest.raises(ValueError, match=match):
        parallel.initialize(device="cpu")
    assert not dist.is_initialized()


def test_rank_environment_reads_supervise_and_torchrun(monkeypatch):
    monkeypatch.setenv("EADGAN_MP_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("EADGAN_MP_NUM_PROCESSES", "2")
    monkeypatch.setenv("EADGAN_MP_PROCESS_ID", "1")
    assert multihost.rank_environment() == ("localhost:1234", 2, 1, 1)
    for name in ("EADGAN_MP_COORDINATOR", "EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.2")
    monkeypatch.setenv("MASTER_PORT", "29400")
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_RANK", "1")
    assert multihost.rank_environment() == ("10.0.0.2:29400", 8, 5, 1)


@pytest.mark.parametrize("backend", ["", "gloo"], ids=["nccl", "gloo"])
@pytest.mark.parametrize("local_rank,local_world", [(1, 2), (0, 2), (0, 1)])
def test_nccl_ranks_on_a_shared_card_raise(backend, local_rank, local_world, monkeypatch):
    """One card, two local ranks: under NCCL both raise before they join
    (rank 0 too, so it never waits for a peer that cannot come); gloo
    ranks share the card.  One rank of one is always fine."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    if backend:
        monkeypatch.setenv("EADGAN_DIST_BACKEND", backend)
    shares = local_world > 1
    if shares and not backend:
        with pytest.raises(RuntimeError, match="NCCL cannot run two ranks on one card"):
            multihost._card(torch.device("cuda"), local_rank, local_world)
    else:
        assert multihost._card(torch.device("cuda"), local_rank, local_world) == torch.device("cuda", 0)


# --- a group of one: bit-equal to no group ---------------------------------------


def test_batchnorm_world1_bit_equal_to_no_group(world1):
    torch.manual_seed(0)
    bn = TorchBatchNorm(8)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    x = torch.randn(4, 8, 5, 5) * 3 + 1
    runs = []
    for axis in (False, True):
        model = copy.deepcopy(bn)
        xi = x.clone().requires_grad_(True)
        with parallel.data_axis() if axis else torch.enable_grad():
            y = model(xi)
            (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
        runs.append([y.detach(), xi.grad, model.weight.grad, model.bias.grad,
                     model.running_mean, model.running_var])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def _rp_state(batch=2):
    config = SpritesGanConfig(batch_size=batch)
    return config, init_sprites_gan_state(config, pxy_encoder(False, seed=1), device="cpu", seed=0)


def _payload_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_payload_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_payload_equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("zero", [False, True], ids=["dp", "zero"])
def test_data_parallel_step_world1_bit_equal(world1, zero):
    """Three rp steps: the plain step against the data-parallel one on
    copies of one state (in its ZeRO-1 form from the second step on,
    taking over the moments the first step made): every metric and every
    tensor of the state, the Adam moments included, bit-equal."""
    config, state = _rp_state()
    imgs = torch.from_numpy(synthetic_dsprites(n_pos=2).imgs[:2, :, :, None].astype(np.float32))
    twin = copy.deepcopy(state)
    parallel.replicate(twin)
    step = make_sprites_gan_step(config)
    dp_step = parallel.data_parallel_step(step)
    for i in range(3):
        if i == 1 and zero:
            parallel.zero_place(twin)
            assert isinstance(twin.opt_info, parallel.ZeroAdam) and twin.opt_info.inner.state
        state, m = step(state, imgs)
        twin, m_dp = dp_step(twin, imgs)
        assert m.keys() == m_dp.keys() and all(torch.equal(m[k], m_dp[k]) for k in m)
    assert _payload_equal(train_state_payload(state), train_state_payload(twin))


def test_zero_slices_of_two_ranks_tile_the_moments():
    """A ZeRO optimizer of rank r of 2 built from a stepped Adam keeps
    rank r's slice of each moment along ``zero_spec``'s dimension (all of
    a leaf it does not shard); the two ranks' slices put together are the
    whole moment."""
    torch.manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(*shape)) for shape in
              ((64, 32, 4, 4), (16, 128), (8,), (3, 5, 7, 11))]
    opt = torch.optim.Adam(params, lr=1e-3)
    sum((p * p).sum() for p in params).backward()
    opt.step()
    ranks = [parallel.ZeroAdam(opt, rank=r, world=2) for r in range(2)]
    for i, p in enumerate(params):
        d = parallel.zero_spec(p.shape, 2)
        for key in ("exp_avg", "exp_avg_sq"):
            full = opt.state[p][key]
            parts = [z.inner.state[z.shards[i]][key] for z in ranks]
            whole = full if d is None else torch.cat(parts, dim=d)
            assert torch.equal(whole, full), (i, key)
            if d is not None:
                assert parts[0].shape[d] == p.shape[d] // 2
        assert all(torch.equal(z.inner.state[z.shards[i]]["step"], opt.state[p]["step"])
                   for z in ranks)
    assert [parallel.zero_spec(p.shape, 2) for p in params] == [0, 1, None, None]


def test_zero_state_restores_into_plain_adam(world1, tmp_path):
    """A ZeRO state's file holds the full moments in Adam's own layout:
    it loads into a fresh replicated state, equal to the saver's."""
    config, state = _rp_state()
    imgs = torch.from_numpy(synthetic_dsprites(n_pos=2).imgs[2:4, :, :, None].astype(np.float32))
    parallel.replicate(state)
    parallel.zero_place(state)
    state, _ = parallel.data_parallel_step(make_sprites_gan_step(config))(state, imgs)
    path = tmp_path / "z.ckpt"
    parallel.save_on_coordinator(str(path), state)
    _, fresh = _rp_state()
    restore_train_state(str(path), fresh)
    assert isinstance(fresh.opt_info, torch.optim.Adam)
    assert _payload_equal(train_state_payload(fresh), train_state_payload(state))
    assert len(fresh.opt_info.state) == len(list(fresh.g.parameters())) + len(list(fresh.e.parameters()))


class _Records:
    def __init__(self):
        self.rows = []

    def log(self, step, metrics, **_):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def close(self):
        pass


def test_chained_run_epochs_world1_data_parallel_and_zero_bit_equal(world1):
    """``run_epochs`` chained (windows of 4, events every 3) for 6 rp
    steps at batch 4: plain, ``data_parallel`` and ``data_parallel`` with
    ``zero_opt`` from copies of one state log the same losses and end in
    the same state, bit for bit; the events see the same batches."""
    config, state0 = _rp_state(batch=4)
    data = synthetic_dsprites(n_pos=2).imgs
    runs = []
    for dp, zero in ((False, False), (True, False), (True, True)):
        state = copy.deepcopy(state0)
        records, events = _Records(), []
        state = run_epochs(
            n_epochs=1, data=data, batch_size=4, state=state, step_fn=make_sprites_gan_step(config),
            on_batch=lambda i, st, m, b: events.append((i, np.asarray(b[0]).copy())),
            device="cpu", max_steps=6, logger=records, chain=4, chain_periods=(3,),
            data_parallel=dp, zero_opt=zero,
        )
        runs.append((records.rows, events, train_state_payload(state)))
    (rows, events, payload), *others = runs
    assert [s for s, _ in rows] == list(range(6)) and [i for i, _ in events] == [0, 3]
    for rows_o, events_o, payload_o in others:
        assert rows_o == rows
        assert all(i == j and np.array_equal(a, b) for (i, a), (j, b) in zip(events, events_o))
        assert _payload_equal(payload_o, payload)


# --- refusals -----------------------------------------------------------------------


def test_zero_opt_needs_data_parallel_and_the_chained_engine():
    _, state = _rp_state()
    for kw in ({"data_parallel": False, "chain": 4}, {"data_parallel": True, "chain": 1}):
        with pytest.raises(ValueError, match="--zero_opt.*requires --data_parallel and the chained"):
            run_epochs(n_epochs=1, data=np.zeros((4, 64, 64), np.uint8), batch_size=2, state=state,
                       step_fn=None, on_batch=None, device="cpu", zero_opt=True, **kw)
    assert not dist.is_initialized()  # refused before joining anything


@pytest.mark.parametrize("flags,match", [
    ([], "pass --data_parallel"),
    (["--data_parallel", "--zero_opt"], "--zero_opt is not supported in multi-process CLI runs"),
], ids=["without_data_parallel", "zero_opt"])
@pytest.mark.parametrize("name", ["celeba", "rp", "mnist"])
def test_cli_multiprocess_refusals(name, flags, match, monkeypatch, tmp_path):
    """The JAX CLIs' two refusals, before the card: a full rank
    environment of two processes."""
    import importlib

    monkeypatch.setenv("EADGAN_MP_COORDINATOR", "localhost:1")
    monkeypatch.setenv("EADGAN_MP_NUM_PROCESSES", "2")
    monkeypatch.setenv("EADGAN_MP_PROCESS_ID", "0")
    module = importlib.import_module(f"eadgan_tpu_torch.cli.{name}")
    monkeypatch.setattr(module, "platform_device", lambda: pytest.fail("the CLI picked the device"))
    with pytest.raises(SystemExit, match=match):
        module.main(["--ckpt_dir", str(tmp_path), *flags])
    assert not dist.is_initialized()


def test_cli_zero_opt_without_chain_refused(monkeypatch, tmp_path):
    """``--zero_opt --chain 1`` (one process, ``--data_parallel``): the
    engine's configuration error, before any step."""
    from eadgan_tpu_torch.cli import rp

    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")
    try:
        with pytest.raises(ValueError, match="--zero_opt.*--chain > 1"):
            rp.main(["--allow_fresh_pxy", "--batch_size", "4", "--data_parallel", "--zero_opt",
                     "--chain", "1", "--data_dir", str(tmp_path), "--ckpt_dir", str(tmp_path),
                     "--out_dir", str(tmp_path / "img")])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_single_process_data_parallel_cli_joins_a_group_of_one(monkeypatch):
    opt = argparse.Namespace(data_parallel=True, zero_opt=False)
    try:
        assert init_multiprocess(opt, lambda: torch.device("cpu")) == torch.device("cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert multihost.backend() == "gloo"
    finally:
        dist.destroy_process_group()


# --- F1: the compute type ----------------------------------------------------------


@pytest.mark.parametrize("compute,device,want", [
    (None, "cuda", torch.bfloat16), (None, "cpu", None), ("f32", "cuda", None),
    ("bf16", "cpu", torch.bfloat16), ("f32", "cpu", None), ("bf16", "cuda", torch.bfloat16),
])
def test_unset_compute_follows_the_device(compute, device, want):
    assert resolve_compute_dtype(argparse.Namespace(compute=compute), torch.device(device)) is want


def test_gan_trainers_leave_compute_unset_by_default():
    from eadgan_tpu_torch.cli import celeba, mnist, rp

    assert rp.build_parser(False).parse_args([]).compute is None
    for module in (celeba, mnist):
        seen = {}

        def stop(opt, device):
            seen["compute"] = opt.compute
            raise _Stop

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(module, "resolve_compute_dtype", stop)
            mp.setenv("EADGAN_PLATFORM", "cpu")
            mp.setenv("EADGAN_SYNTH_N", "16")
            with pytest.raises(_Stop):
                module.main(["--allow_fresh_approximator"] if module is mnist else [])
        assert seen == {"compute": None}


class _Stop(Exception):
    pass


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_pxy_pretrainer_runs_f32_under_compute_bf16(colored, monkeypatch, tmp_path):
    """``--compute bf16`` does not reach the pxy pretrainer: its model
    computes in float32 (its codes feed the exact 3x3 affine algebra)."""
    from eadgan_tpu_torch.cli import pxy

    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "2")
    seen = []

    def fake_run_epochs(**kw):
        model = kw["state"].model
        out = model(torch.zeros(2, 3 if colored else 1, 64, 64))
        seen.append((out.dtype, {p.dtype for p in model.parameters()}))

    monkeypatch.setattr(pxy, "run_epochs", fake_run_epochs)
    pxy.main(["--compute", "bf16", "--preempt_save", "off", "--data_dir", str(tmp_path),
              "--ckpt_dir", str(tmp_path)],
             colored=colored)
    assert seen == [(torch.float32, {torch.float32})]


def test_approximator_pretrainer_has_no_compute_flag_and_runs_f32(monkeypatch, tmp_path, capsys):
    from eadgan_tpu_torch.cli import approximate_rpqmnxy
    from eadgan_tpu_torch.train.config import ApproximatorConfig
    from eadgan_tpu_torch.train.pretrain import init_approximator_state

    with pytest.raises(SystemExit) as e:
        approximate_rpqmnxy.main(["--compute", "bf16"])
    assert e.value.code == 2 and "--compute" in capsys.readouterr().err
    state = init_approximator_state(ApproximatorConfig(), device="cpu")
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
