"""The port's ``model`` axis against the JAX package's, in one process
and in one four-rank gloo gang of small layers.

* ``default_mesh`` lays ranks out as JAX's ``default_mesh`` reshapes
  devices (rank ``r`` at data ``r // M``, model ``r % M``; the groups
  are the grid's rows and columns) and refuses a world that does not
  divide, as JAX's does;
* ``model_shard_plan`` (the rule ``shard_model_params`` applies) picks
  the leaves JAX's ``shard_model_params`` puts on ``model`` on the
  8-device CPU mesh as (4, 2), for every model of the five families,
  names carried across by ``interop.from_jax``;
* ``zero_spec`` with ``exclude`` equals JAX's ``zero_spec`` with a
  ``model`` ``base`` spec on the shapes of ``test_zero_opt_2d_mesh`` and
  the CelebA leaves;
* a (1, 1) grid is the plain CelebA step bit for bit, with no model
  collective;
* a sharded state (a one-rank view of a (1, 2) grid: cutting needs no
  collective) swaps its shards into every optimizer and cuts restored
  moments, and ``run_epochs``, ``replicate``, a restore, a rank-0 save
  and ZeRO without the mesh refuse it;
* four gloo ranks as (2, 2): each of the five layer classes
  column-parallel on each model group against the unsharded layer
  (three of them also in bf16).  Bar: rtol 1e-5 with an absolute floor
  of 1e-5 of the reference's largest magnitude (float32; only the order
  of the model group's sums differs), 1e-2 for bf16 outputs and
  gradients;
* ``tools/tp_check.py`` end to end at a tiny batch.

The CelebA steps on a (2, 2) grid are in
``test_torch_port_model_axis_gang.py``.
"""

import copy
import os
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from eadgan_tpu.parallel import default_mesh as jax_default_mesh
from eadgan_tpu.parallel import shard_model_params as jax_shard_model_params
from eadgan_tpu.parallel.zero import zero_spec as jax_zero_spec
from eadgan_tpu_torch import parallel
from eadgan_tpu_torch.interop import celeba_discriminator_from_flax, celeba_generator_from_flax
from eadgan_tpu_torch.models import CelebaDiscriminator, CelebaGenerator
from eadgan_tpu_torch.parallel import multihost
from eadgan_tpu_torch.parallel.mesh import model_collectives, model_shard_plan, reset_model_collectives
from eadgan_tpu_torch.train.checkpoint import (
    restore_train_state,
    save_train_state,
    train_state_payload,
)
from eadgan_tpu_torch.train.config import CelebaConfig
from eadgan_tpu_torch.train.engine import run_epochs
from eadgan_tpu_torch.train.gan_celeba import init_celeba_gan_state, make_celeba_gan_step

import tests.test_torch_port_mnist_models as mnist_models
import tests.test_torch_port_models_dsprites as sprites_models
from tests.test_torch_port_models_celeba import celeba_flax_variables
from tests.test_torch_port_jax_files import drop_big_files

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _drop_big_files(tmp_path):
    """No test keeps a file above 8 MB on disk (a CelebA train state is
    ~0.52 GB, and pytest keeps its last three runs' directories)."""
    yield
    drop_big_files(tmp_path)


@pytest.fixture
def world1():
    """A gloo group of one process (``parallel.join_local``), destroyed
    after the test so no later test of the worker finds it."""
    assert not dist.is_initialized()
    device = parallel.join_local("cpu")
    yield device
    dist.destroy_process_group()


# --- the grid ---------------------------------------------------------------------


@pytest.mark.parametrize("world,model", [(1, 1), (2, 1), (2, 2), (4, 2), (8, 1), (8, 2), (8, 4),
                                         (8, 8)])
def test_grid_layout_is_the_jax_reshape(world, model, monkeypatch):
    """Every rank's (data, model) index is where JAX's ``default_mesh``
    puts device ``r`` of ``world``; the data groups are the grid's
    columns and the model groups its rows, built in one order."""
    grid = np.asarray(jax_default_mesh(jax.devices()[:world], model_parallel=model).devices)
    made = []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "new_subgroups_by_enumeration",
                        lambda ranks: made.append(ranks) or (f"group{len(made)}", None))
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    for r in range(world):
        monkeypatch.setattr(multihost, "process_index", lambda r=r: r)
        made.clear()
        mesh = parallel.default_mesh(model)
        row, col = map(int, np.argwhere(grid == jax.devices()[r])[0])
        assert (mesh.data, mesh.model) == grid.shape == (world // model, model)
        assert (mesh.data_index, mesh.model_index) == (row, col)
        if model == 1:
            assert made == [] and mesh.data_group is None and mesh.model_group is None
        else:
            assert made == [[[d * model + m for d in range(world // model)] for m in range(model)],
                            [[d * model + m for m in range(model)] for d in range(world // model)]]
            assert (mesh.data_group, mesh.model_group) == ("group1", "group2")
        sl = parallel.host_batch_slice(8 * (world // model), mesh)
        assert (sl.start, sl.stop) == (8 * row, 8 * row + 8)


@pytest.mark.parametrize("world,model", [(8, 3), (6, 4), (2, 4), (1, 2)])
def test_grid_that_does_not_divide_raises(world, model, monkeypatch):
    with pytest.raises(ValueError, match="not divisible"):
        jax_default_mesh(jax.devices()[:world], model_parallel=model)
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    with pytest.raises(ValueError, match="not divisible"):
        parallel.default_mesh(model)


# --- which leaves the rule shards ----------------------------------------------------


def _celeba():
    g, d = celeba_flax_variables(0)
    return [(g, celeba_generator_from_flax, CelebaGenerator),
            (d, celeba_discriminator_from_flax, CelebaDiscriminator)]


def _sprites(colored):
    variables = sprites_models.sprites_flax_variables(colored)
    return [(variables[n], sprites_models.FROM_FLAX[n],
             lambda n=n: sprites_models.port_model(n, colored, variables)) for n in sprites_models.NAMES]


def _mnist(names):
    variables = mnist_models.mnist_flax_variables()
    return [(variables[n], mnist_models.FROM_FLAX[n],
             lambda n=n: mnist_models.port_model(n, variables)) for n in names]


FAMILIES = {
    "celeba": _celeba,
    "sprites": lambda: _sprites(False),
    "sprites_color": lambda: _sprites(True),
    "mnist": lambda: _mnist(("g", "d", "e")),
    "approximator": lambda: _mnist(("approx",)),
}


def _jax_model_leaves(params, mesh):
    """Paths of the leaves JAX's ``shard_model_params`` puts on ``model``
    (int8 stand-ins: the rule reads shapes only)."""
    placed = jax_shard_model_params(mesh, jax.tree.map(lambda x: np.zeros(x.shape, np.int8), params))
    return {path for path, x in jax.tree_util.tree_flatten_with_path(placed)[0]
            if "model" in tuple(x.sharding.spec)}


def _torch_names(variables, from_flax):
    """flax params path -> the port's state_dict key, by carrying each
    leaf as a distinct constant through ``from_flax``."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(variables["params"])
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i + 1, np.float32) for i, (_, x) in enumerate(leaves)])
    sd = from_flax({**variables, "params": tagged})
    names = {}
    for key, t in sd.items():
        values = torch.unique(t)
        if len(values) == 1 and float(values[0]).is_integer() and 1 <= values[0] <= len(leaves):
            names[leaves[int(values[0]) - 1][0]] = key
    return names


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_leaves_are_jax_shard_model_params(family):
    mesh = jax_default_mesh(model_parallel=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    sharded_any = False
    for variables, from_flax, build in FAMILIES[family]():
        names = _torch_names(variables, from_flax)
        want = {names[path] for path in _jax_model_leaves(variables["params"], mesh)}
        plan = model_shard_plan(build(), 2)
        assert set(plan) == want
        sharded_any |= bool(want)
        assert model_shard_plan(build(), 1) == {}
    # CelebA: G's convTs 0-2 and D's SN convs 1-3; dSprites G's
    # Dense(128 -> 1024), MNIST G's first Dense, the approximator's four
    # hidden Denses of 256
    assert sharded_any


def test_celeba_plan_is_the_large_convs():
    g, d = CelebaGenerator(), CelebaDiscriminator()
    assert model_shard_plan(g, 2) == {f"conv_blocks.{i}.weight": 1 for i in (0, 1, 4)}
    assert model_shard_plan(d, 2) == {f"main.{i}.weight": 0 for i in (2, 4, 6)}
    sharded = sum(p.numel() for n, p in [*g.named_parameters(), *d.named_parameters()]
                  if n in {**model_shard_plan(g, 2), **model_shard_plan(d, 2)})
    total = sum(p.numel() for p in [*g.parameters(), *d.parameters()])
    assert (round(sharded / 1e6, 2), round(total / 1e6, 2)) == (25.07, 25.92)


# --- zero_spec composed with the model shard -------------------------------------------


def _celeba_leaf_shapes():
    """(global torch shape, model dim or None) of every CelebA parameter."""
    g, d = CelebaGenerator(), CelebaDiscriminator()
    plan = {**{f"g.{k}": v for k, v in model_shard_plan(g, 2).items()},
            **{f"d.{k}": v for k, v in model_shard_plan(d, 2).items()}}
    return [(tuple(p.shape), plan.get(f"{m}.{n}"))
            for m, model in (("g", g), ("d", d)) for n, p in model.named_parameters()]


ZERO_CASES = [((4, 4, 256, 512), 3), ((3, 512), 1), ((512, 3), 0), ((6, 5, 7, 12), 3),
              ((1024, 1024, 4, 4), 1), ((8,), None)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("shape,model_dim", ZERO_CASES + _celeba_leaf_shapes(), ids=str)
def test_zero_spec_exclude_is_jax_base(shape, model_dim, n):
    base = P() if model_dim is None else P(*[("model" if i == model_dim else None)
                                             for i in range(len(shape))])
    spec = tuple(jax_zero_spec(shape, n, base=base))
    want = spec.index("data") if "data" in spec else None
    assert parallel.zero_spec(shape, n, exclude=model_dim) == want


def test_zero_spec_units_of_the_jax_2d_test():
    # zero_spec((4,4,256,512), 4, base=P(None,None,None,'model')) == P(None,None,'data','model')
    assert parallel.zero_spec((4, 4, 256, 512), 4, exclude=3) == 2
    # zero_spec((3,512), 4, base=P(None,'model')) keeps only the model shard
    assert parallel.zero_spec((3, 512), 4, exclude=1) is None


# --- a (1, 1) grid -------------------------------------------------------------------


def _celeba_state():
    config = CelebaConfig(batch_size=2)
    return config, init_celeba_gan_state(config, device="cpu", seed=0)


def _payload_equal(a, b):
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_payload_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_payload_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_grid_1x1_bit_equal_to_no_group(world1):
    """Two CelebA steps: the plain step against ``data_parallel_step``
    on a (1, 1) grid after ``replicate`` and ``shard_model_params``
    (which cut nothing): every metric and state tensor bit-equal, and no
    model collective."""
    config, state = _celeba_state()
    twin = copy.deepcopy(state)
    mesh = parallel.default_mesh(1)
    assert (mesh.data, mesh.model, mesh.data_index, mesh.model_index) == (1, 1, 0, 0)
    params = list(twin.g.parameters())
    parallel.replicate(twin)
    parallel.shard_model_params(mesh, twin)
    assert list(twin.g.parameters()) == params  # the same objects
    imgs = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
    step = make_celeba_gan_step(config)
    grid_step = parallel.data_parallel_step(make_celeba_gan_step(config), mesh)
    reset_model_collectives()
    for _ in range(2):
        state, m = step(state, imgs)
        twin, m_grid = grid_step(twin, imgs)
        assert all(torch.equal(m[k], m_grid[k]) for k in m)
    assert _payload_equal(train_state_payload(state), train_state_payload(twin))
    assert all(v == {"count": 0, "bytes": 0} for v in model_collectives().values())


# --- a sharded state in one process ------------------------------------------------------


def _sharded(model_index=1):
    """A CelebA state stepped once, then cut as rank ``model_index`` of a
    (1, 2) grid (a mesh without groups: cutting issues no collective)."""
    config, state = _celeba_state()
    imgs = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    state, _ = make_celeba_gan_step(config)(state, imgs)
    full = copy.deepcopy(state)
    mesh = parallel.Mesh(data=1, model=2, data_index=0, model_index=model_index)
    return full, parallel.shard_model_params(mesh, state)


def test_shards_replace_the_weights_in_every_optimizer_and_cut_their_moments():
    full, state = _sharded()
    w_full, w = full.g.conv_blocks[1].weight, state.g.conv_blocks[1].weight
    assert w.shape == (1024, 256, 4, 4) and torch.equal(w, w_full[:, 256:])
    for opt_name in ("opt_g", "opt_info"):
        opt, opt_full = getattr(state, opt_name), getattr(full, opt_name)
        params = [p for g in opt.param_groups for p in g["params"]]
        assert any(p is w for p in params)
        i = [k for k, p in enumerate(params) if p is w][0]
        p_full = [p for g in opt_full.param_groups for p in g["params"]][i]
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[w][key], opt_full.state[p_full][key][:, 256:])
    d = state.d.main[2]
    assert d.weight.shape == (128, 128, 4, 4) and d.u.shape == (256,)
    places = parallel.state_shardings(state)
    assert places["g.conv_blocks.1.weight"] == ((("model", 1),), (1024, 256, 4, 4))
    assert places["d.main.2.bias"] == ((), (256,))
    assert places["d.main.2.u"] == ((), (256,))


@pytest.mark.parametrize("action,error,match", [
    ("run_epochs", ValueError, "model_parallel=1"),
    ("replicate", ValueError, "before shard_model_params"),
    ("restore", ValueError, "unsharded state"),
    ("rank0_save", RuntimeError, "gather it on every rank"),
    ("zero_without_mesh", ValueError, "needs its mesh"),
    ("shard_twice", ValueError, "already sharded"),
])
def test_a_sharded_state_is_refused_where_it_would_hang_or_corrupt(action, error, match, tmp_path):
    full, state = _sharded()
    save_train_state(str(tmp_path), "s", 1, full)
    with pytest.raises(error, match=match):
        if action == "run_epochs":
            run_epochs(n_epochs=1, data=np.zeros((4, 64, 64, 3), np.uint8), batch_size=2,
                       state=state, step_fn=None, on_batch=None, device="cpu")
        elif action == "replicate":
            parallel.replicate(state)
        elif action == "restore":
            restore_train_state(str(tmp_path / "s_1.ckpt"), state)
        elif action == "rank0_save":
            save_train_state(str(tmp_path), "t", 1, state)
        elif action == "zero_without_mesh":
            parallel.zero_place(state)
        else:
            parallel.shard_model_params(state.g.conv_blocks[1].model_shard.mesh, state)


def test_tp_check_on_the_cpu():
    """``tools/tp_check.py`` end to end at a global batch of 2: a (1, 2)
    grid of gloo ranks against one rank, its save after step 1 restored
    by a (1, 1) grid, re-cut and saved bit for bit, and its second step
    against the writer's."""
    from eadgan_tpu_torch.tools.tp_check import run_tp_check

    report = run_tp_check(grid=(1, 2), batch=2, steps=2, device="cpu", save_at=1,
                          resume_grid=(1, 1), timeout_s=300)
    assert report["ok"], report
    assert report["backend"] == "gloo" and report["ranks_agree"]
    one, half = report["one_rank_bytes"], report["bytes_by_rank"][0]
    assert (one["params"], one["moments"]) == (103_684_184, 414_736_736)
    assert (half["params"], half["moments"]) == (53_549_144, 214_196_576)
    # float32 bytes of 8 sharded forwards (G twice, D six times) of 2 rows
    # through 3 sharded layers each, and D's six SN u vectors
    gathered = report["model_collectives_by_step"][0]["gather"]["bytes"]
    assert gathered == 4 * 8 * 2 * (1024 * 16 + 512 * 64 + 256 * 256) + 4 * 6 * (256 + 512 + 1024)
    resumed = report["resume"]
    assert resumed["recut_equals_file"] and resumed["vs_writer"]["ok"]
    assert resumed["bytes_by_rank"][0]["params"] == one["params"]


# --- column-parallel layers on four ranks ------------------------------------------------

LAYER_WORKER = textwrap.dedent(
    """
    import copy, sys
    import torch
    import torch.distributed as dist
    from eadgan_tpu_torch import parallel
    from eadgan_tpu_torch.models.layers import (SNConv, SNDense, TorchConv, TorchConvTranspose,
                                                TorchDense, no_stat_updates)
    from eadgan_tpu_torch.parallel.mesh import (mean_gradients, model_collectives,
                                                reset_model_collectives)

    rank, port, work = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    parallel.initialize(f"localhost:{port}", 4, rank, device="cpu")
    assert "jax" not in sys.modules
    mesh = parallel.default_mesh(2)
    torch.manual_seed(0)
    layers = {
        "TorchConv": (TorchConv(6, 8, 3, 1, 1), (2, 6, 5, 5)),
        "TorchConvTranspose": (TorchConvTranspose(6, 8, 4, 2, 1), (2, 6, 5, 5)),
        "TorchDense": (TorchDense(6, 8), (3, 2, 6)),
        "SNConv": (SNConv(6, 8, 4, 2, 1), (2, 6, 8, 8)),
        "SNDense": (SNDense(6, 8), (3, 6)),
        "TorchConvTranspose_bf16": (TorchConvTranspose(6, 8, 4, 2, 1, dtype=torch.bfloat16),
                                    (2, 6, 5, 5)),
        "SNConv_bf16": (SNConv(6, 8, 4, 2, 1, dtype=torch.bfloat16), (2, 6, 8, 8)),
        "TorchDense_bf16": (TorchDense(6, 8, dtype=torch.bfloat16), (3, 2, 6)),
    }
    out = {}
    for name, (layer, shape) in layers.items():
        x = torch.randn(*shape, generator=torch.Generator().manual_seed(10 + mesh.data_index))
        ref = copy.deepcopy(layer)
        parallel.shard_model_params(mesh, layer, min_channels=4)
        shard = layer.model_shard
        runs = []
        for m in (ref, layer):
            reset_model_collectives()
            xi = x.clone().requires_grad_(True)
            m(x)  # a first training forward: spectral norm's u advances twice
            y = m(xi)
            gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3 + mesh.data_index))
            (y * gy).sum().backward()
            gw = m.weight.grad
            if m is layer:
                parts = [torch.empty_like(gw) for _ in range(mesh.model)]
                dist.all_gather(parts, gw, group=mesh.model_group)
                gw = torch.cat(parts, dim=shard.dim)
            rec = {"y": y.detach(), "dx": xi.grad, "dw": gw, "db": m.bias.grad,
                   "collectives": model_collectives()}
            if hasattr(m, "u"):
                rec.update(u=m.u.clone(), sigma=m.sigma.clone())
                with no_stat_updates(m):
                    rec["y_frozen"] = m(x).detach()
                rec["u_after_frozen"] = m.u.clone()
                m.eval()
                rec["y_eval"] = m(x).detach()
                rec["u_after_eval"] = m.u.clone()
            runs.append(rec)
        out[name] = runs
    # before an optimizer step: the gradients averaged over the data group,
    # then the replicated ones made the model group's first rank's
    net = torch.nn.Sequential(TorchDense(6, 8), TorchDense(8, 3))
    parallel.shard_model_params(mesh, net, min_channels=8)  # the first layer only
    for i, p in enumerate(net.parameters()):
        p.grad = torch.full_like(p, float(10 * rank + i))
    reset_model_collectives()
    with parallel.data_axis(mesh, net):
        mean_gradients(list(net.parameters()))
    try:
        with parallel.data_axis(mesh):
            refused = False
    except ValueError:
        refused = True
    sync = {"grads": {n: p.grad.clone() for n, p in net.named_parameters()},
            "collectives": model_collectives(), "refused_without_state": refused}
    torch.save({"mesh": (mesh.data_index, mesh.model_index), "layers": out, "sync": sync},
               f"{work}/rank{rank}.pt")
    parallel.sync()
    """
)


@pytest.fixture(scope="module")
def layer_gang(tmp_path_factory):
    work = tmp_path_factory.mktemp("layers")
    (work / "worker.py").write_text(LAYER_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, EADGAN_PLATFORM="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [REPO, os.environ.get("PYTHONPATH", "")])))
    for name in ("EADGAN_MP_NUM_PROCESSES", "EADGAN_MP_PROCESS_ID", "EADGAN_MP_COORDINATOR",
                 "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "EADGAN_DIST_BACKEND"):
        env.pop(name, None)
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), str(r), port, str(work)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * 4, [o[1][-3000:] for o in outs]
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(4)]


def _close(got, ref, what, tol):
    ref, got = ref.double().numpy(), got.double().numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max(), err_msg=what)


@pytest.mark.parametrize("name", ["TorchConv", "TorchConvTranspose", "TorchDense", "SNConv",
                                  "SNDense", "TorchConvTranspose_bf16", "SNConv_bf16",
                                  "TorchDense_bf16"])
def test_column_parallel_layer_matches_the_unsharded_one(layer_gang, name):
    """float32 at rtol 1e-5; a bf16 compute type at 1e-2, two bf16
    roundings (the sharded layer's conv on fewer output channels may sum
    in another order before it rounds), with spectral norm's ``u`` and
    ``sigma`` still float32 at 1e-5."""
    for rank in layer_gang:
        ref, got = rank["layers"][name]
        keys = ["y", "dx", "dw", "db"] + (["u", "sigma", "y_frozen", "y_eval"] if "u" in ref else [])
        for key in keys:
            tol = 1e-2 if name.endswith("bf16") and key not in ("u", "sigma") else 1e-5
            _close(got[key], ref[key], f"rank {rank['mesh']} {name} {key}", tol)
        if "u" in ref:  # frozen and eval forwards keep the stored u
            assert torch.equal(got["u_after_frozen"], got["u"])
            assert torch.equal(got["u_after_eval"], got["u"])
        assert all(v["count"] == 0 for v in ref["collectives"].values())
        # one gather of the output; the input gradient's sum in the backward
        assert got["collectives"]["gather"]["count"] >= 1
        assert got["collectives"]["copy"]["count"] >= 1


def test_replicated_gradients_are_the_first_model_rank_s(layer_gang):
    """``mean_gradients`` on a (2, 2) grid: each gradient averaged over
    the data group, then the replicated ones (all but the sharded
    weight's) broadcast from model index 0 in one flat buffer, so every
    rank steps its replicas with the same bits; ``data_axis`` on a model
    axis refuses to run without the state it steps."""
    for rank in layer_gang:
        data, model = rank["mesh"]
        sync = rank["sync"]
        # rank r's gradient i was 10 r + i; the data group of model index
        # m is ranks m and 2 + m, whose mean is 10 m + 10 + i
        for i, (name, grad) in enumerate(sync["grads"].items()):
            want = 10 * model + 10 + i if name == "0.weight" else 10 + i
            assert torch.equal(grad, torch.full_like(grad, float(want))), (rank["mesh"], name)
        assert sync["collectives"]["sync"] == {"count": 1, "bytes": 4 * (8 + 3 * 8 + 3)}
        assert sync["refused_without_state"]
