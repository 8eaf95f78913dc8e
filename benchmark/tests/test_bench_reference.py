"""The references against the port's steps on the CPU at batch 4: the
same weights (made by the benchmark), the same batch and the port's
``fixed=`` draws give the same losses and the same parameters after a
step, in float32.  (A test may import both; the reference imports
nothing of the port.)"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from conftest import ROOT

from harness import compare, datasets, spec, weights


def _cfg(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    cfg["compute"] = "f32"
    return cfg


def _program(name, cfg, w):
    prog = spec.program(name)
    return prog.TrainProgram(cfg, 4, w, rng_seed=5, device=torch.device("cpu"))


@pytest.mark.parametrize("name", ["celeba", "dsprites_rp"])
def test_reference_step_agrees_with_the_port(name):
    torch.manual_seed(0)
    cfg = _cfg(name)
    ref = spec.reference(name)
    w = weights.make(ref.init_spec(cfg), seed=7, device="cpu")
    p = _program(name, cfg, w)
    models = ref.build(cfg, "cpu")
    for k, m in models.items():
        m.load_state_dict(weights.part(w, k))
    opts = ref.optimizers(models, cfg)
    data = datasets.make(dict(cfg["data"], rows=8), seed=3, device="cpu", size=cfg["model"]["img_size"])
    rows = torch.as_tensor(data[:4])
    mask = torch.tensor([True, False, True, False]) if cfg["data"]["flip"] else None
    real = ref.prepare(rows, mask, cfg["data"])
    gen = torch.Generator().manual_seed(11)
    draws = ref.draw(gen, 4, cfg, "cpu")
    if name == "celeba":
        z, code, labels = draws
        fixed = {"z": z, "sampled_labels": labels, "code": code}
    else:
        n = cfg["model"]["n_classes"]
        fixed = {"code_d": draws[0], "onehot_d": F.one_hot(draws[1], n).float(),
                 "code_i": draws[2], "onehot_i": F.one_hot(draws[3], n).float()}
    # the port's own prepare of the same rows
    from eadgan_tpu_torch.train.chain import normalize_prepare

    prep = normalize_prepare(cfg["data"]["scale"], cfg["data"]["shift"], flip=cfg["data"]["flip"],
                             add_channel=rows.dim() == 3)
    idx = torch.arange(4, dtype=torch.int32)
    port_batch = prep((torch.as_tensor(data),), idx, mask)[0] if mask is not None else prep(
        (torch.as_tensor(data),), idx)[0]
    assert torch.equal(port_batch, real)
    start = {f"{k}.{n}": t.detach().clone() for k, m in p.models.items()
             for n, t in m.named_parameters()}
    _, port_losses = p.step(p.state, port_batch.contiguous(), fixed=fixed)
    ref_grads = {}

    def on_grads(opt_name, opt):
        names = {id(t): f"{k}.{n}" for k, m in models.items() for n, t in m.named_parameters()}
        ref_grads[opt_name] = {names[id(t)]: float(t.grad.double().norm()) if t.grad is not None
                               else 0.0 for g in opt.param_groups for t in g["params"]}

    ref_losses = ref.step(models, opts, real, draws, cfg, on_grads)
    ref_start = {f"{k}.{n}": w[f"{k}.{n}"] for k in p.models for n, _ in models[k].named_parameters()}
    prog = {"losses": {0: {k: float(v) for k, v in port_losses.items()}},
            "steps": compare.step_grads([compare.host_state(
                p.models, {o: getattr(p.state, o) for o in p.OPTIMIZERS})], cfg["optimizer"]["b1"]),
            "change": compare.change_norms({f"{k}.{n}": t for k, m in p.models.items()
                                            for n, t in m.named_parameters()}, start)}
    expect = {"losses": {0: {k: float(v) for k, v in ref_losses.items()}}, "grads": ref_grads,
              "change": compare.change_norms({f"{k}.{n}": t for k in p.models
                                              for n, t in models[k].named_parameters()}, ref_start)}
    gaps = compare.train_gaps(prog, expect, [])
    # float32 on both sides: the losses to rounding; the gradients to the
    # rounding the affine regularizer's closed form amplifies (the port's
    # 3x3 products are expanded by hand, the reference's are matmuls); the
    # change to a few elements whose first Adam step flips sign on rounding
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 2e-3, gaps
    assert gaps["change_gap"] < 2e-2, gaps


def test_datasets_have_the_published_row_shapes():
    faces = datasets.make({"maker": "faces", "rows": 5}, seed=1, device="cpu", size=64)
    sprites = datasets.make({"maker": "sprites", "rows": 5}, seed=1, device="cpu", size=64)
    assert faces.shape == (5, 64, 64, 3) and faces.dtype == np.uint8
    assert sprites.shape == (5, 64, 64) and set(np.unique(sprites)) <= {0, 1}
    assert int(np.prod(datasets.SPRITE_GRID)) == 737_280
    again = datasets.make({"maker": "faces", "rows": 5}, seed=1, device="cpu", size=64)
    assert np.array_equal(faces, again)
