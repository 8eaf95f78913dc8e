"""``python -m eadgan_tpu_torch.cli.score`` against ``python -m
eadgan_tpu.cli.score`` end to end on the CPU.

The same numpy-seeded flax variables are saved as the JAX package's
model files and, carried by ``interop.from_jax``, as the port's; both
CLIs score them with ``--metric all`` on the synthetic dSprites
(``EADGAN_SYNTH_POS=3``: 540 images) with 10 groups, the same seed and
``--json_out``.  Every scalar agrees within its tolerance:

* 1e-6 for FactorVAE, MIG and the F-statistic's modularity (no fitted
  head: votes and mutual information of representations that agree to
  ~1e-7; measured 0 here);
* 1e-3 for BetaVAE, SAP, DCI and the F-statistic's explicitness (fitted
  heads: the port's numpy/scipy heads against scikit-learn; measured at
  most 1.2e-4, in the explicitness, whose AUC ranks class probabilities
  that the weak random encoders leave within a few float32 steps of each
  other, so a 1e-7 difference in a representation reorders some).

The encoders are random (numpy-seeded), with a fresh model's spectral-
norm ``u`` and a category head centered on the data, so that no score is
degenerate (a constant category id makes SAP, DCI and the modularity
NaN).

Without ``EADGAN_PLATFORM=cpu`` and without a card the port's CLI raises.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_port_models_dsprites import sprites_flax_variables

TOLS = {
    "betaVAE_metric": 1e-3,
    "factorVAE_metric": 1e-6,
    "factorVAE_metric_revised": 1e-6,
    "MIG_metric": 1e-6,
    "SAP_metric": 1e-3,
    "DCI_Lasso_disent_metric": 1e-3,
    "DCI_Lasso_complete_metric": 1e-3,
    "FStat_modu_metric": 1e-6,
    "FStat_expl_metric": 1e-3,
}


def _center_category_head(variables, channels, code_dim):
    """Shift the category head's bias so its logits average 0 over the
    synthetic sprites, as a trained head's do: the random head otherwise
    gives every image one category."""
    from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
    from eadgan_tpu_torch.interop import sprites_encoder_from_flax
    from eadgan_tpu_torch.models import SpritesEncoder

    enc = SpritesEncoder(n_classes=3, code_dim=code_dim, channels=channels)
    enc.load_state_dict(sprites_encoder_from_flax(variables))
    x = torch.from_numpy(synthetic_dsprites(n_pos=3).imgs[:, None].astype(np.float32))
    with torch.no_grad():
        h = enc.eval().fc2(enc.fc1(enc.conv_block(x.expand(-1, channels, -1, -1)).flatten(1)))
        logits = enc.cat_layer[0](h)
    variables["params"]["SNDense_2"]["Dense_0"]["bias"] -= logits.mean(0).numpy()


def _save_models(tmp_path, colored):
    """The same encoders as the JAX package's files (``jax/``) and the
    port's (``port/``), under the CLIs' default names."""
    from eadgan_tpu.train.checkpoint import save_model as jax_save_model
    from eadgan_tpu.train.state import ModelVars
    from eadgan_tpu_torch.interop import sprites_encoder_from_flax, sprites_encoder_pxy_from_flax
    from eadgan_tpu_torch.models import SpritesEncoder, SpritesEncoderPxy
    from eadgan_tpu_torch.train.checkpoint import save_model

    c, out_dim, code_dim = (3, 6, 7) if colored else (1, 3, 4)
    variables = sprites_flax_variables(colored, seed=11)
    # the encoder's spectral-norm u as a fresh model has it (random, not
    # converged): one power step then finds sigma below s1, which spreads
    # the representation enough that no score is degenerate
    rng = np.random.default_rng(12)
    for stats in variables["e"]["batch_stats"].values():
        sn = stats["SpectralNorm_0"]
        for name in [k for k in sn if k.endswith("/u")]:
            sn[name] = rng.standard_normal(sn[name].shape).astype(np.float32)
    _center_category_head(variables["e"], c, code_dim)
    pxy_name = "encoder_pxy_color_50000.pt" if colored else "encoder_pxy_50000.pt"
    dirs = {k: tmp_path / k for k in ("jax", "port")}
    for d in dirs.values():
        d.mkdir()
    jax_save_model(str(dirs["jax"] / pxy_name), ModelVars.create(variables["pxy"]))
    jax_save_model(str(dirs["jax"] / "encoder_500000.pt"), ModelVars.create(variables["e"]))
    pxy = SpritesEncoderPxy(out_dim=out_dim, channels=c)
    pxy.load_state_dict(sprites_encoder_pxy_from_flax(variables["pxy"]))
    enc = SpritesEncoder(n_classes=3, code_dim=code_dim, channels=c)
    enc.load_state_dict(sprites_encoder_from_flax(variables["e"]))
    save_model(str(dirs["port"] / pxy_name), pxy)
    save_model(str(dirs["port"] / "encoder_500000.pt"), enc)
    return dirs


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_score_cli_matches_jax(tmp_path, monkeypatch, colored):
    from eadgan_tpu.cli.score import main as jax_main
    from eadgan_tpu_torch.cli.score import main as port_main

    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    monkeypatch.setenv("EADGAN_SYNTH_POS", "3")
    dirs = _save_models(tmp_path, colored)
    scores = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        out = str(tmp_path / f"{name}.json")
        main(["--metric", "all", "--ckpt_dir", str(dirs[name]), "--data_dir", str(tmp_path),
              "--n_groups", "10", "--seed", "3", "--json_out", out] + (["--colored"] if colored else []))
        with open(out) as f:
            scores[name] = json.load(f)
    assert set(scores["port"]) == set(scores["jax"]) == set(TOLS)
    for key, tol in TOLS.items():
        got, want = scores["port"][key], scores["jax"][key]
        assert np.isfinite(got), key
        assert abs(got - want) <= tol, (key, got, want)


def test_score_cli_needs_models_and_a_device(tmp_path, monkeypatch):
    from eadgan_tpu_torch.cli.score import main

    monkeypatch.setenv("EADGAN_PLATFORM", "cpu")
    with pytest.raises(SystemExit, match="pass --allow_fresh"):
        main(["--ckpt_dir", str(tmp_path), "--data_dir", str(tmp_path)])
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("EADGAN_PLATFORM")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--allow_fresh", "--data_dir", str(tmp_path)])


def test_score_cli_default_path_imports_no_sklearn(tmp_path):
    """The whole ``--metric all`` run, fresh encoders, in a fresh
    interpreter: scikit-learn is never imported."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['score', '--allow_fresh', '--n_groups', '10', '--data_dir', {str(tmp_path)!r}]\n"
        "runpy.run_module('eadgan_tpu_torch.cli.score', run_name='__main__')\n"
        "print('sklearn imported:', 'sklearn' in sys.modules)\n"
    )
    env = {**os.environ, "EADGAN_PLATFORM": "cpu", "EADGAN_SYNTH_POS": "2"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sklearn imported: False" in out.stdout
    assert "score timing (s): " in out.stdout
