"""DCI's non-default regressors without scikit-learn, on the CPU.

* ``eval/heads.py::LassoCV`` gives ``sklearn.linear_model.LassoCV()``'s
  ``alpha_`` and ``coef_`` within 1e-6 relative (measured: equal to the
  last few ulps) on DCI-shaped data: standardized codes that each carry
  one factor plus noise, and a standardized factor.
* ``RandomForestRegressor`` draws from its seed: the same seed gives the
  same importances, another seed others; its DCI disentanglement and
  completeness lie within 0.05 of the mean of the JAX package's
  scikit-learn forests over five ``random_state``s (the JAX forests are
  unseeded, so they are held statistically).
* The port's ``dci_score`` with ``Lasso`` and ``LassoCV`` equals the JAX
  package's within 1e-9, and runs every regressor name with
  scikit-learn hidden.
"""

import sys
import warnings

import numpy as np
import pytest

from eadgan_tpu.eval import metrics as jax_metrics
from eadgan_tpu_torch.eval import metrics
from eadgan_tpu_torch.eval.heads import LassoCV, RandomForestRegressor

REGRESSORS = ["Lasso", "LassoCV", "RandomForest", "RandomForestIBGAN", "RandomForestEnum3"]


def _dci_data(seed, n=400, n_factors=5, noise=0.4):
    """Codes that each carry one factor plus noise, and the factors, as
    ``make_metric_data`` lays them out (dSprites: five factors)."""
    rng = np.random.default_rng(seed)
    latents = rng.integers(0, 6, (n, n_factors)).astype(np.float64)
    codes = rng.standard_normal((n, n_factors)) + latents / latents.std(0) / noise
    return {"img_with_latent": {"img": codes, "latent": latents}}


def _identity(x):
    return np.asarray(x, np.float64)


def _standardized(data):
    d = data["img_with_latent"]
    z = [(x - x.mean(0)) / x.std(0) for x in (d["img"], d["latent"])]
    return z[0], z[1]


@pytest.mark.parametrize("seed", range(3))
def test_lasso_cv_matches_sklearn(seed):
    sklearn_lm = pytest.importorskip("sklearn.linear_model")
    X, Y = _standardized(_dci_data(seed))
    for j in range(Y.shape[1]):
        ours = LassoCV().fit(X, Y[:, j])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # scikit-learn's own deprecation notes
            theirs = sklearn_lm.LassoCV().fit(X, Y[:, j])
        np.testing.assert_allclose(ours.alphas_, theirs.alphas_, rtol=1e-12)
        np.testing.assert_allclose(ours.alpha_, theirs.alpha_, rtol=1e-6)
        np.testing.assert_allclose(ours.coef_, theirs.coef_, rtol=1e-6,
                                   atol=1e-6 * np.abs(theirs.coef_).max())
        np.testing.assert_allclose(ours.mse_path_, theirs.mse_path_, rtol=1e-6)


def test_forest_is_seeded():
    X, Y = _standardized(_dci_data(0))
    a = RandomForestRegressor(4, n_estimators=20, random_state=3).fit(X, Y[:, 0])
    b = RandomForestRegressor(4, n_estimators=20, random_state=3).fit(X, Y[:, 0])
    c = RandomForestRegressor(4, n_estimators=20, random_state=4).fit(X, Y[:, 0])
    np.testing.assert_array_equal(a.feature_importances_, b.feature_importances_)
    assert not np.array_equal(a.feature_importances_, c.feature_importances_)
    assert a.feature_importances_.shape == (5,)
    np.testing.assert_allclose(a.feature_importances_.sum(), 1.0, rtol=1e-12)
    assert np.argmax(a.feature_importances_) == 0  # the code that carries factor 0


def test_forest_on_constant_target_has_no_importance():
    X, _ = _standardized(_dci_data(1))
    forest = RandomForestRegressor(3, n_estimators=5).fit(X, np.zeros(len(X)))
    np.testing.assert_array_equal(forest.feature_importances_, np.zeros(5))


@pytest.mark.parametrize("regressor", ["RandomForest", "RandomForestIBGAN"])
def test_forest_dci_matches_sklearn_statistically(regressor, monkeypatch):
    ensemble = pytest.importorskip("sklearn.ensemble")
    data = _dci_data(5)
    ours = metrics.dci_score(data, _identity, regressor, seed=0)
    theirs = []
    for state in range(5):
        forest = ensemble.RandomForestRegressor
        monkeypatch.setattr(ensemble, "RandomForestRegressor",
                            lambda state=state, forest=forest, **kw: forest(random_state=state, **kw))
        theirs.append(jax_metrics.dci_score(data, _identity, regressor))
        monkeypatch.setattr(ensemble, "RandomForestRegressor", forest)
    for key in ("disent", "complete"):
        name = f"DCI_{regressor}_{key}_metric"
        mean = np.mean([t[name] for t in theirs])
        assert abs(ours[name] - mean) <= 0.05, (name, ours[name], [t[name] for t in theirs])
    assert ours[f"DCI_{regressor}_disent_metric"] > 0.5  # each code carries one factor


@pytest.mark.parametrize("regressor", ["Lasso", "LassoCV"])
def test_lasso_dci_equals_jax(regressor):
    pytest.importorskip("sklearn")
    data = _dci_data(2)
    ours = metrics.dci_score(data, _identity, regressor)
    theirs = jax_metrics.dci_score(data, _identity, regressor)
    for key in ("disent", "complete"):
        name = f"DCI_{regressor}_{key}_metric"
        np.testing.assert_allclose(ours[name], theirs[name], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(ours[f"DCI_{regressor}_metric_detail"],
                               theirs[f"DCI_{regressor}_metric_detail"], rtol=1e-6, atol=1e-9)


def test_every_regressor_runs_without_sklearn(monkeypatch):
    for name in ("sklearn", "sklearn.linear_model", "sklearn.ensemble"):
        monkeypatch.setitem(sys.modules, name, None)
    data = _dci_data(3, n=150)
    for regressor in REGRESSORS:
        out = metrics.dci_score(data, _identity, regressor, seed=1)
        for key in ("disent", "complete"):
            assert 0.0 <= out[f"DCI_{regressor}_{key}_metric"] <= 1.0 + 1e-12, regressor
        assert out[f"DCI_{regressor}_metric_detail"].shape == (5, 5)
    with pytest.raises(NotImplementedError):
        metrics.dci_score(data, _identity, "Ridge")
