"""The port's disentanglement evaluation (``eadgan_tpu_torch.eval``) against
the JAX package's (``eadgan_tpu.eval``) and against scikit-learn.

* ``make_metric_data``: array for array equal from one seed.
* The numpy/scipy heads against scikit-learn on seeded problems: mutual
  information and AUC within 1e-12 (both float64 sums of the same
  terms); Lasso coefficients within 1e-4 (the same cyclic descent and
  stopping rule; measured ~1e-17); logistic regression and LinearSVC
  decision values within 1e-3 with equal predictions (logistic: the same
  L-BFGS-B objective and stopping rule, measured ~1e-13; LinearSVC:
  scipy's optimum of liblinear's primal, where liblinear's Newton method
  stops near it, measured 2e-6 to 3e-5).
* The six metric functions of both packages on one numpy representer
  (as ``tests/test_eval.py`` builds them): scores within 1e-6 where no
  fitted head is involved (FactorVAE, MIG, F-stat modularity) and 1e-3
  for the rest; the discriminating cases of ``tests/test_eval.py`` hold
  for the port.
* ``Representer`` against the JAX one on the same weights (numpy-seeded
  flax variables carried by ``interop.from_jax``), gray and colored, with
  a ragged odd last batch: continuous columns within 1e-4 (float32
  convolutions in both packages, summation orders differ), category ids
  equal.
"""

import sys

import numpy as np
import pytest

from test_eval import _sample_factors, perfect_representer, scrambled_representer
from test_torch_port_models_dsprites import sprites_flax_variables

from eadgan_tpu.data.dsprites import synthetic_dsprites as jax_synthetic_dsprites
from eadgan_tpu.eval import metrics as jax_metrics
from eadgan_tpu.eval.data import make_metric_data as jax_make_metric_data
from eadgan_tpu_torch.data.dsprites import synthetic_dsprites
from eadgan_tpu_torch.eval import heads
from eadgan_tpu_torch.eval import metrics as port_metrics
from eadgan_tpu_torch.eval.data import make_metric_data

TOL_EXACT = 1e-12
TOL_LASSO = 1e-4
TOL_DECISION = 1e-3
TOL_SCORE_PLAIN = 1e-6
TOL_SCORE_FITTED = 1e-3
TOL_REP = 1e-4


def _assert_tree_equal(a, b, path="metric_data"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_metric_data_equals_jax():
    data, jax_data = synthetic_dsprites(n_pos=3), jax_synthetic_dsprites(n_pos=3)
    ours = make_metric_data(data, np.random.default_rng(5), n_groups=12, group_size=10)
    theirs = jax_make_metric_data(jax_data, np.random.default_rng(5), n_groups=12, group_size=10)
    _assert_tree_equal(ours, theirs)


# --- the heads against scikit-learn ------------------------------------------------


def _classification(seed, n, d, k):
    g = np.random.default_rng(seed)
    X = g.standard_normal((n, d))
    y = np.argmax(X @ g.standard_normal((d, k)) + 1.5 * g.standard_normal((n, k)), axis=1)
    return X, y


PROBLEMS = [(0, 500, 5, 5), (1, 3000, 5, 32), (2, 300, 3, 2), (3, 2000, 5, 3)]


@pytest.mark.parametrize("problem", PROBLEMS, ids=lambda p: f"n{p[1]}_d{p[2]}_k{p[3]}")
def test_logistic_regression_matches_sklearn(problem):
    from sklearn.linear_model import LogisticRegression

    X, y = _classification(*problem)
    ref = LogisticRegression().fit(X, y)
    ours = heads.LogisticRegression().fit(X, y)
    assert ours.n_iter_ == ref.n_iter_[0]
    np.testing.assert_allclose(ours.decision_function(X), ref.decision_function(X), rtol=0,
                               atol=TOL_DECISION)
    np.testing.assert_allclose(ours.predict_proba(X), ref.predict_proba(X), rtol=0,
                               atol=TOL_DECISION)
    np.testing.assert_array_equal(ours.predict(X), ref.predict(X))
    assert ours.score(X, y) == ref.score(X, y)


@pytest.mark.parametrize("problem", PROBLEMS, ids=lambda p: f"n{p[1]}_k{min(p[3], 3)}")
def test_linear_svc_matches_sklearn(problem):
    from sklearn.svm import LinearSVC

    X, y = _classification(*problem)
    x, y = X[:, :1], y % 3  # SAP's problem: one code against a 3-valued factor
    ref = LinearSVC(C=0.01, class_weight="balanced").fit(x, y)
    ours = heads.LinearSVC(C=0.01).fit(x, y)
    np.testing.assert_allclose(ours.decision_function(x), ref.decision_function(x), rtol=0,
                               atol=TOL_DECISION)
    np.testing.assert_array_equal(ours.predict(x), ref.predict(x))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lasso_matches_sklearn(seed):
    from sklearn.linear_model import Lasso

    g = np.random.default_rng(seed)
    X = g.standard_normal((2000, 5)) @ (np.eye(5) + 0.3 * g.standard_normal((5, 5)))
    y = X @ (g.standard_normal(5) * (g.random(5) < 0.6)) + 0.5 * g.standard_normal(2000)
    X, y = (X - X.mean(0)) / X.std(0), (y - y.mean()) / y.std()  # as DCI normalizes
    ref = Lasso(alpha=0.02).fit(X, y)
    ours = heads.Lasso(alpha=0.02).fit(X, y)
    np.testing.assert_allclose(ours.coef_, ref.coef_, rtol=0, atol=TOL_LASSO)
    np.testing.assert_allclose(ours.intercept_, ref.intercept_, rtol=0, atol=TOL_LASSO)


def test_mutual_information_and_auc_match_sklearn():
    from sklearn.metrics import mutual_info_score, roc_auc_score
    from sklearn.preprocessing import MultiLabelBinarizer

    g = np.random.default_rng(0)
    for n, k in ((1000, 7), (6144, 32), (300, 2)):
        a = g.integers(0, k, n)
        x = g.standard_normal(n) + 0.3 * a
        b = np.digitize(x, np.histogram(x, 20)[1][:-1]).astype(np.float64)
        assert abs(heads.mutual_info_score(a, b) - mutual_info_score(a, b)) <= TOL_EXACT
        assert abs(heads.mutual_info_score(a, a) - mutual_info_score(a, a)) <= TOL_EXACT
        scores = g.random((n, k))
        scores[:, 0] = np.round(scores[:, 0], 1)  # ties
        want = roc_auc_score(MultiLabelBinarizer().fit_transform(a[:, None]), scores)
        assert abs(heads.one_hot_roc_auc(a, scores) - want) <= TOL_EXACT
    assert heads.mutual_info_score(np.zeros(10), g.integers(0, 3, 10)) == 0.0


# --- the six metrics ---------------------------------------------------------------

N_FACTORS = 5


def _metric_data(seed=0):
    """``tests/test_eval.py``'s metric_data fixture, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    groups = []
    for i in range(60):
        fixed = i % N_FACTORS
        factors = _sample_factors(rng, 100)
        factors[:, fixed] = factors[0, fixed]
        groups.append({"img": factors, "label": fixed})
    eval_factors = _sample_factors(rng, 1000)
    ids = _sample_factors(rng, 1000).astype(np.int64)
    return {
        "groups": groups,
        "img_eval_std": eval_factors,
        "img_with_latent": {
            "img": ids.astype(np.float64),
            "latent": ids.astype(np.float64),
            "latent_id": ids,
            "is_continuous": [False, True, True, True, True],
        },
    }


def _mig(module, representer):
    factors = _sample_factors(np.random.default_rng(3), 4000)
    return module.mig_score(factors, factors, representer, num_points=1000,
                            rng=np.random.default_rng(4))


METRICS = {
    "betavae": (lambda m, d, r: m.betavae_score(d, r), {"betaVAE_metric": TOL_SCORE_FITTED}),
    "factorvae": (lambda m, d, r: m.factorvae_score(d, r),
                  {"factorVAE_metric": TOL_SCORE_PLAIN, "factorVAE_metric_revised": TOL_SCORE_PLAIN}),
    "mig": (lambda m, d, r: _mig(m, r), {"MIG_metric": TOL_SCORE_PLAIN}),
    "sap": (lambda m, d, r: m.sap_score(d, r), {"SAP_metric": TOL_SCORE_FITTED}),
    "dci": (lambda m, d, r: m.dci_score(d, r),
            {"DCI_Lasso_disent_metric": TOL_SCORE_FITTED, "DCI_Lasso_complete_metric": TOL_SCORE_FITTED}),
    "fstat": (lambda m, d, r: m.fstat_score(d, r),
              {"FStat_modu_metric": TOL_SCORE_PLAIN, "FStat_expl_metric": TOL_SCORE_FITTED}),
}


@pytest.mark.parametrize("metric", sorted(METRICS))
@pytest.mark.parametrize("representer", [perfect_representer, scrambled_representer],
                         ids=["perfect", "scrambled"])
def test_metric_matches_jax(metric, representer):
    run, tols = METRICS[metric]
    data = _metric_data()
    ours, theirs = run(port_metrics, data, representer), run(jax_metrics, data, representer)
    assert set(ours) == set(theirs)
    for key, tol in tols.items():
        assert abs(ours[key] - theirs[key]) <= tol, (key, ours[key], theirs[key])


@pytest.mark.parametrize("metric", sorted(METRICS))
def test_port_metric_discriminates(metric):
    """The bars of ``tests/test_eval.py`` on the port's metrics."""
    run, _ = METRICS[metric]
    data = _metric_data()
    good, bad = (run(port_metrics, data, r) for r in (perfect_representer, scrambled_representer))
    key, floor, margin = {
        "betavae": ("betaVAE_metric", 0.95, 0.0),
        "factorvae": ("factorVAE_metric", 0.95, 0.0),
        "mig": ("MIG_metric", 0.5, 0.2),
        "sap": ("SAP_metric", 0.5, 0.0),
        "dci": ("DCI_Lasso_disent_metric", 0.9, 0.3),
        "fstat": ("FStat_modu_metric", 0.9, 0.0),
    }[metric]
    assert good[key] > floor
    assert good[key] > bad[key] + margin
    if metric == "fstat":
        assert good["FStat_expl_metric"] > 0.9


def test_dci_sklearn_regressors_raise_without_sklearn(monkeypatch):
    """Without scikit-learn the non-default regressors run on the port's
    own heads (``tests/test_torch_port_dci.py`` holds them to it); only an
    unknown regressor raises."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.linear_model", None)
    monkeypatch.setitem(sys.modules, "sklearn.ensemble", None)
    out = port_metrics.dci_score(_metric_data(), perfect_representer, "LassoCV")
    assert np.isfinite(out["DCI_LassoCV_disent_metric"])
    with pytest.raises(NotImplementedError):
        port_metrics.dci_score(_metric_data(), perfect_representer, "Ridge")


# --- Representer ---------------------------------------------------------------------


@pytest.mark.parametrize("colored", [False, True], ids=["gray", "colored"])
def test_representer_matches_jax(colored):
    from eadgan_tpu.eval.representation import Representer as JaxRepresenter
    from eadgan_tpu.models import SpritesEncoder as JaxE
    from eadgan_tpu.models import SpritesEncoderPxy as JaxPxy
    from eadgan_tpu_torch.eval import Representer
    from eadgan_tpu_torch.interop import sprites_encoder_from_flax, sprites_encoder_pxy_from_flax
    from eadgan_tpu_torch.models import SpritesEncoder, SpritesEncoderPxy

    c, out_dim, code_dim = (3, 6, 7) if colored else (1, 3, 4)
    variables = sprites_flax_variables(colored, seed=3)
    imgs = synthetic_dsprites(n_pos=3).imgs[np.random.default_rng(1).choice(540, 21, replace=False)]

    jax_rep = JaxRepresenter(
        JaxPxy(out_dim=out_dim, channels=c), {"params": variables["pxy"]["params"]},
        JaxE(n_classes=3, code_dim=code_dim, channels=c),
        {"params": variables["e"]["params"], "batch_stats": variables["e"]["batch_stats"]},
        colored=colored, batch_size=8, seed=4,
    )
    pxy = SpritesEncoderPxy(out_dim=out_dim, channels=c)
    pxy.load_state_dict(sprites_encoder_pxy_from_flax(variables["pxy"]))
    enc = SpritesEncoder(n_classes=3, code_dim=code_dim, channels=c)
    enc.load_state_dict(sprites_encoder_from_flax(variables["e"]))
    u_before = {k: v.clone() for k, v in enc.state_dict().items() if k.endswith((".u", ".sigma"))}
    rep = Representer(pxy, enc, colored=colored, batch_size=8, seed=4, device="cpu")

    ours, theirs = rep(imgs), jax_rep(imgs)  # batches of 8, 8 and 5
    assert ours.shape == theirs.shape == (21, 5) and ours.dtype == np.float32
    np.testing.assert_array_equal(ours[:, 0], theirs[:, 0])
    np.testing.assert_allclose(ours[:, 1:], theirs[:, 1:], rtol=TOL_REP, atol=TOL_REP)
    assert rep.images == 21
    for k, v in u_before.items():  # eval mode: the spectral-norm state stays
        assert bool((enc.state_dict()[k] == v).all()), k
