"""The six disentanglement metrics.

PyTorch-side counterpart of ``eadgan_tpu/eval/metrics.py``: the same
arithmetic and result keys, on the numpy/scipy heads of
:mod:`eadgan_tpu_torch.eval.heads` where the JAX package calls
scikit-learn, so no default path needs it.  Each function takes the
prepared ``metric_data`` (:mod:`eadgan_tpu_torch.eval.data`) and a
representer, any callable from a batch of images to (B, codes) numpy
representations; parity with the corresponding reference script is
noted per function.  Nothing here imports scikit-learn: DCI's
``LassoCV`` and ``RandomForest*`` regressors are the heads' too.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from eadgan_tpu_torch.eval.heads import (
    Lasso,
    LassoCV,
    LinearSVC,
    LogisticRegression,
    RandomForestRegressor,
    mutual_info_score,
    one_hot_roc_auc,
)

__all__ = [
    "betavae_score",
    "factorvae_score",
    "mig_score",
    "sap_score",
    "dci_score",
    "fstat_score",
]


def betavae_score(metric_data, representer) -> Dict:
    """BetaVAE score (dSprites/score/BetVAE.py:218-272): per-group mean
    absolute pairwise difference of representations -> logistic
    regression *training* accuracy on the fixed-factor label."""
    features, labels = [], []
    for group in metric_data["groups"]:
        rep = representer(group["img"])
        diff = np.abs(rep[0::2] - rep[1::2])
        features.append(diff.mean(axis=0))
        labels.append(group["label"])
    features = np.vstack(features)
    labels = np.asarray(labels)
    clf = LogisticRegression()
    clf.fit(features, labels)
    return {"betaVAE_metric": clf.score(features, labels)}


def factorvae_score(metric_data, representer) -> Dict:
    """FactorVAE score (dSprites/score/FactorVAE.py:244-329): argmin of
    the per-group std (normalized by the global eval std) votes for the
    fixed factor; majority-assignment accuracy + revised variant."""
    eval_rep = representer(metric_data["img_eval_std"])
    eval_std = eval_rep.std(axis=0, keepdims=True)

    labels = set(g["label"] for g in metric_data["groups"])
    train_data = np.zeros((eval_rep.shape[1], len(labels)))
    for group in metric_data["groups"]:
        rep = representer(group["img"]) / eval_std
        predict = int(np.argmin(rep.std(axis=0)))
        train_data[predict, group["label"]] += 1

    total = train_data.sum()
    maxs = train_data.max(axis=1)
    correct = maxs.sum()
    revised = np.sort(maxs)[::-1][: train_data.shape[1]].sum()
    return {
        "factorVAE_metric": float(correct) / total,
        "factorVAE_metric_revised": float(revised) / total,
        "factorVAE_metric_detail": train_data,
    }


def _discretize_rows(target: np.ndarray, num_bins: int) -> np.ndarray:
    """Histogram-bin discretization per row (dSprites/score/MIG.py:279-284)."""
    out = np.zeros_like(target)
    for i in range(target.shape[0]):
        out[i, :] = np.digitize(target[i, :], np.histogram(target[i, :], num_bins)[1][:-1])
    return out


def _discrete_mi(mus: np.ndarray, ys: np.ndarray) -> np.ndarray:
    m = np.zeros([mus.shape[0], ys.shape[0]])
    for i in range(mus.shape[0]):
        for j in range(ys.shape[0]):
            m[i, j] = mutual_info_score(ys[j, :], mus[i, :])
    return m


def mig_score(
    imgs,
    latents_values,
    representer,
    num_points: int = 1000,
    rng=None,
    num_bins: int = 20,
    idx=None,
) -> Dict:
    """Mutual Information Gap (dSprites/score/MIG.py:310-329): gap of the
    top-2 code-factor MIs over the factor entropy, on ``num_points``
    random samples with 20-bin discretized codes.  ``idx`` overrides the
    sample indices."""
    if idx is None:
        rng = rng or np.random.default_rng(0)
        idx = rng.integers(0, imgs.shape[0], num_points)
    mus = representer(imgs[idx]).T  # (codes, points)
    ys = latents_values[idx].T  # (factors, points)

    discretized = _discretize_rows(mus, num_bins)
    m = _discrete_mi(discretized, ys)
    entropy = np.array(
        [_discrete_mi(ys[j : j + 1], ys[j : j + 1])[0, 0] for j in range(ys.shape[0])]
    )
    sorted_m = np.sort(m, axis=0)[::-1]
    score = np.mean((sorted_m[0, :] - sorted_m[1, :]) / entropy)
    return {"MIG_metric": score, "MIG_detail": m}


def sap_score(metric_data, representer) -> Dict:
    """SAP (dSprites/score/SAP.py:248-314): per (latent, factor) score =
    squared covariance / variance product for continuous factors,
    balanced LinearSVC accuracy for discrete; mean top-2 gap."""
    d = metric_data["img_with_latent"]
    rep = representer(d["img"])
    gt = d["latent"]
    is_cont = d["is_continuous"]

    score_matrix = np.zeros([rep.shape[1], len(is_cont)])
    for i in range(rep.shape[1]):
        for j in range(len(is_cont)):
            x, y = rep[:, i], gt[:, j]
            if is_cont[j]:
                cov = np.cov(x, y, ddof=1)
                score_matrix[i, j] = cov[0, 1] ** 2 / cov[0, 0] / cov[1, 1]
            else:
                clf = LinearSVC(C=0.01)
                clf.fit(x[:, None], y.astype(np.int32))
                score_matrix[i, j] = np.mean(clf.predict(x[:, None]) == y.astype(np.int32))
    sorted_m = np.sort(score_matrix, axis=0)
    score = np.mean(sorted_m[-1, :] - sorted_m[-2, :])
    return {"SAP_metric": score, "SAP_metric_detail": score_matrix}


_TINY = 1e-12


def _norm_entropy(p: np.ndarray) -> float:
    n = p.shape[0]
    return -p.dot(np.log(p + _TINY) / np.log(n + _TINY))


def _entropic_scores(r: np.ndarray):
    r = np.abs(r)
    ps = r / np.sum(r, axis=0)
    return [1 - _norm_entropy(p) for p in ps.T]


def _regressors(regressor: str, n_factors: int, seed: int):
    """One regressor maker per factor and the attribute holding its
    importances, for each ``--dci_regressor`` name (the JAX package's
    table, ``eadgan_tpu/eval/metrics.py``); the forests drawn from
    ``seed``."""
    if regressor == "Lasso":
        return [lambda: Lasso(alpha=0.02)] * n_factors, "coef_"
    if regressor == "LassoCV":
        return [LassoCV] * n_factors, "coef_"
    if regressor == "RandomForest":
        depths = [4, 5, 2, 5, 5][:n_factors]
    elif regressor == "RandomForestIBGAN":
        depths = [4, 2, 4, 2, 2][:n_factors]
    elif regressor.startswith("RandomForestEnum"):
        depths = [int(regressor[len("RandomForestEnum"):])] * n_factors
    else:
        raise NotImplementedError(regressor)
    makers = [
        (lambda dep=dep: RandomForestRegressor(max_depth=dep, random_state=seed)) for dep in depths
    ]
    return makers, "feature_importances_"


def dci_score(metric_data, representer, regressor: str = "Lasso", seed: int = 0) -> Dict:
    """DCI disentanglement/completeness (dSprites/score/DCI.py:236-398):
    one regressor per factor over normalized codes; importance matrix ->
    entropic scores; weighted disentanglement + mean completeness.
    Regressor variants (``eval/heads.py``): Lasso (alpha=0.02, the
    default), LassoCV, and the random forests RandomForest,
    RandomForestIBGAN and RandomForestEnum<d>, drawn from ``seed``."""
    d = metric_data["img_with_latent"]
    codes = representer(d["img"])
    latents = d["latent"]

    def normalize(x):
        std = x.std(0)
        # degenerate (constant) columns would NaN the regressors; the
        # reference crashes here, they normalize to zero instead
        return (x - x.mean(0)) / np.where(std == 0, 1.0, std)

    codes = normalize(codes)
    latents = normalize(latents)

    n_factors = latents.shape[-1]
    makers, attr = _regressors(regressor, n_factors, seed)
    R = []
    for j in range(n_factors):
        reg = makers[j]()
        reg.fit(codes, latents[:, j])
        R.append(np.abs(np.asarray(getattr(reg, attr))[:, None]))
    R = np.hstack(R)

    disent_scores = _entropic_scores(R.T)
    c_rel = np.sum(R, 1) / np.sum(R)
    disent_w_avg = float(np.sum(np.array(disent_scores) * c_rel))
    complete_scores = _entropic_scores(R)
    return {
        f"DCI_{regressor}_disent_metric": disent_w_avg,
        f"DCI_{regressor}_disent_metric_detail": disent_scores,
        f"DCI_{regressor}_complete_metric": float(np.mean(complete_scores)),
        f"DCI_{regressor}_complete_metric_detail": complete_scores,
        f"DCI_{regressor}_metric_detail": R,
    }


def fstat_score(metric_data, representer) -> Dict:
    """F-statistic modularity + explicitness
    (dSprites/score/F_score.py:237-348): squared-MI deviation from the
    one-hot ideal, plus per-factor LogisticRegression ROC-AUC."""
    d = metric_data["img_with_latent"]
    rep = representer(d["img"])
    gt_ids = d["latent_id"]

    disc = np.zeros_like(rep)
    for i in range(rep.shape[1]):
        disc[:, i] = np.digitize(rep[:, i], np.histogram(rep[:, i], 20)[1][:-1])

    mi = np.zeros([rep.shape[1], gt_ids.shape[1]])
    for i in range(rep.shape[1]):
        for j in range(gt_ids.shape[1]):
            mi[i, j] = mutual_info_score(gt_ids[:, j], disc[:, i])
    sq = np.square(mi)
    max_sq = np.max(sq, axis=1)
    delta = (np.sum(sq, axis=1) - max_sq) / (max_sq * (gt_ids.shape[1] - 1))
    modu_detail = 1.0 - delta
    modu = float(np.mean(modu_detail))

    expl_detail = np.zeros([gt_ids.shape[1], 1])
    for i in range(gt_ids.shape[1]):
        clf = LogisticRegression()
        y = gt_ids[:, i]
        clf.fit(rep, y)
        expl_detail[i] = one_hot_roc_auc(y, clf.predict_proba(rep))
    return {
        "FStat_modu_metric": modu,
        "FStat_modu_metric_detail": modu_detail,
        "FStat_expl_metric": float(np.mean(expl_detail)),
        "FStat_expl_metric_detail": expl_detail,
    }
