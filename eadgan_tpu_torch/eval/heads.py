"""The classical-statistics heads of the six metrics, in numpy and scipy.

The JAX package's metrics (``eadgan_tpu/eval/metrics.py``) call
scikit-learn.  The port does not need it: this module holds exactly what
those metrics call, at scikit-learn 1.9's defaults, with the same
objective, scaling and stopping rule:

* :func:`mutual_info_score`: the contingency-table mutual information,
  natural log (``sklearn.metrics.mutual_info_score``);
* :func:`one_hot_roc_auc`: ``roc_auc_score`` of a one-hot
  (``MultiLabelBinarizer``) target against class scores, the macro
  average of each class's rank AUC (ties count one half);
* :class:`LogisticRegression`: lbfgs, C = 1, multinomial (binomial for
  two classes), intercept unpenalized, ``tol`` 1e-4 as L-BFGS-B's
  ``gtol``, ``ftol`` 64 eps, ``maxls`` 50, ``max_iter`` 100, from zeros:
  the mean loss plus ``||coef||^2 / (2 C n)``, the parameters laid out
  as scikit-learn lays them out (classes of one feature contiguous), so
  scipy takes the same path and stops at the same iteration, converged
  or not;
* :class:`LinearSVC`: C = 0.01, ``class_weight="balanced"``, squared
  hinge, L2, one-vs-rest, the intercept a feature of value 1 and
  penalized with the weights (liblinear's ``intercept_scaling=1``).  In
  each one-vs-rest problem the positive class's samples weigh
  ``C * class_weight[k]`` and all others ``C`` (liblinear's
  ``train_one(..., weighted_C[k], C)``; two classes: each class its
  own).  The primal is strictly convex, so scipy's L-BFGS-B solves it
  to its optimum, where liblinear's trust-region Newton stops near it;
* :class:`Lasso`: cyclic coordinate descent on the centered data for
  ``||y - Xw||^2 / (2n) + alpha ||w||_1``, with scikit-learn's gap-safe
  screening, its stopping rule (a pass whose largest update is at most
  ``tol`` of the largest weight, then a duality gap at most ``tol *
  ||y||^2``) and ``max_iter`` 1000;
* :class:`LassoCV` (DCI's ``--dci_regressor LassoCV``): ``LassoCV()``'s
  defaults, 100 alphas log-spaced from ``max |X^T y| / n`` down by
  ``eps`` 1e-3, 5 unshuffled folds, each fold's path warm-started along
  the alphas by coordinate descent on its Gram matrix (scikit-learn's
  ``precompute="auto"`` where there are more rows than features, as in
  DCI; with fewer it works on the rows, to the same optimum), the alpha
  of the least mean fold MSE, then a :class:`Lasso` refit on all rows;
* :class:`RandomForestRegressor` (DCI's ``RandomForest*``): bootstrap
  rows, every feature tried at each split, the squared-error split at
  the midpoint between distinct values, depth-first to ``max_depth``,
  and ``feature_importances_`` the mean of the trees' normalized
  impurity decreases.  Seeded: its forests are not scikit-learn's draws,
  and equal theirs only in distribution.

Inputs are cast to float64, but for the logistic regression's float32
features (as scikit-learn keeps them).
"""

from __future__ import annotations

import numpy as np
from scipy import optimize
from scipy.special import expit
from scipy.stats import rankdata

__all__ = [
    "mutual_info_score", "one_hot_roc_auc", "LogisticRegression", "LinearSVC", "Lasso", "LassoCV",
    "RandomForestRegressor",
]


def mutual_info_score(labels_true, labels_pred) -> float:
    """Mutual information (nats) of two labelings, summed over the
    nonzero cells of their contingency table in row-major order."""
    classes, class_idx = np.unique(np.asarray(labels_true), return_inverse=True)
    clusters, cluster_idx = np.unique(np.asarray(labels_pred), return_inverse=True)
    n_k = clusters.shape[0]
    contingency = np.bincount(
        class_idx.ravel() * n_k + cluster_idx.ravel(), minlength=classes.shape[0] * n_k
    ).reshape(classes.shape[0], n_k)
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    contingency_sum = contingency.sum()
    pi = contingency.sum(axis=1)
    pj = contingency.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0  # one labeling has a single class: no information
    log_contingency_nm = np.log(nz_val)
    contingency_nm = nz_val / contingency_sum
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + np.log(pi.sum()) + np.log(pj.sum())
    mi = (contingency_nm * (log_contingency_nm - np.log(contingency_sum))
          + contingency_nm * log_outer)
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _rank_auc(positive: np.ndarray, score: np.ndarray) -> float:
    """Area under the ROC curve of one binary target: the Mann-Whitney
    statistic over average ranks; NaN when one class is absent."""
    n_pos = int(positive.sum())
    n_neg = positive.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(score)
    return float((ranks[positive].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def one_hot_roc_auc(y, scores) -> float:
    """Macro-averaged AUC of the one-hot encoding of labels ``y`` (one
    column per sorted distinct label) against ``scores`` (n, n_labels)."""
    y = np.asarray(y).ravel()
    scores = np.asarray(scores, np.float64)
    classes = np.unique(y)
    if scores.shape != (y.size, classes.size):
        raise ValueError(f"scores of shape {scores.shape} for {classes.size} labels of {y.size} samples")
    return float(np.mean([_rank_auc(y == c, scores[:, k]) for k, c in enumerate(classes)]))


def _features(X) -> np.ndarray:
    """``X`` as float32 if it is float32, else as float64."""
    X = np.asarray(X)
    return X if X.dtype == np.float32 else X.astype(np.float64)


def _classes(y: np.ndarray) -> np.ndarray:
    classes = np.unique(y)
    if classes.size < 2:
        raise ValueError(f"needs samples of at least 2 classes, got only {classes!r}")
    return classes


class _LinearClassifier:
    """Decision values and predictions of a fitted linear model with one
    weight row per class (one row for two classes)."""

    classes_: np.ndarray
    coef_: np.ndarray
    intercept_: np.ndarray

    def decision_function(self, X) -> np.ndarray:
        d = _features(X) @ self.coef_.T + self.intercept_
        return d.ravel() if d.shape[1] == 1 else d

    def predict(self, X) -> np.ndarray:
        d = self.decision_function(X)
        return self.classes_[(d > 0).astype(int) if d.ndim == 1 else d.argmax(axis=1)]

    def score(self, X, y) -> float:
        """Accuracy on (X, y)."""
        return float(np.mean(self.predict(X) == np.asarray(y)))


def _binomial_loss_grad(w, X, y, l2):
    raw = X @ w[:-1].astype(X.dtype) + w[-1].astype(X.dtype)
    n = X.shape[0]
    raw64 = raw.astype(np.float64)
    per_sample = (np.logaddexp(0.0, raw64) - y * raw64).astype(X.dtype)
    loss = float(per_sample.sum() / n) + 0.5 * l2 * (w[:-1] @ w[:-1])
    g = (expit(raw64) - y).astype(X.dtype) / n
    grad = np.empty_like(w)
    grad[:-1] = X.T @ g + l2 * w[:-1]
    grad[-1] = g.sum()
    return loss, grad


def _multinomial_loss_grad(w, X, y_idx, l2, n_classes):
    # classes of one feature contiguous: w viewed (n_classes, n_features + 1), F order
    coef = w.reshape((n_classes, -1), order="F")
    weights, intercept = coef[:, :-1], coef[:, -1]
    raw = X @ weights.T.astype(X.dtype) + intercept.astype(X.dtype)
    n, rows = X.shape[0], np.arange(X.shape[0])
    top = raw.max(axis=1)
    p = np.exp(raw.astype(np.float64) - top[:, None]).astype(X.dtype)
    sum_exps = p.sum(axis=1, dtype=np.float64)
    per_sample = (np.log(sum_exps) + top).astype(X.dtype) - raw[rows, y_idx]
    loss = float(per_sample.sum() / n) + 0.5 * l2 * np.sum(weights * weights)
    p = (p / sum_exps[:, None]).astype(X.dtype)
    p[rows, y_idx] -= 1
    p /= n
    grad = np.empty((n_classes, coef.shape[1]), order="F")
    grad[:, :-1] = p.T @ X + l2 * weights
    grad[:, -1] = p.sum(axis=0)
    return loss, grad.ravel(order="F")


class LogisticRegression(_LinearClassifier):
    """L2 logistic regression by L-BFGS-B (scikit-learn's ``lbfgs``).

    As scikit-learn does, float32 features stay float32: the linear
    predictions, the per-sample losses and their gradients are float32
    (exponentials summed in float64), the penalty and the parameters
    float64.  Any other input is cast to float64."""

    C, TOL, MAX_ITER = 1.0, 1e-4, 100  # scikit-learn's defaults, as the metrics use them

    def fit(self, X, y) -> "LogisticRegression":
        X = _features(X)
        y = np.asarray(y).ravel()
        self.classes_ = classes = _classes(y)
        n, d = X.shape
        l2 = 1.0 / (self.C * n)
        if classes.size == 2:
            w0 = np.zeros(d + 1)
            func, args = _binomial_loss_grad, (X, (y == classes[1]).astype(np.float64), l2)
        else:
            w0 = np.zeros(classes.size * (d + 1))
            func = _multinomial_loss_grad
            args = (X, np.searchsorted(classes, y), l2, classes.size)
        res = optimize.minimize(
            func, w0, method="L-BFGS-B", jac=True, args=args,
            options={"maxiter": self.MAX_ITER, "maxls": 50, "gtol": self.TOL,
                     "ftol": 64 * np.finfo(float).eps},
        )
        self.n_iter_ = res.nit
        coef = res.x.reshape((1, -1)) if classes.size == 2 else res.x.reshape(
            (classes.size, -1), order="F")
        coef = coef.astype(X.dtype)  # scikit-learn keeps the features' type
        self.coef_, self.intercept_ = coef[:, :-1], coef[:, -1]
        return self

    def predict_proba(self, X) -> np.ndarray:
        """Class probabilities: the softmax of the decision values (two
        classes: their logistic), computed as scikit-learn computes it."""
        d = self.decision_function(X)
        if d.ndim == 1:
            p = expit(d)
            return np.stack([1 - p, p], axis=1)
        p = d - d.max(axis=1, keepdims=True)
        np.exp(p, out=p)
        p /= p.sum(axis=1, keepdims=True)
        return p


def _squared_hinge_loss_grad(w, Xb, sign, cost):
    """0.5 ||w||^2 + sum_i cost_i max(0, 1 - sign_i x_i . w)^2 over the
    bias-augmented ``Xb``."""
    margin = 1.0 - sign * (Xb @ w)
    active = margin > 0
    m = margin[active]
    loss = 0.5 * (w @ w) + np.sum(cost[active] * m * m)
    grad = w - 2.0 * Xb[active].T @ (cost[active] * sign[active] * m)
    return loss, grad


class LinearSVC(_LinearClassifier):
    """Squared-hinge L2 linear SVM, one-vs-rest, balanced class weights,
    the intercept penalized as a feature of value 1 (liblinear's primal
    at ``intercept_scaling=1``)."""

    def __init__(self, C: float):
        self.C = C

    def fit(self, X, y) -> "LinearSVC":
        X = np.asarray(X, np.float64)
        y = np.asarray(y).ravel()
        self.classes_ = classes = _classes(y)
        y_idx = np.searchsorted(classes, y)
        counts = np.bincount(y_idx, minlength=classes.size)
        weighted_c = self.C * (y.size / (classes.size * counts))  # "balanced"
        Xb = np.hstack([X, np.ones((X.shape[0], 1))])
        if classes.size == 2:
            problems = [(y_idx == 1, weighted_c[1], weighted_c[0])]
        else:
            problems = [(y_idx == k, weighted_c[k], self.C) for k in range(classes.size)]
        rows = []
        for positive, c_pos, c_neg in problems:
            sign = np.where(positive, 1.0, -1.0)
            cost = np.where(positive, c_pos, c_neg)
            res = optimize.minimize(
                _squared_hinge_loss_grad, np.zeros(Xb.shape[1]), method="L-BFGS-B", jac=True,
                args=(Xb, sign, cost),
                options={"maxiter": 15000, "maxls": 50, "gtol": 1e-10, "ftol": 0.0},
            )
            rows.append(res.x)
        coef = np.stack(rows)
        self.coef_, self.intercept_ = coef[:, :-1], coef[:, -1]
        return self


def _lasso_cd(X, y, alpha, tol, max_iter):
    """Cyclic coordinate descent for 0.5 ||y - Xw||^2 + alpha ||w||_1 from
    w = 0, with gap-safe screening (scikit-learn's
    ``enet_coordinate_descent`` at beta = 0)."""
    n_features = X.shape[1]
    w = np.zeros(n_features)
    norm2 = np.einsum("ij,ij->j", X, X)
    R = y.copy()
    d_w_tol, tol = tol, tol * (y @ y)

    def gap():
        xta = X.T @ R
        dual_norm = np.max(np.abs(xta)) if n_features else 0.0
        r2 = R @ R
        primal = 0.5 * r2 + alpha * np.sum(np.abs(w))
        scale = alpha / dual_norm if dual_norm > alpha else 1.0
        return primal - (-0.5 * scale ** 2 * r2 + scale * (R @ y)), xta, dual_norm

    def screen(g, xta, dual_norm, excluded):
        active = []
        for j in range(n_features):
            if excluded[j]:
                continue
            d_j = (1.0 - abs(xta[j] / max(alpha, dual_norm))) / np.sqrt(norm2[j])
            if d_j <= np.sqrt(2.0 * g) / alpha:
                active.append(j)
            else:
                if w[j] != 0.0:
                    R[:] += w[j] * X[:, j]
                    w[j] = 0.0
                excluded[j] = True
        return active

    g, xta, dual_norm = gap()
    if g <= tol:
        return w
    excluded = norm2 == 0.0
    active = screen(g, xta, dual_norm, excluded)
    for n_iter in range(max_iter):
        w_max = d_w_max = 0.0
        for j in active:
            w_j = w[j]
            tmp = X[:, j] @ R + w_j * norm2[j]
            w[j] = np.sign(tmp) * max(abs(tmp) - alpha, 0.0) / norm2[j]
            if w[j] != w_j:
                R -= (w[j] - w_j) * X[:, j]
            d_w_max = max(d_w_max, abs(w[j] - w_j))
            w_max = max(w_max, abs(w[j]))
        if w_max == 0.0 or d_w_max / w_max <= d_w_tol or n_iter == max_iter - 1:
            g, xta, dual_norm = gap()
            if g <= tol:
                break
            active = screen(g, xta, dual_norm, excluded)
    return w


class Lasso:
    """L1-penalized least squares with an unpenalized intercept:
    ``||y - Xw - b||^2 / (2n) + alpha ||w||_1`` by cyclic coordinate
    descent on the centered data."""

    TOL, MAX_ITER = 1e-4, 1000  # scikit-learn's defaults

    def __init__(self, alpha: float):
        self.alpha = alpha

    def fit(self, X, y) -> "Lasso":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).ravel()
        x_offset, y_offset = X.mean(axis=0), y.mean()
        Xc = np.asfortranarray(X - x_offset)
        self.coef_ = _lasso_cd(Xc, y - y_offset, self.alpha * X.shape[0], self.TOL, self.MAX_ITER)
        self.intercept_ = y_offset - x_offset @ self.coef_
        return self

    def predict(self, X) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


def _lasso_cd_gram(Q, q, y_norm2, alpha, tol, max_iter, w):
    """Cyclic coordinate descent for 0.5 w^T Q w - q^T w + alpha ||w||_1
    (Q = X^T X, q = X^T y) from ``w``, updated in place, with gap-safe
    screening (scikit-learn's ``enet_coordinate_descent_gram`` at beta =
    0)."""
    n_features = Q.shape[0]
    diag = np.diag(Q).copy()
    Qw = Q @ w
    d_w_tol, tol = tol, tol * y_norm2

    def gap():
        xta = q - Qw
        dual_norm = np.max(np.abs(xta)) if n_features else 0.0
        q_dot_w = w @ q
        r2 = y_norm2 + w @ Qw - 2.0 * q_dot_w
        primal = 0.5 * r2 + alpha * np.sum(np.abs(w))
        scale = alpha / dual_norm if dual_norm > alpha else 1.0
        return primal - (-0.5 * scale ** 2 * r2 + scale * (y_norm2 - q_dot_w)), xta, dual_norm

    def screen(g, xta, dual_norm, excluded):
        radius = np.sqrt(2.0 * abs(g)) / alpha
        active = []
        for j in range(n_features):
            if excluded[j]:
                continue
            d_j = (1.0 - abs(xta[j] / max(alpha, dual_norm))) / np.sqrt(diag[j])
            if d_j <= radius:
                active.append(j)
            else:
                if w[j] != 0.0:
                    Qw[:] -= w[j] * Q[j]
                    w[j] = 0.0
                excluded[j] = True
        return active

    g, xta, dual_norm = gap()
    if 0.0 <= g <= tol:
        return w
    excluded = diag == 0.0
    w[excluded] = 0.0
    active = screen(g, xta, dual_norm, excluded)
    for n_iter in range(max_iter):
        w_max = d_w_max = 0.0
        for j in active:
            w_j = w[j]
            tmp = q[j] - Qw[j] + w_j * diag[j]
            w[j] = np.sign(tmp) * max(abs(tmp) - alpha, 0.0) / diag[j]
            if w[j] != w_j:
                Qw += (w[j] - w_j) * Q[j]
            d_w_max = max(d_w_max, abs(w[j] - w_j))
            w_max = max(w_max, abs(w[j]))
        if w_max == 0.0 or d_w_max / w_max <= d_w_tol or n_iter == max_iter - 1:
            g, xta, dual_norm = gap()
            if g <= tol:
                break
            active = screen(g, xta, dual_norm, excluded)
    return w


def _kfold(n: int, n_splits: int):
    """scikit-learn's unshuffled ``KFold``: contiguous test folds, the
    first ``n % n_splits`` one row longer; train rows in order."""
    sizes = np.full(n_splits, n // n_splits)
    sizes[: n % n_splits] += 1
    stops = np.cumsum(sizes)
    rows = np.arange(n)
    for start, stop in zip(stops - sizes, stops):
        yield np.concatenate([rows[:start], rows[stop:]]), rows[start:stop]


class LassoCV:
    """:class:`Lasso` with its ``alpha`` chosen by 5-fold cross-validation
    over a path of 100 alphas, ``LassoCV()`` at scikit-learn 1.9's
    defaults (see the module docstring)."""

    EPS, N_ALPHAS, N_FOLDS = 1e-3, 100, 5
    TOL, MAX_ITER = Lasso.TOL, Lasso.MAX_ITER

    def fit(self, X, y) -> "LassoCV":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).ravel()
        n = X.shape[0]
        yc = y - y.mean()
        xy = X.T @ yc - X.mean(axis=0) * np.sum(yc)
        alpha_max = np.sqrt(np.max(xy ** 2)) / n
        if alpha_max <= np.finfo(np.float64).resolution:
            self.alphas_ = np.full(self.N_ALPHAS, np.finfo(np.float64).resolution)
        else:
            self.alphas_ = np.geomspace(alpha_max, alpha_max * self.EPS, num=self.N_ALPHAS)
        mse = []
        for train, test in _kfold(n, self.N_FOLDS):
            x_offset, y_offset = X[train].mean(axis=0), y[train].mean()
            Xt, yt = X[train] - x_offset, y[train] - y_offset
            gram, q, y_norm2 = Xt.T @ Xt, Xt.T @ yt, yt @ yt
            w = np.zeros(X.shape[1])
            coefs = np.empty((X.shape[1], self.N_ALPHAS))
            for i, alpha in enumerate(self.alphas_):
                w = _lasso_cd_gram(gram, q, y_norm2, alpha * len(train), self.TOL, self.MAX_ITER, w)
                coefs[:, i] = w
            residues = X[test] @ coefs - y[test][:, None] + (y_offset - x_offset @ coefs)
            mse.append((residues ** 2).mean(axis=0))
        self.mse_path_ = np.stack(mse, axis=1)
        self.alpha_ = self.alphas_[np.argmin(self.mse_path_.mean(axis=1))]
        final = Lasso(self.alpha_).fit(X, y)
        self.coef_, self.intercept_ = final.coef_, final.intercept_
        return self

    def predict(self, X) -> np.ndarray:
        return np.asarray(X, np.float64) @ self.coef_ + self.intercept_


_FEATURE_THRESHOLD = 1e-7  # scikit-learn's: values closer than this are not split apart


def _best_split(X, y, w, orders, rng):
    """The squared-error split of a node whose rows, sorted by each
    feature, are ``orders``: (proxy improvement, feature, threshold), or
    None when every feature is constant there.  Features are tried in a
    random order and the first best is kept, as scikit-learn does."""
    best = None
    for f in rng.permutation(X.shape[1]):
        o = orders[f]
        x = X[o, f]
        valid = x[1:] > x[:-1] + _FEATURE_THRESHOLD
        if not valid.any():
            continue
        cw, cs = np.cumsum(w[o]), np.cumsum(w[o] * y[o])
        wl, sl = cw[:-1], cs[:-1]
        proxy = np.where(valid, sl * sl / wl + (cs[-1] - sl) ** 2 / (cw[-1] - wl), -np.inf)
        p = int(np.argmax(proxy))
        if best is None or proxy[p] > best[0]:
            threshold = x[p] / 2.0 + x[p + 1] / 2.0
            if threshold == x[p + 1] or not np.isfinite(threshold):
                threshold = x[p]
            best = (proxy[p], f, threshold)
    return best


def _impurity(y, w):
    """A node's weighted squared error: its weighted variance."""
    total = w.sum()
    mean = (w * y).sum() / total
    return (w * y * y).sum() / total - mean * mean, total


def _tree_importances(X, y, w, presorted, max_depth, rng):
    """Grow one tree depth first on the rows of weight ``w`` > 0 and
    return its normalized impurity-decrease importances, or None for a
    tree of a single node."""
    importances = np.zeros(X.shape[1])
    root = [o[w[o] > 0] for o in presorted]
    stack = [(root, 0, *_impurity(y[root[0]], w[root[0]]))]
    root_weight = stack[0][3]
    splits = 0
    while stack:
        orders, depth, impurity, weight = stack.pop()
        if depth >= max_depth or len(orders[0]) < 2 or impurity <= np.finfo(np.float64).eps:
            continue
        split = _best_split(X, y, w, orders, rng)
        if split is None:
            continue
        _, f, threshold = split
        left = X[:, f] <= threshold
        children = []
        for side in (left, ~left):
            child = [o[side[o]] for o in orders]
            children.append((child, depth + 1, *_impurity(y[child[0]], w[child[0]])))
        importances[f] += weight * impurity - sum(c[3] * c[2] for c in children)
        splits += 1
        stack.extend(reversed(children))  # the left child first, depth first
    if not splits:
        return None
    importances /= root_weight
    total = importances.sum()
    return importances / total if total > 0 else importances


class RandomForestRegressor:
    """A forest of ``n_estimators`` squared-error regression trees, each
    grown on a bootstrap draw of the rows (as weights) to ``max_depth``
    with every feature tried at each split, drawn from ``random_state``.
    ``feature_importances_``: the mean of the trees' normalized
    impurity-decrease importances, normalized to sum 1.  DCI reads only
    those: the out-of-bag score the JAX package's call asks for
    (``oob_score=True``) is not computed."""

    def __init__(self, max_depth: int, n_estimators: int = 100, random_state: int = 0):
        self.max_depth = max_depth
        self.n_estimators = n_estimators
        self.random_state = random_state

    def fit(self, X, y) -> "RandomForestRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).ravel()
        n = X.shape[0]
        rng = np.random.default_rng(self.random_state)
        presorted = [np.argsort(X[:, f], kind="stable") for f in range(X.shape[1])]
        trees = []
        for _ in range(self.n_estimators):
            w = np.bincount(rng.integers(0, n, n), minlength=n).astype(np.float64)
            imp = _tree_importances(X, y, w, presorted, self.max_depth, rng)
            if imp is not None:
                trees.append(imp)
        if not trees:
            self.feature_importances_ = np.zeros(X.shape[1])
        else:
            mean = np.mean(trees, axis=0)
            self.feature_importances_ = mean / mean.sum()
        return self
