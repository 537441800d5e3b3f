"""The two linear probes of the eval tasks, in numpy and scipy only.

The JAX package fits them with sklearn (`evaluation/classification.py`,
`evaluation/event_completion.py`), which the GPU machine does not have. These
reproduce the estimators it builds, on the same objective and solver:

- `LogisticRegression`: sklearn's `LogisticRegression(max_iter=100000,
  solver="lbfgs")`. L2 penalty with C = 1 on the weights, the intercept fit
  and not penalised; the mean log loss plus ||W||^2 / (2 C n), minimised by
  `scipy.optimize.minimize(method="L-BFGS-B")` from zeros with sklearn's
  options (gtol = tol = 1e-4, ftol = 64 eps, 50 line-search steps). Three or
  more classes: the multinomial (softmax) loss over one weight row a class.
  Two classes: the binary logistic loss over one row, as sklearn fits them;
  the two have different optima under the penalty. `score` is the accuracy.
- `LeastSquares`: one least-squares fit with intercept per output column
  (sklearn's `LinearRegression`, cloned per output by the JAX package's
  `VectorRegression`): the centred problem solved by `scipy.linalg.lstsq`
  (the minimum-norm solution where the embeddings are rank deficient), the
  intercept from the means. `score` is the mean R^2 over the outputs.

Both compute in float64.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.optimize
from scipy.special import expit, log_expit


class LogisticRegression:
    """L2-penalised logistic regression (binary or multinomial), lbfgs."""

    def __init__(self, C: float = 1.0, tol: float = 1e-4, max_iter: int = 100000):
        self.C, self.tol, self.max_iter = C, tol, max_iter

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        self.classes_, codes = np.unique(np.asarray(y), return_inverse=True)
        k = len(self.classes_)
        if k < 2:
            raise ValueError(f"needs at least 2 classes, got {k}")
        n, d = x.shape
        l2 = 1.0 / (self.C * n)
        rows = 1 if k == 2 else k

        def loss_grad(flat):
            w = flat.reshape(rows, d + 1)
            z = x @ w[:, :d].T + w[:, d]
            if k == 2:
                z = z[:, 0]
                loss = np.mean(-log_expit(z) + (1 - codes) * z)
                dz = ((expit(z) - codes) / n)[:, None]
            else:  # log-softmax by hand: scipy.special.logsumexp probes array types
                zmax = z.max(1, keepdims=True)
                e = np.exp(z - zmax)
                se = e.sum(1, keepdims=True)
                loss = np.mean(zmax[:, 0] + np.log(se[:, 0]) - z[np.arange(n), codes])
                dz = e / se
                dz[np.arange(n), codes] -= 1.0
                dz /= n
            grad = np.concatenate([dz.T @ x + l2 * w[:, :d],
                                   dz.sum(0)[:, None]], axis=1)
            return loss + 0.5 * l2 * np.sum(w[:, :d] ** 2), grad.ravel()

        res = scipy.optimize.minimize(
            loss_grad, np.zeros(rows * (d + 1)), method="L-BFGS-B", jac=True,
            options={"maxiter": self.max_iter, "maxls": 50, "gtol": self.tol,
                     "ftol": 64 * np.finfo(float).eps})
        w = res.x.reshape(rows, d + 1)
        self.coef_, self.intercept_ = w[:, :d], w[:, d]
        self.n_iter_ = res.nit
        return self

    def decision_function(self, x):
        z = np.asarray(x, np.float64) @ self.coef_.T + self.intercept_
        return z[:, 0] if len(self.classes_) == 2 else z

    def predict(self, x):
        z = self.decision_function(x)
        idx = (z > 0).astype(int) if z.ndim == 1 else z.argmax(1)
        return self.classes_[idx]

    def score(self, x, y):
        return float(np.mean(self.predict(x) == np.asarray(y)))


def r2_scores(y, pred):
    """R^2 of each column; a constant column scores 1 if predicted exactly,
    else 0 (sklearn's `r2_score` with force_finite)."""
    ss_res = ((y - pred) ** 2).sum(0)
    ss_tot = ((y - y.mean(0)) ** 2).sum(0)
    safe = np.where(ss_tot > 0, ss_tot, 1.0)
    return np.where(ss_tot > 0, 1.0 - ss_res / safe,
                    np.where(ss_res == 0, 1.0, 0.0))


class LeastSquares:
    """Least squares with intercept, one independent fit per output column."""

    def fit(self, x, y):
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        x_mean, y_mean = x.mean(0), y.mean(0)
        self.coef_ = scipy.linalg.lstsq(x - x_mean, y - y_mean)[0]  # (d, m)
        self.intercept_ = y_mean - x_mean @ self.coef_
        return self

    def predict(self, x):
        return np.asarray(x, np.float64) @ self.coef_ + self.intercept_

    def score(self, x, y):
        return float(np.mean(r2_scores(np.asarray(y, np.float64), self.predict(x))))
