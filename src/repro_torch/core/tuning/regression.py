"""UMTAC Model Generator (survey §5.2 D): multivariate linear regression over
an engineered feature expansion U = P ∪ R, with L1 regularization solved by
ISTA (proximal gradient descent) exactly as the survey prescribes ("for
regularization generally a L1 norm component is preferred over L2").

Features follow the survey's construction: the process-count family
P = { p^i log^j p } plus message-size and method terms R, letting the linear
model express the analytic forms of Table 3 (e.g. (p-1)(alpha + beta*m/p)
expands over {1, p, m, m/p, p*m}).

The target is log(time): multiplicative noise becomes additive, and the
mean-relative-error metric the survey reports is natural in this space.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.tuning.preprocess import Standardizer, fit_standardizer


FEATURE_NAMES = (
    "1", "log_p", "log2_p", "p", "log_m", "m", "m_over_p", "p_log_p",
    "log_p_log_m", "m_log_p", "seg", "log_seg", "m_over_seg",
)


def expand_features(p, m, segments, extra: Optional[Dict[str, float]] = None
                    ) -> np.ndarray:
    lp = math.log2(max(p, 2))
    lm = math.log2(max(m, 2))
    row = [
        1.0, lp, lp * lp, float(p), lm, float(m), m / p, p * lp,
        lp * lm, m * lp, float(segments), math.log2(max(segments, 1)) ,
        m / max(segments, 1),
    ]
    if extra:
        row.extend(extra.values())
    return np.asarray(row, float)


@dataclasses.dataclass
class LinearModel:
    theta: np.ndarray
    std: Standardizer
    feature_names: tuple
    train_err: float = 0.0

    def predict_log(self, X: np.ndarray) -> np.ndarray:
        Xs = self.std.transform(X)
        Xs = np.concatenate([np.ones((len(Xs), 1)), Xs], axis=1)
        return Xs @ self.theta

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.exp(self.predict_log(X))


def _ista(X, y, lam, iters=3000, lr=None):
    n, d = X.shape
    theta = np.zeros(d)
    if lr is None:
        lip = np.linalg.norm(X, 2) ** 2 / n
        lr = 1.0 / max(lip, 1e-9)
    for _ in range(iters):
        grad = X.T @ (X @ theta - y) / n
        theta = theta - lr * grad
        # soft threshold (do not penalize the intercept)
        t = lam * lr
        theta[1:] = np.sign(theta[1:]) * np.maximum(np.abs(theta[1:]) - t, 0)
    return theta


def fit_linear(X: np.ndarray, y_time: np.ndarray, *, lam: float = 1e-3,
               iters: int = 3000) -> LinearModel:
    """X: raw feature rows (expand_features); y_time: seconds."""
    std = fit_standardizer(X)
    Xs = std.transform(X)
    Xs = np.concatenate([np.ones((len(Xs), 1)), Xs], axis=1)
    y = np.log(np.maximum(y_time, 1e-12))
    theta = _ista(Xs, y, lam, iters=iters)
    pred = Xs @ theta
    err = float(np.mean(np.abs(np.exp(pred) - y_time)
                        / np.maximum(y_time, 1e-12)))
    return LinearModel(theta=theta, std=std,
                       feature_names=("intercept",) + FEATURE_NAMES,
                       train_err=err)


def sparsity(model: LinearModel, tol: float = 1e-6) -> float:
    w = model.theta[1:]
    return float((np.abs(w) <= tol).mean())


class RegressionSelector:
    """Per-(op, algorithm) time regressors; selection = argmin prediction.

    This is the survey's REPTree/ANN predictor role (§3.4.1) with the UMTAC
    base learner.
    """

    def __init__(self, models: Dict[tuple, LinearModel]):
        self.models = models

    @classmethod
    def fit(cls, dataset, *, lam: float = 1e-3, iters: int = 2000
            ) -> "RegressionSelector":
        groups: Dict[tuple, list] = {}
        for r in dataset.rows:
            groups.setdefault((r.op, r.algorithm), []).append(r)
        models = {}
        for key, rows in groups.items():
            X = np.stack([expand_features(r.p, r.m, r.segments)
                          for r in rows])
            y = np.array([r.time for r in rows])
            models[key] = fit_linear(X, y, lam=lam, iters=iters)
        return cls(models)

    def predict_time(self, op, algorithm, p, m, segments=1) -> float:
        model = self.models[(op, algorithm)]
        return float(model.predict(
            expand_features(p, m, segments)[None])[0])

    def decide(self, op: str, p: int, m: int):
        from repro_torch.core.tuning.space import Method, methods_for
        best, bt = None, float("inf")
        for meth in methods_for(op, include_xla=False, p=p):
            if (op, meth.algorithm) not in self.models:
                continue
            t = self.predict_time(op, meth.algorithm, p, m, meth.segments)
            if t < bt:
                best, bt = meth, t
        return best or Method("xla", 1)
