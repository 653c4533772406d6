"""UMTAC Model Boost (survey §5.2 E): bagging over resampled datasets and a
simple residual-boosting stack on top of the base linear regressor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.core.tuning.regression import LinearModel, fit_linear


@dataclasses.dataclass
class BaggedModel:
    members: List[LinearModel]

    def predict(self, X: np.ndarray) -> np.ndarray:
        preds = np.stack([m.predict_log(X) for m in self.members])
        return np.exp(preds.mean(axis=0))


def bag(X: np.ndarray, y: np.ndarray, *, n_members: int = 8,
        lam: float = 1e-3, iters: int = 1500, seed: int = 0) -> BaggedModel:
    rng = np.random.default_rng(seed)
    members = []
    n = len(y)
    for _ in range(n_members):
        idx = rng.integers(0, n, size=n)
        members.append(fit_linear(X[idx], y[idx], lam=lam, iters=iters))
    return BaggedModel(members)


@dataclasses.dataclass
class BoostedModel:
    base: LinearModel
    stages: List[LinearModel]
    rate: float

    def predict(self, X: np.ndarray) -> np.ndarray:
        log_pred = self.base.predict_log(X)
        for s in self.stages:
            log_pred = log_pred + self.rate * s.predict_log(X)
        return np.exp(log_pred)


def boost(X: np.ndarray, y: np.ndarray, *, n_stages: int = 4,
          rate: float = 0.5, lam: float = 1e-4,
          iters: int = 1500) -> BoostedModel:
    """Gradient boosting on log-residuals."""
    base = fit_linear(X, y, lam=lam, iters=iters)
    log_pred = base.predict_log(X)
    log_y = np.log(np.maximum(y, 1e-12))
    stages = []
    for _ in range(n_stages):
        resid = log_y - log_pred
        # fit residual with the same learner (targets exp'd for fit_linear)
        stage = fit_linear(X, np.exp(resid), lam=lam, iters=iters)
        stages.append(stage)
        log_pred = log_pred + rate * stage.predict_log(X)
    return BoostedModel(base=base, stages=stages, rate=rate)
