"""ANN predictor (survey §3.4.3): a three-layer feed-forward network with a
sigmoid hidden layer trained by plain back-propagation — the survey's exact
recipe ("a three layer feed forward back propagation network, with 10 neuron
hidden layer and input/output function of sigmoid/logarithmic-sigmoid").

Used like the regression selector: one regressor per (op, algorithm)
predicting log-time from the standardized feature expansion; selection =
argmin over methods.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.tuning.preprocess import Standardizer, fit_standardizer
from repro_torch.core.tuning.regression import expand_features
from repro_torch.core.tuning.space import Method, methods_for


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-np.clip(x, -30, 30)))


@dataclasses.dataclass
class MLP:
    W1: np.ndarray
    b1: np.ndarray
    W2: np.ndarray
    b2: np.ndarray
    std: Standardizer
    y_mu: float
    y_sd: float

    def _hidden(self, Xs):
        return _sigmoid(Xs @ self.W1 + self.b1)

    def predict_log(self, X: np.ndarray) -> np.ndarray:
        Xs = self.std.transform(X)
        h = self._hidden(Xs)
        out = h @ self.W2 + self.b2
        return out[:, 0] * self.y_sd + self.y_mu

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.exp(self.predict_log(X))


def fit_mlp(X: np.ndarray, y_time: np.ndarray, *, hidden: int = 10,
            lr: float = 0.05, epochs: int = 800, seed: int = 0,
            momentum: float = 0.9) -> MLP:
    """Backprop with momentum on standardized inputs / log targets."""
    rng = np.random.default_rng(seed)
    std = fit_standardizer(X)
    Xs = std.transform(X)
    y = np.log(np.maximum(y_time, 1e-12))
    y_mu, y_sd = float(y.mean()), float(max(y.std(), 1e-9))
    t = ((y - y_mu) / y_sd)[:, None]

    d = Xs.shape[1]
    W1 = rng.normal(0, 1.0 / np.sqrt(d), (d, hidden))
    b1 = np.zeros(hidden)
    W2 = rng.normal(0, 1.0 / np.sqrt(hidden), (hidden, 1))
    b2 = np.zeros(1)
    vW1 = np.zeros_like(W1); vb1 = np.zeros_like(b1)
    vW2 = np.zeros_like(W2); vb2 = np.zeros_like(b2)
    n = len(t)
    for _ in range(epochs):
        h = _sigmoid(Xs @ W1 + b1)
        out = h @ W2 + b2
        err = out - t                              # (n,1)
        gW2 = h.T @ err / n
        gb2 = err.mean(axis=0)
        dh = (err @ W2.T) * h * (1 - h)
        gW1 = Xs.T @ dh / n
        gb1 = dh.mean(axis=0)
        vW2 = momentum * vW2 - lr * gW2; W2 += vW2
        vb2 = momentum * vb2 - lr * gb2; b2 += vb2
        vW1 = momentum * vW1 - lr * gW1; W1 += vW1
        vb1 = momentum * vb1 - lr * gb1; b1 += vb1
    return MLP(W1=W1, b1=b1, W2=W2, b2=b2, std=std, y_mu=y_mu, y_sd=y_sd)


class ANNSelector:
    """Per-(op, algorithm) MLP time predictors; decide = argmin."""

    def __init__(self, models: Dict[tuple, MLP]):
        self.models = models

    @classmethod
    def fit(cls, dataset, *, hidden: int = 10, epochs: int = 800,
            seed: int = 0) -> "ANNSelector":
        groups: Dict[tuple, list] = {}
        for r in dataset.rows:
            groups.setdefault((r.op, r.algorithm), []).append(r)
        models = {}
        for key, rows in groups.items():
            X = np.stack([expand_features(r.p, r.m, r.segments)
                          for r in rows])
            y = np.array([r.time for r in rows])
            models[key] = fit_mlp(X, y, hidden=hidden, epochs=epochs,
                                  seed=seed)
        return cls(models)

    def predict_time(self, op, algorithm, p, m, segments=1) -> float:
        mdl = self.models[(op, algorithm)]
        return float(mdl.predict(expand_features(p, m, segments)[None])[0])

    def decide(self, op: str, p: int, m: int) -> Method:
        best, bt = None, float("inf")
        for meth in methods_for(op, include_xla=False, p=p):
            if (op, meth.algorithm) not in self.models:
                continue
            t = self.predict_time(op, meth.algorithm, p, m, meth.segments)
            if t < bt:
                best, bt = meth, t
        return best or Method("xla", 1)
