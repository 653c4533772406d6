"""UMTAC Data pre-processor (survey §5.2 C): outlier rejection + z-score
standardization, with the fitted statistics kept for inference-time reuse.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Standardizer:
    mu: np.ndarray
    sigma: np.ndarray

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (X - self.mu) / self.sigma

    def inverse(self, Xs: np.ndarray) -> np.ndarray:
        return Xs * self.sigma + self.mu


def fit_standardizer(X: np.ndarray) -> Standardizer:
    mu = X.mean(axis=0)
    sigma = X.std(axis=0)
    sigma = np.where(sigma < 1e-12, 1.0, sigma)
    return Standardizer(mu=mu, sigma=sigma)


def reject_outliers(X: np.ndarray, y: np.ndarray, *, z: float = 4.0
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Drop rows whose log-target deviates > z sigma within duplicate groups
    (repeated trials of the same configuration)."""
    ly = np.log(np.maximum(y, 1e-12))
    keep = np.ones(len(y), bool)
    # group rows by identical features
    _, inv = np.unique(X, axis=0, return_inverse=True)
    for g in np.unique(inv):
        idx = np.nonzero(inv == g)[0]
        if len(idx) < 3:
            continue
        mu, sd = ly[idx].mean(), ly[idx].std()
        if sd > 0:
            keep[idx] &= np.abs(ly[idx] - mu) <= z * sd
    return X[keep], y[keep], int((~keep).sum())
