"""UMTAC — Unified Multidimensional Tuning Architecture (survey §5).

Wires the survey's proposed components end to end:

  A. Application profile generator — kernel inventory of a collective
     application (op mix + message sizes), from the trainer or synthetic.
  B. Benchmark executor            — tuning.executor.BenchmarkExecutor.
  C. Data pre-processor            — tuning.preprocess (outliers, z-score).
  D. Model generator               — tuning.regression (L1 linear, log-time).
  E. Model boost                   — tuning.ensemble (bagging).
  F. Model optimizer               — L1-driven feature pruning (dimensionality
                                     reduction; PCA-free per the lasso route).
  G. Model validator               — holdout mean-relative-error threshold,
                                     refit with boost on failure.
  H. Reactor core                  — per-kernel performance estimation +
                                     optimal-parameter extrapolation; emits a
                                     DecisionTable for the runtime.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.ensemble import bag
from repro_torch.core.tuning.executor import (
    BenchmarkExecutor,
    Dataset,
    Measurement,
)
from repro_torch.core.tuning.preprocess import reject_outliers
from repro_torch.core.tuning.regression import (
    LinearModel,
    expand_features,
    fit_linear,
    sparsity,
)
from repro_torch.core.tuning.space import (
    MESSAGE_SIZES,
    PROCESS_COUNTS,
    Method,
    Point,
    methods_for,
)


@dataclasses.dataclass(frozen=True)
class KernelProfile:
    """A. One application kernel's collective signature."""

    name: str
    op: str
    message_bytes: int
    calls_per_step: int = 1


def profile_from_gradients(grads_tree, *, axis_size: int) -> List[KernelProfile]:
    """Profile generator over a real parameter tree: one all-reduce kernel
    per gradient leaf, in ``jax.tree``'s leaf order (`repro_torch.pytree`)."""
    from repro_torch import pytree
    profiles = []
    for i, leaf in enumerate(pytree.leaves(grads_tree)):
        nbytes = leaf.numel() * leaf.element_size()
        profiles.append(KernelProfile(f"grad_leaf_{i}", "all_reduce",
                                      nbytes))
    return profiles


@dataclasses.dataclass
class UMTACResult:
    models: Dict[tuple, object]        # (op, algo) -> predictor
    decision: DecisionTable
    holdout_err: float
    validated: bool
    feature_sparsity: float
    n_experiments: int
    kernel_estimates: Dict[str, Tuple[Method, float]]


class UMTAC:
    def __init__(
        self,
        executor: Optional[BenchmarkExecutor] = None,
        *,
        lam: float = 1e-3,
        validate_threshold: float = 0.35,
        boost_members: int = 6,
        seed: int = 0,
    ):
        self.executor = executor or BenchmarkExecutor()
        self.lam = lam
        self.threshold = validate_threshold
        self.boost_members = boost_members
        self.seed = seed

    # ------------------------------------------------------------------
    def run(
        self,
        profiles: Sequence[KernelProfile],
        *,
        p: int,
        ops: Optional[Sequence[str]] = None,
        ps: Optional[Sequence[int]] = None,
        ms: Optional[Sequence[int]] = None,
        holdout_frac: float = 0.25,
    ) -> UMTACResult:
        ops = tuple(ops or sorted({k.op for k in profiles}))
        ps = tuple(ps or [q for q in PROCESS_COUNTS if q <= max(p, 2)])
        ms = tuple(ms or MESSAGE_SIZES)

        # B. benchmark executor over the reduced grid the profiles need
        dataset = self.executor.run_grid(ops, ps, ms)

        # C+D+E+F+G. per-(op, algo) model pipeline
        rng = np.random.default_rng(self.seed)
        models: Dict[tuple, object] = {}
        errs: List[float] = []
        sparsities: List[float] = []
        groups: Dict[tuple, List[Measurement]] = {}
        for r in dataset.rows:
            groups.setdefault((r.op, r.algorithm), []).append(r)
        for key, rows in groups.items():
            X = np.stack([expand_features(r.p, r.m, r.segments)
                          for r in rows])
            y = np.array([r.time for r in rows])
            X, y, _ = reject_outliers(X, y)
            idx = rng.permutation(len(y))
            n_hold = max(1, int(len(y) * holdout_frac))
            hold, train = idx[:n_hold], idx[n_hold:]
            model = fit_linear(X[train], y[train], lam=self.lam)
            err = float(np.mean(
                np.abs(model.predict(X[hold]) - y[hold])
                / np.maximum(y[hold], 1e-12)))
            if err > self.threshold:
                # G->E: validator failed, boost the model
                model = bag(X[train], y[train], n_members=self.boost_members,
                            lam=self.lam, seed=self.seed)
                err = float(np.mean(
                    np.abs(model.predict(X[hold]) - y[hold])
                    / np.maximum(y[hold], 1e-12)))
            else:
                sparsities.append(sparsity(model))
            models[key] = model
            errs.append(err)

        holdout_err = float(np.mean(errs))

        # H. reactor core: decision table + per-kernel estimates
        table = {}
        for op in ops:
            for pp in ps:
                for mm in ms:
                    table[(op, pp, mm)] = self._argmin(models, op, pp, mm)
        decision = DecisionTable(table)

        kernel_estimates = {}
        for k in profiles:
            meth = decision.decide(k.op, p, k.message_bytes)
            t = self._predict(models, k.op, meth, p, k.message_bytes)
            kernel_estimates[k.name] = (meth, t * k.calls_per_step)

        return UMTACResult(
            models=models,
            decision=decision,
            holdout_err=holdout_err,
            validated=holdout_err <= self.threshold,
            feature_sparsity=float(np.mean(sparsities)) if sparsities else 0.0,
            n_experiments=self.executor.n_experiments,
            kernel_estimates=kernel_estimates,
        )

    # ------------------------------------------------------------------
    def _predict(self, models, op, meth: Method, p, m) -> float:
        key = (op, meth.algorithm)
        if key not in models:
            return float("inf")
        X = expand_features(p, m, meth.segments)[None]
        return float(models[key].predict(X)[0])

    def _argmin(self, models, op, p, m) -> Method:
        best, bt = Method("xla", 1), float("inf")
        for meth in methods_for(op, include_xla=False, p=p):
            t = self._predict(models, op, meth, p, m)
            if t < bt:
                best, bt = meth, t
        return best

    # ------------------------------------------------------------------
    def estimate_application(self, result: UMTACResult) -> float:
        """Total predicted collective seconds per application step —
        the reactor core's rank-ordering view (§5.2 H)."""
        return sum(t for _, t in result.kernel_estimates.values())
