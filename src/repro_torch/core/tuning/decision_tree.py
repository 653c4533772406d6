"""C4.5-style classification tree for algorithm selection (survey §3.4.1,
Pjesivac-Grbovic et al.): information-gain-ratio splits on {op, p, m},
pruned by a minimum-weight parameter (the survey's ``m``) and a leaf purity
confidence (the survey's ``c``). Unlike the quad tree it handles arbitrary
feature dimensionality.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.space import Method


@dataclasses.dataclass
class TNode:
    label: Optional[int] = None
    feature: Optional[int] = None
    threshold: Optional[float] = None
    left: Optional["TNode"] = None
    right: Optional["TNode"] = None

    @property
    def is_leaf(self):
        return self.label is not None


def _entropy(y: np.ndarray) -> float:
    _, counts = np.unique(y, return_counts=True)
    ps = counts / counts.sum()
    return float(-(ps * np.log2(ps)).sum())


def _gain_ratio(y, mask) -> float:
    n = len(y)
    nl = int(mask.sum())
    if nl == 0 or nl == n:
        return 0.0
    h = _entropy(y)
    hs = (nl / n) * _entropy(y[mask]) + ((n - nl) / n) * _entropy(y[~mask])
    gain = h - hs
    pl = nl / n
    split_info = -(pl * math.log2(pl) + (1 - pl) * math.log2(1 - pl))
    return gain / split_info if split_info > 0 else 0.0


def _majority(y) -> int:
    vals, counts = np.unique(y, return_counts=True)
    return int(vals[np.argmax(counts)])


def build_tree(X: np.ndarray, y: np.ndarray, *, min_weight: int = 1,
               confidence: float = 1.0, _depth: int = 0,
               max_depth: int = 32) -> TNode:
    """min_weight = survey's weight m (bigger -> coarser tree);
    confidence ~ survey's c: stop when leaf purity >= confidence."""
    vals, counts = np.unique(y, return_counts=True)
    purity = counts.max() / len(y)
    if (purity >= confidence or len(y) <= min_weight
            or _depth >= max_depth or len(vals) == 1):
        return TNode(label=_majority(y))

    best = (None, None, 0.0)
    for f in range(X.shape[1]):
        us = np.unique(X[:, f])
        if len(us) < 2:
            continue
        mids = (us[1:] + us[:-1]) / 2
        for th in mids:
            gr = _gain_ratio(y, X[:, f] <= th)
            if gr > best[2]:
                best = (f, th, gr)
    f, th, gr = best
    if f is None or gr <= 0:
        return TNode(label=_majority(y))
    mask = X[:, f] <= th
    if mask.sum() < min_weight or (~mask).sum() < min_weight:
        return TNode(label=_majority(y))
    return TNode(
        feature=f, threshold=th,
        left=build_tree(X[mask], y[mask], min_weight=min_weight,
                        confidence=confidence, _depth=_depth + 1,
                        max_depth=max_depth),
        right=build_tree(X[~mask], y[~mask], min_weight=min_weight,
                         confidence=confidence, _depth=_depth + 1,
                         max_depth=max_depth),
    )


def predict(node: TNode, x: np.ndarray) -> int:
    while not node.is_leaf:
        node = node.left if x[node.feature] <= node.threshold else node.right
    return node.label


def tree_size(node: TNode) -> Tuple[int, int]:
    if node.is_leaf:
        return 1, 1
    nl, ll = tree_size(node.left)
    nr, lr = tree_size(node.right)
    return nl + nr + 1, ll + lr


class DTreeDecision:
    """Per-op C4.5 tree on features (log2 p, log2 m)."""

    def __init__(self, trees: Dict[str, TNode], methods: List[Method]):
        self.trees = trees
        self.methods = methods

    @classmethod
    def fit(cls, table: DecisionTable, ops, *, min_weight: int = 1,
            confidence: float = 1.0) -> "DTreeDecision":
        methods: List[Method] = []
        midx: Dict[Method, int] = {}
        trees = {}
        for op in ops:
            rows = [(p, m, meth) for (o, p, m), meth in table.table.items()
                    if o == op]
            X = np.array([[math.log2(p), math.log2(m)] for p, m, _ in rows])
            ys = []
            for _, _, meth in rows:
                if meth not in midx:
                    midx[meth] = len(methods)
                    methods.append(meth)
                ys.append(midx[meth])
            trees[op] = build_tree(X, np.array(ys), min_weight=min_weight,
                                   confidence=confidence)
        return cls(trees, methods)

    def decide(self, op: str, p: int, m: int) -> Method:
        x = np.array([math.log2(max(p, 1)), math.log2(max(m, 1))])
        return self.methods[predict(self.trees[op], x)]

    def stats(self) -> dict:
        nodes = leaves = 0
        for t in self.trees.values():
            n, l = tree_size(t)
            nodes += n
            leaves += l
        return {"nodes": nodes, "leaves": leaves}


def misclassification(dt: DTreeDecision, table: DecisionTable) -> float:
    wrong = total = 0
    for (op, p, m), meth in table.table.items():
        total += 1
        if dt.decide(op, p, m) != meth:
            wrong += 1
    return wrong / max(total, 1)
