"""Quad-tree encoded decision maps (survey §3.3, Pjesivac-Grbovic et al.).

The decision map is a 2^k x 2^k grid over (log2 p, log2 m) whose cells hold
a method index. Exact trees reproduce the map losslessly; depth-limited and
accuracy-threshold trees trade mean performance penalty for size/query depth
— the survey reports <10% penalty at mean depth <= 3, which
benchmarks/quadtree_encoding.py reproduces.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.space import Method


# ---------------------------------------------------------------------------
# decision map construction
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class DecisionMap:
    """2-d grid of method indices for ONE op."""

    op: str
    ps: List[int]            # row coordinates (process counts)
    ms: List[int]            # column coordinates (message sizes)
    grid: np.ndarray         # (len(ps), len(ms)) int method index
    methods: List[Method]    # index -> method

    @classmethod
    def from_table(cls, table: DecisionTable, op: str) -> "DecisionMap":
        keys = [(p, m) for (o, p, m) in table.table if o == op]
        ps = sorted({p for p, _ in keys})
        ms = sorted({m for _, m in keys})
        methods: List[Method] = []
        midx: Dict[Method, int] = {}
        grid = np.zeros((len(ps), len(ms)), np.int32)
        for i, p in enumerate(ps):
            for j, m in enumerate(ms):
                meth = table.table.get((op, p, m)) or table.decide(op, p, m)
                if meth not in midx:
                    midx[meth] = len(methods)
                    methods.append(meth)
                grid[i, j] = midx[meth]
        return cls(op, ps, ms, grid, methods)

    def padded(self) -> np.ndarray:
        """Replicate-pad to a 2^k square (§3.3.1 'naive replication')."""
        n = max(self.grid.shape)
        k = 1 << max(1, math.ceil(math.log2(n)))
        out = np.zeros((k, k), np.int32)
        out[:self.grid.shape[0], :self.grid.shape[1]] = self.grid
        # replicate last row/col
        out[self.grid.shape[0]:, :self.grid.shape[1]] = \
            self.grid[-1][None, :]
        out[:, self.grid.shape[1]:] = out[:, self.grid.shape[1] - 1][:, None]
        return out


# ---------------------------------------------------------------------------
# quad tree
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class QNode:
    label: Optional[int] = None                    # leaf: method index
    children: Optional[Tuple["QNode", ...]] = None  # (nw, ne, sw, se)

    @property
    def is_leaf(self):
        return self.children is None


def _majority(block: np.ndarray) -> Tuple[int, float]:
    vals, counts = np.unique(block, return_counts=True)
    i = int(np.argmax(counts))
    return int(vals[i]), float(counts[i]) / block.size


def build_quadtree(grid: np.ndarray, *, max_depth: Optional[int] = None,
                   accuracy: float = 1.0, _depth: int = 0) -> QNode:
    """Exact when max_depth=None and accuracy=1.0; otherwise depth-limited /
    accuracy-threshold-limited (§3.3.1)."""
    label, frac = _majority(grid)
    if (frac >= accuracy or grid.shape[0] <= 1
            or (max_depth is not None and _depth >= max_depth)):
        return QNode(label=label)
    h = grid.shape[0] // 2
    w = grid.shape[1] // 2
    kids = (
        build_quadtree(grid[:h, :w], max_depth=max_depth, accuracy=accuracy,
                       _depth=_depth + 1),
        build_quadtree(grid[:h, w:], max_depth=max_depth, accuracy=accuracy,
                       _depth=_depth + 1),
        build_quadtree(grid[h:, :w], max_depth=max_depth, accuracy=accuracy,
                       _depth=_depth + 1),
        build_quadtree(grid[h:, w:], max_depth=max_depth, accuracy=accuracy,
                       _depth=_depth + 1),
    )
    return QNode(children=kids)


def query(node: QNode, i: int, j: int, size: int) -> Tuple[int, int]:
    """Returns (label, depth_visited)."""
    depth = 0
    while not node.is_leaf:
        h = size // 2
        top, left = i < h, j < h
        node = node.children[(0 if top else 2) + (0 if left else 1)]
        if not top:
            i -= h
        if not left:
            j -= h
        size = h
        depth += 1
    return node.label, depth


def tree_stats(node: QNode) -> dict:
    """nodes, leaves, max depth, mean leaf depth."""
    nodes = leaves = 0
    depths: List[int] = []

    def walk(n, d):
        nonlocal nodes, leaves
        nodes += 1
        if n.is_leaf:
            leaves += 1
            depths.append(d)
        else:
            for c in n.children:
                walk(c, d + 1)

    walk(node, 0)
    return {"nodes": nodes, "leaves": leaves,
            "max_depth": max(depths), "mean_depth": float(np.mean(depths))}


class QuadTreeDecision:
    """Decision function backed by per-op quad trees."""

    def __init__(self, maps: Dict[str, DecisionMap],
                 trees: Dict[str, QNode]):
        self.maps = maps
        self.trees = trees

    @classmethod
    def fit(cls, table: DecisionTable, ops, *, max_depth=None,
            accuracy: float = 1.0) -> "QuadTreeDecision":
        maps, trees = {}, {}
        for op in ops:
            dm = DecisionMap.from_table(table, op)
            maps[op] = dm
            trees[op] = build_quadtree(dm.padded(), max_depth=max_depth,
                                       accuracy=accuracy)
        return cls(maps, trees)

    def decide(self, op: str, p: int, m: int) -> Method:
        dm = self.maps[op]
        i = int(np.argmin([abs(pp - p) for pp in dm.ps]))
        # nearest-below message size
        js = [jj for jj, mm in enumerate(dm.ms) if mm <= m]
        j = js[-1] if js else 0
        size = dm.padded().shape[0]
        label, _ = query(self.trees[op], i, j, size)
        return dm.methods[label]

    def stats(self) -> dict:
        agg = {"nodes": 0, "leaves": 0, "max_depth": 0, "mean_depth": 0.0}
        for op, t in self.trees.items():
            s = tree_stats(t)
            agg["nodes"] += s["nodes"]
            agg["leaves"] += s["leaves"]
            agg["max_depth"] = max(agg["max_depth"], s["max_depth"])
            agg["mean_depth"] += s["mean_depth"] / len(self.trees)
        return agg
