"""Oct-tree decision maps (survey §3.3.2): the survey notes quad trees "do
not work for any input data with dimensions greater than 2" and floats
oct-trees as the open alternative. This implements that extension: a 3-d
decision cube over (op, log2 p, log2 m) encoded as an oct-tree with the
same exact / depth-limited / accuracy-threshold modes as the quad tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.tuning.decision import DecisionTable
from repro_torch.core.tuning.space import Method


@dataclasses.dataclass
class ONode:
    label: Optional[int] = None
    children: Optional[tuple] = None    # 8 octants

    @property
    def is_leaf(self):
        return self.children is None


def _majority(block: np.ndarray) -> Tuple[int, float]:
    vals, counts = np.unique(block, return_counts=True)
    i = int(np.argmax(counts))
    return int(vals[i]), float(counts[i]) / block.size


def build_octree(cube: np.ndarray, *, max_depth: Optional[int] = None,
                 accuracy: float = 1.0, _depth: int = 0) -> ONode:
    label, frac = _majority(cube)
    if (frac >= accuracy or cube.shape[0] <= 1
            or (max_depth is not None and _depth >= max_depth)):
        return ONode(label=label)
    h = cube.shape[0] // 2
    kids = []
    for a in (slice(0, h), slice(h, None)):
        for b in (slice(0, h), slice(h, None)):
            for c in (slice(0, h), slice(h, None)):
                kids.append(build_octree(cube[a, b, c],
                                         max_depth=max_depth,
                                         accuracy=accuracy,
                                         _depth=_depth + 1))
    return ONode(children=tuple(kids))


def query(node: ONode, i: int, j: int, k: int, size: int) -> Tuple[int, int]:
    depth = 0
    while not node.is_leaf:
        h = size // 2
        idx = ((0 if i < h else 4) + (0 if j < h else 2)
               + (0 if k < h else 1))
        node = node.children[idx]
        if i >= h:
            i -= h
        if j >= h:
            j -= h
        if k >= h:
            k -= h
        size = h
        depth += 1
    return node.label, depth


def tree_stats(node: ONode) -> dict:
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
    return {"nodes": nodes, "leaves": leaves, "max_depth": max(depths),
            "mean_depth": float(np.mean(depths))}


class OctreeDecision:
    """ONE tree over the full 3-d (op, p, m) space — what the quad tree
    structurally cannot express (§3.3.2 'Dimensionality of input data')."""

    def __init__(self, ops, ps, ms, tree, methods, size):
        self.ops = list(ops)
        self.ps = list(ps)
        self.ms = list(ms)
        self.tree = tree
        self.methods = methods
        self.size = size

    @classmethod
    def fit(cls, table: DecisionTable, ops, *, max_depth=None,
            accuracy: float = 1.0) -> "OctreeDecision":
        keys = list(table.table)
        ps = sorted({p for (_, p, _) in keys})
        ms = sorted({m for (_, _, m) in keys})
        n = max(len(ops), len(ps), len(ms))
        size = 1 << max(1, math.ceil(math.log2(n)))
        methods: List[Method] = []
        midx: Dict[Method, int] = {}
        cube = np.zeros((size, size, size), np.int32)
        for a in range(size):
            op = ops[min(a, len(ops) - 1)]
            for b in range(size):
                p = ps[min(b, len(ps) - 1)]
                for c in range(size):
                    m = ms[min(c, len(ms) - 1)]
                    meth = table.decide(op, p, m)
                    if meth not in midx:
                        midx[meth] = len(methods)
                        methods.append(meth)
                    cube[a, b, c] = midx[meth]
        tree = build_octree(cube, max_depth=max_depth, accuracy=accuracy)
        return cls(ops, ps, ms, tree, methods, size)

    def decide(self, op: str, p: int, m: int) -> Method:
        a = self.ops.index(op) if op in self.ops else 0
        b = int(np.argmin([abs(pp - p) for pp in self.ps]))
        cs = [i for i, mm in enumerate(self.ms) if mm <= m]
        c = cs[-1] if cs else 0
        label, _ = query(self.tree, a, b, c, self.size)
        return self.methods[label]

    def stats(self) -> dict:
        return tree_stats(self.tree)
