"""Trees of tensors, flattened as ``jax.tree`` flattens them.

The reference flattens gradient trees with ``jax.tree``: a dict's
children in SORTED key order, a list's or tuple's in order, ``None`` an
empty node. Python dicts (and ``torch.utils._pytree``) iterate in
insertion order instead, which would give other fusion buckets, and so
other bits, than the reference. Every tree walk of the port's
collectives goes through this module.

Leaves are anything else: tensors, or any object with ``shape`` and
``dtype`` (a `LeafStruct` plans a layout without data). ``dtype_name``
spells a dtype as the reference does (``"float32"``, ``"bfloat16"``):
artifact keys, plan text and trace spans carry that spelling.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import torch

_LEAF = "leaf"
_NONE = "none"


@dataclasses.dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree (``jax.tree_util.PyTreeDef``)."""

    node: Any
    n_leaves: int

    def unflatten(self, leaves) -> Any:
        it = iter(leaves)
        out = _build(self.node, it)
        if next(it, _NONE) is not _NONE:
            raise ValueError(f"too many leaves for a tree of "
                             f"{self.n_leaves}")
        return out


@dataclasses.dataclass(frozen=True)
class LeafStruct:
    """Shape and dtype of a leaf, without data (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _spec(t, leaves: List) -> Any:
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, tuple(keys), tuple(_spec(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t), None, tuple(_spec(v, leaves) for v in t))
    if t is None:
        return _NONE
    leaves.append(t)
    return _LEAF


def _build(node, it) -> Any:
    if node == _LEAF:
        return next(it)
    if node == _NONE:
        return None
    kind, keys, children = node
    vals = [_build(c, it) for c in children]
    if kind is dict:
        return dict(zip(keys, vals))
    if hasattr(kind, "_fields"):                 # a namedtuple
        return kind(*vals)
    return kind(vals)


def flatten(tree) -> Tuple[List, TreeDef]:
    leaves: List = []
    node = _spec(tree, leaves)
    return leaves, TreeDef(node, len(leaves))


def leaves(tree) -> List:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` (and, leaf by leaf, of each tree
    in ``rest``, which must have the same number of leaves), in
    ``tree``'s structure."""
    flat, treedef = flatten(tree)
    others = [leaves(t) for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError(f"tree_map over trees of {len(flat)} and "
                         f"{[len(o) for o in others]} leaves")
    return treedef.unflatten([fn(*xs) for xs in zip(flat, *others)])


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the reference's spelling."""
    if isinstance(dtype, str):
        return dtype
    return str(dtype).rsplit(".", 1)[-1]


def itemsize(dtype) -> int:
    """Bytes per element of a torch dtype or its name."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return dtype.itemsize


def fingerprint(tree) -> list:
    """Two int64 sums (wrapping) of every leaf's bit patterns and their
    squares: equal lists mean, short of a collision, bit-equal trees."""
    sums = []
    for t in leaves(tree):
        t = t.detach().contiguous()
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).long()
        sums.append(torch.stack([bits.sum(), (bits * bits).sum()]))
    return torch.stack(sums).tolist()
