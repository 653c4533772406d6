"""Gradient-tree bucketing: coalesce leaves into contiguous fusion
buffers so one tuned collective per bucket replaces one per leaf (port
of ``repro/comms/bucketing.py``).

The reference flattens with ``jax.tree``; the port with
`repro_torch.pytree`, which visits a dict's children in sorted key
order as ``jax.tree`` does, so one tree gives the reference's buckets.
``layer_slice_struct`` gives `pytree.LeafStruct`s where the reference
gives ``jax.ShapeDtypeStruct``s. The reference's text follows.

A 200-leaf gradient tree pays 200 collective launches per step under the
per-leaf sync; the survey's answer (and every production DDP stack's) is
to fuse leaves into ~bucket_bytes flat buffers. The layout here is

  * dtype-homogeneous — a bucket holds leaves of exactly one dtype, so
    flatten/unflatten is pure data movement (no casts);
  * order-stable — leaves enter buckets in tree-flatten order, each
    dtype stream packed greedily by ``coalesce_bytes``'s rule;
  * exactly invertible — ``unflatten(flatten(tree)) == tree``
    bit-for-bit, including zero-size leaves (they occupy zero-width
    slots and never open a bucket on their own).

`BucketLayout.plan` works on tensors or leaf structs (only shape and
dtype are read), so the same layout drives both the executing sync and
the plan renderer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import torch

from repro_torch import pytree
from repro_torch.core.collectives.schedule import (  # noqa: F401
    coalesce_bytes,
    pack_buckets,
)

__all__ = ["Bucket", "BucketLayout", "BucketSlot", "RELEASE_KEY",
           "coalesce_bytes", "layer_slice_struct", "pack_buckets",
           "split_release_tree"]

# The top-level gradient-tree key whose leaves are stacked per layer
# (leading axis = layer) and released layer-by-layer during backward.
# grad_release tags are ("layers", i); tag[0] must equal this key.
RELEASE_KEY = "layers"


def split_release_tree(tree, key: str = RELEASE_KEY):
    """Split a gradient tree into (per-layer released subtree, residual).

    The released subtree is ``tree[key]`` — stacked per-layer leaves
    whose shared leading axis is the layer count — and the residual is
    everything else (embeddings, final norm, ...), synced post-backward.
    Returns ``(None, tree)`` when the tree has no release key."""
    if not isinstance(tree, dict) or key not in tree:
        return None, tree
    rest = {k: v for k, v in tree.items() if k != key}
    return tree[key], rest


def layer_slice_struct(layers):
    """Leaf structs of ONE layer's slice of a stacked subtree (leading
    layer axis dropped) — what each release event hands the sink, used
    to plan the per-release bucket layout without data."""
    return pytree.tree_map(
        lambda a: pytree.LeafStruct(tuple(a.shape[1:]), a.dtype), layers)


@dataclasses.dataclass(frozen=True)
class BucketSlot:
    """One leaf's home inside a bucket."""

    leaf: int               # index in tree-flatten order
    offset: int             # element offset within the bucket
    size: int               # element count (0 for zero-size leaves)
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A dtype-homogeneous fusion buffer."""

    dtype: str
    slots: Tuple[BucketSlot, ...]

    @property
    def elems(self) -> int:
        return sum(s.size for s in self.slots)

    @property
    def nbytes(self) -> int:
        return self.elems * pytree.itemsize(self.dtype)


@dataclasses.dataclass(frozen=True)
class BucketLayout:
    """Where every leaf of one tree lives across the fusion buckets."""

    buckets: Tuple[Bucket, ...]
    treedef: pytree.TreeDef
    n_leaves: int

    @classmethod
    def plan(cls, tree, bucket_bytes: int) -> "BucketLayout":
        """Pack the tree's leaves into buckets of ~``bucket_bytes``,
        leaves in tree order, via the ONE greedy rule (`pack_buckets`)
        the cost model also prices — the layout that runs is the layout
        that was tuned."""
        leaves, treedef = pytree.flatten(tree)
        sizes = [int(math.prod(leaf.shape)) for leaf in leaves]
        dtypes = [pytree.dtype_name(leaf.dtype) for leaf in leaves]
        packed = pack_buckets(
            [(size * pytree.itemsize(dt), dt)
             for size, dt in zip(sizes, dtypes)], bucket_bytes)
        buckets = []
        for dt, idxs in packed:
            slots, offset = [], 0
            for i in idxs:
                slots.append(BucketSlot(leaf=i, offset=offset,
                                        size=sizes[i],
                                        shape=tuple(leaves[i].shape)))
                offset += sizes[i]
            buckets.append(Bucket(dt, tuple(slots)))
        return cls(tuple(buckets), treedef, len(leaves))

    def flatten(self, tree) -> List[torch.Tensor]:
        """One flat 1-D buffer per bucket (pure concatenation)."""
        leaves = pytree.leaves(tree)
        assert len(leaves) == self.n_leaves, \
            f"tree has {len(leaves)} leaves, layout planned {self.n_leaves}"
        out = []
        for b in self.buckets:
            parts = [leaves[s.leaf].reshape(-1) for s in b.slots]
            out.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return out

    def unflatten(self, flats: Sequence[torch.Tensor]):
        """Invert :meth:`flatten` bit-identically (pure slicing)."""
        assert len(flats) == len(self.buckets)
        leaves = [None] * self.n_leaves
        for b, flat in zip(self.buckets, flats):
            for s in b.slots:
                leaves[s.leaf] = \
                    flat[s.offset:s.offset + s.size].reshape(s.shape)
        return self.treedef.unflatten(leaves)
