"""Paged KV cache: fixed-size block pool + free list + block tables
(port of ``repro/serve/paged_kv.py``).

Each KV leaf lives in a pool of ``block_size``-token blocks
``(lead, num_blocks, block_size, KV, Dh)`` instead of one dense
``(lead, R, T, KV, Dh)`` tensor, and each request slot owns an ordered
block table of pool-block ids. Admission allocates a table from the free
list; retiring (or preempting) a request returns its blocks.

Block 0 is reserved as the *null block*: inactive request slots keep
their table pointed at it, so gathers/scatters over the full fixed slot
axis keep one shape, and garbage written through inactive slots lands
harmlessly in block 0.

The logical per-request view is a ring buffer of ``view_len`` tokens
(position ``length % view_len`` holds the newest token), so a view
shorter than the longest sequence gives sliding-window serving.

Unlike the reference, whose arrays are immutable, ``write_view``,
``scatter_token`` and ``scatter_tokens`` update the pools IN PLACE
(``index_put_``). The serving engine's decode step uses none of
``gather_views``/``scatter_tokens``: each layer writes its token into the
pool in place and reads the pool through the tables
(``models/layers.attention_block``'s paged form). They stay for the
tests' dense oracle.
"""
from __future__ import annotations

import numpy as np
import torch


def gather_views(pools, tables, block_size: int):
    """Dense views of every slot through its block table.

    pools: leaf -> (lead, NB, bs, ...); tables: (R, nb) integer ids.
    Returns leaf -> (lead, R, nb*bs, ...): the layer-stacked batch cache
    that the batched ``decode_step`` takes (the reference returns the
    request axis first, for ``vmap``).
    """
    out = {}
    R, nb = tables.shape
    for name, pool in pools.items():
        v = pool[:, tables]                        # (lead, R, nb, bs, ...)
        out[name] = v.reshape(v.shape[0], R, nb * block_size, *v.shape[4:])
    return out


def scatter_tokens(pools, tables, views, positions, block_size: int) -> None:
    """Write back, in place, the single view slot each request just filled.

    ``views`` maps leaf -> ``(lead, R, view_len, ...)``; ``positions`` is the
    ``(R,)`` ring slot written (``old_length % view_len``). Live block
    tables are disjoint, so the scatter has no collisions among live
    slots; inactive slots target the null block, whose contents are never
    read as valid.
    """
    R = tables.shape[0]
    rows = torch.arange(R, device=tables.device)
    pos = torch.as_tensor(positions, device=tables.device).long()
    blk = tables[rows, pos // block_size]               # (R,)
    off = pos % block_size                              # (R,)
    for name, view in views.items():
        vals = view[:, rows, pos]                       # (lead, R, ...)
        pools[name][:, blk, off] = vals.to(pools[name].dtype)


class BlockPool:
    """Host-side free list over ``num_blocks`` pool blocks.

    Block 0 is reserved (null block) and never handed out.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least one allocatable block beyond null")
        self.num_blocks = num_blocks
        # LIFO keeps recently-freed blocks hot; ids 1..num_blocks-1.
        self._free = list(range(num_blocks - 1, 0, -1))

    @property
    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """Allocate ``n`` blocks, or return None (and nothing) if short."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks) -> None:
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"freeing invalid block {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
            self._free.append(b)


class PagedKV:
    """Block-pooled storage for the ``k``/``v`` leaves of a family cache.

    ``templates`` maps leaf name -> per-request dense leaf of shape
    ``(lead, 1, view_len, KV, Dh)`` (the shape ``init_cache(batch=1)``
    produces); all leaves share one block table per request slot. The
    pools take the templates' dtype and device.
    """

    def __init__(self, templates, *, block_size: int, max_requests: int,
                 num_blocks: int | None = None):
        shapes = {n: tuple(t.shape) for n, t in templates.items()}
        view_lens = {s[2] for s in shapes.values()}
        if len(view_lens) != 1:
            raise ValueError(f"paged leaves disagree on view length: {shapes}")
        (self.view_len,) = view_lens
        if self.view_len % block_size != 0:
            raise ValueError(
                f"view length {self.view_len} not divisible by "
                f"block size {block_size}")
        self.block_size = block_size
        self.blocks_per_request = self.view_len // block_size
        self.max_requests = max_requests
        if num_blocks is None:
            num_blocks = 1 + max_requests * self.blocks_per_request
        self.pool_mgr = BlockPool(num_blocks)
        self.device = next(iter(templates.values())).device
        self.pools = {
            n: torch.zeros(
                (t.shape[0], num_blocks, block_size) + tuple(t.shape[3:]),
                dtype=t.dtype, device=t.device)
            for n, t in templates.items()
        }
        self._tables = np.zeros((max_requests, self.blocks_per_request),
                                np.int32)
        self._owned: dict[int, list[int]] = {}
        self._tables_dev = None

    # -- allocation --------------------------------------------------------

    @property
    def available_blocks(self) -> int:
        return self.pool_mgr.available

    def admit(self, slot: int) -> bool:
        """Allocate a full block table for request slot ``slot``."""
        if slot in self._owned:
            raise ValueError(f"slot {slot} already admitted")
        blocks = self.pool_mgr.alloc(self.blocks_per_request)
        if blocks is None:
            return False
        self._owned[slot] = blocks
        self._tables[slot] = blocks
        self._tables_dev = None
        return True

    def release(self, slot: int) -> None:
        """Free ``slot``'s blocks (retire or preempt)."""
        self.pool_mgr.free(self._owned.pop(slot))
        self._tables[slot] = 0
        self._tables_dev = None

    def blocks_of(self, slot: int):
        return list(self._owned[slot])

    @property
    def tables(self) -> torch.Tensor:
        """(max_requests, blocks_per_request) int32 block table, on device:
        the dtype the paged-attention kernel reads, so a decode step hands
        it over without a conversion."""
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self._tables.copy()).to(
                self.device)
        return self._tables_dev

    # -- data movement -----------------------------------------------------

    def write_view(self, slot: int, views) -> None:
        """Scatter a dense per-request view into ``slot``'s blocks, in place.

        ``views`` maps leaf name -> ``(lead, 1, view_len, KV, Dh)`` (the
        batch-1 cache leaf). Used after prefill: the prefilled dense cache
        leaf lands in the freshly allocated blocks, cast to the pool's
        dtype.
        """
        blocks = torch.tensor(self._owned[slot], device=self.device)
        nb, bs = self.blocks_per_request, self.block_size
        for name, view in views.items():
            pool = self.pools[name]
            if view.shape[1] != 1 or view.shape[2] != self.view_len:
                raise ValueError(f"view {tuple(view.shape)} is not a batch-1 "
                                 f"cache of length {self.view_len}")
            v = view[:, 0]                               # (lead, view_len, ...)
            v = v.reshape(v.shape[0], nb, bs, *v.shape[2:])
            pool[:, blocks] = v.to(pool.dtype)

    def gather(self):
        """Dense views for every slot: leaf -> (lead, R, view_len, ...).

        Inactive slots read the null block (garbage, discarded).
        """
        return gather_views(self.pools, self.tables, self.block_size)

    def scatter_token(self, views, positions) -> None:
        """Write back, in place, the one view slot each request just filled.

        ``views`` maps leaf name -> ``(lead, R, view_len, ...)`` (the
        post-decode dense views); ``positions`` is the ``(R,)`` ring slot
        each request wrote (``old_length % view_len``).
        """
        scatter_tokens(self.pools, self.tables, views, positions,
                       self.block_size)
