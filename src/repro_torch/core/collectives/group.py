"""The rank transport: what stands in for ``shard_map``, ``axis_index`` and
``jax.lax.ppermute`` in the reference.

The reference runs an algorithm once, as one SPMD program over a mesh
axis. The port runs it in every process of a ``torch.distributed`` group,
rank-local: ``rank()`` is a Python int, and each ``ppermute`` is one
round between the pairs the permutation names.

Ranks on one card. NCCL refuses two ranks on one device, so the ranks are
processes under a ``gloo`` group, each holding its buffers on ``cuda:0``.
A CUDA payload stays on the card: it crosses through an `Arena`, device
memory that every rank of the axis maps with CUDA IPC. Each axis (and
the default group) has its own arena in every rank, two slots used in
turn, allocated at its first CUDA collective; the ranks exchange its IPC
handles once over the axis's ``gloo`` group, and again after it grows
(in lockstep: every rank issues the same collective with the same
shape, so every rank computes the same new size), up to
`ARENA_MAX_BYTES` a slot: a larger payload crosses in rounds of a slot
each, which bounds the transport's memory. A writer copies its
payload into its own slot, synchronizes its stream and raises its
counter in a small block of host memory the ranks of the axis share;
each reader waits for every counter, then reads the peers' slots on its
own stream. The counters order both hazards: a slot is read only after
its copy has landed, and a slot is written again two collectives later,
after every rank has passed the signal of the one between, which each
rank gives only once its reads of the last one are done. A map that
fails raises and names the error. The reduce steps of the tuned
algorithms run in the ``segment_combine`` kernel; the built-ins sum, or
take the max, in axis order in the payload's dtype, so their result is
the same bits on every rank. A CPU tensor keeps the ``gloo`` wire, and
object collectives (`broadcast_object`, `max_over_ranks`, `barrier`)
stay on it too. This module is the whole transport: a multi-card NCCL
path would change nothing above it.

``ppermute`` keeps ``jax.lax.ppermute``'s semantics exactly: a rank that
is no destination in ``perm`` gets zeros, a rank may send without
receiving, and a pair ``(i, i)`` is a local copy. Sources and
destinations must each be unique, as in JAX. On the card every rank of
the axis takes part in each round, as every rank of the SPMD program
calls it.

The ``"xla"`` algorithms use the backend's built-ins: ``psum``,
``all_gather`` and ``all_to_all``; ``pmax`` serves the vocab-parallel
loss's row max.

Threads. Every function here may be called from any one thread of a
rank, as long as no other thread of that rank issues a collective over
the same axis at the same time, and every rank issues the collectives of
an axis in one order. Two threads may use two axes at once: each axis
has its own ``gloo`` group, arena and counters. `SyncThread` is the one
place the port calls them off the main thread: the backward-overlapped
gradient sync hands it one job a released layer while autograd runs the
layers below, and the job's collectives run over the data tiers while
the backward's own, on a ``model`` axis, run over ``model`` on the main
thread. On the card the thread works on a CUDA stream of its own, so
the transport's stream synchronizes wait for the sync's own copies and
kernels, not for the backward queued on the main stream.

Mesh axes. The reference's ``Mesh`` names its axes and ``shard_map``
runs a collective over one of them. `RankMesh` is the port's
counterpart: built inside every rank after ``init_process_group``, it
lays the ranks out row-major over the axis names (rank ``r`` holds what
device ``r`` of the reference's mesh holds), or in a tuned
``device_order`` (flat slot ``i`` holds rank ``device_order[i]``, as a
mapped mesh's ``mesh.devices``), and keeps, for each axis, this rank's
``gloo`` sub-group of the ranks that differ only along that axis, as an
`Axis` (name, group, size, slot order). An axis index is the rank's
coordinate along the axis, whatever its global rank: ``rank(axis)``,
``ppermute``'s pairs and the order of ``all_gather`` and ``all_to_all``
blocks all count in it. Every function here takes an `Axis`, a process
group, or ``None`` (the default group).

The recording mesh. `MetaMesh` has `RankMesh`'s interface but no
process group: it stands for one rank, at ``coords``, of a mesh of any
size (the reference's 16 x 16 production mesh), and needs no
``torch.distributed``. Its axes are `MetaAxis` objects, and every
collective here over one moves nothing: it returns a ``meta`` tensor of
the result's shape and type (an object collective returns this rank's
own object). Every tensor collective, over a meta axis or a real one,
adds ``(kind, axis name, output bytes)`` to the open `Record`, under
the reference's names (``all-reduce``, ``all-gather``,
``reduce-scatter``, ``all-to-all``, ``collective-permute``) and its
rule of bytes: the output's, per rank (``hlo_analysis.collective_bytes``
sums the output shapes of the HLO's collectives). So a run on real
ranks and a trace on a `MetaMesh` can be compared op for op.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import functools
import mmap
import os
import pickle
import queue
import shutil
import sys
import tempfile
import threading
import time
import traceback
import zlib
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.reductions import rebuild_cuda_tensor, reduce_tensor

from repro_torch import count, pytree

#: how long a rank waits on a collective (and on sub-group creation)
#: before it fails instead of hanging
TIMEOUT_S = 600.0
#: what the ``forkserver`` imports once for every group `spawn` starts
#: (torch alone: a module that ran a parallel op at import would leave
#: the forked ranks a dead OpenMP pool)
FORKSERVER_PRELOAD = ["torch"]


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One mesh axis as this rank sees it: the axis name, the ``gloo``
    sub-group of the ranks along it, and its size. ``order[i]`` is the
    group rank at axis index ``i`` where the two differ (a mapped mesh:
    a ``gloo`` group numbers its members by global rank), else None."""

    name: str
    group: object
    size: int
    order: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True, eq=False)
class MetaAxis(Axis):
    """An axis of a `MetaMesh`: no process group, this rank's coordinate
    ``index`` along it."""

    index: int = 0


def _meta(group) -> bool:
    return isinstance(group, MetaAxis)


def _pg(group):
    return group.group if isinstance(group, Axis) else group


def _order(group) -> Optional[Tuple[int, ...]]:
    return group.order if isinstance(group, Axis) else None


def rank(group=None) -> int:
    """This rank's index along ``group`` (its axis coordinate)."""
    if _meta(group):
        return group.index
    r = dist.get_rank(_pg(group))
    order = _order(group)
    return r if order is None else order.index(r)


def size(group=None) -> int:
    if _meta(group):
        return group.size
    return dist.get_world_size(_pg(group))


def barrier(group=None) -> None:
    if not _meta(group):
        dist.barrier(_pg(group))


def _peer(group, r: int) -> int:
    """The global rank at index ``r`` along ``group``."""
    order = _order(group)
    r = r if order is None else order[r]
    pg = _pg(group)
    return r if pg is None else dist.get_global_rank(pg, r)


def _copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of CPU tensor x that the caller may overwrite
    (what the ``gloo`` wire sends and reduces in place)."""
    return x.detach().clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# the arena: CUDA payloads cross on the card
# ---------------------------------------------------------------------------
#: an arena's first slot size in bytes; a larger payload grows it
ARENA_MIN_BYTES = 1 << 20
#: the largest slot: a larger payload crosses in rounds of a slot each,
#: so an axis's arena holds at most two of them
ARENA_MAX_BYTES = 64 << 20
#: how often a rank waiting on the arena's counters yields its core before
#: it sleeps between reads
SPINS = 200
#: the sleep between reads after that, in seconds
SPIN_SLEEP_S = 20e-6


class CudaIpc:
    """An arena's mapping step on the card: the memory is a CUDA
    allocation on ``device`` and a peer maps it through CUDA IPC (the
    handle `torch.multiprocessing` sends for a CUDA tensor)."""

    name = "CUDA IPC"

    def alloc(self, nbytes: int, device) -> torch.Tensor:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)

    def share(self, mem: torch.Tensor):
        return reduce_tensor(mem)[1]

    def open(self, handle) -> torch.Tensor:
        return rebuild_cuda_tensor(*handle)


class _Counters:
    """The arena's signal: one int64 counter a rank and two tags a rank
    (a collective's kind, shape and pairs, by the parity of its count) in
    a file of host memory that every rank of the group maps. Rank 0 of
    the group makes the file and sends its path over the group; it is
    unlinked once every rank holds the map (`unlink`)."""

    def __init__(self, pg, size: int, me: int):
        self.size, self.me = size, me       # me: this rank in the group
        nbytes = 8 * 3 * size
        self._dir = None
        if me == 0:
            self._dir = tempfile.mkdtemp(prefix="repro_torch_arena_")
            path = os.path.join(self._dir, "counters")
            with open(path, "wb") as f:
                f.write(bytes(nbytes))
        else:
            path = None
        box = [path]
        dist.broadcast_object_list(
            box, src=0 if pg is None else dist.get_global_rank(pg, 0),
            group=pg)
        with open(box[0], "r+b") as f:
            self._map = mmap.mmap(f.fileno(), nbytes)
        flat = np.frombuffer(self._map, dtype=np.int64)
        self.counts = flat[:size]
        self.tags = flat[size:].reshape(size, 2)

    def unlink(self) -> None:
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def signal(self, seq: int, tag: int, what: str) -> None:
        """Raise this rank's counter to ``seq`` and wait until every rank's
        has reached it; raises if a rank's tag for ``seq`` differs (the
        ranks issued different collectives) or after `TIMEOUT_S`."""
        self.tags[self.me, seq % 2] = tag
        self.counts[self.me] = seq
        spins, deadline = 0, None
        while int(self.counts.min()) < seq:
            spins += 1
            if spins < SPINS:
                os.sched_yield()
                continue
            if deadline is None:
                deadline = time.monotonic() + TIMEOUT_S
            elif time.monotonic() > deadline:
                late = [j for j in range(self.size) if self.counts[j] < seq]
                raise RuntimeError(f"{what}: ranks {late} did not reach "
                                   f"collective {seq} in {TIMEOUT_S:.0f} s")
            time.sleep(SPIN_SLEEP_S)
        tags = self.tags[:, seq % 2]
        if (tags != tag).any():
            raise RuntimeError(f"{what}: the ranks issued different "
                               f"collectives as number {seq} (tags "
                               f"{tags.tolist()})")


class Arena:
    """The memory one axis's CUDA payloads cross through, in this rank:
    two slots of ``capacity`` bytes (collective ``n`` writes slot ``n %
    2``), the peers' arenas mapped by ``backing`` (`CudaIpc`, or a test's
    shared host memory), and the counters that order the copies (see the
    module's text). ``pg`` and ``order`` are the axis's ``gloo`` group
    and slot order (`Axis`). Made at no cost; the first collective
    allocates and maps, collectively. Every rank of the axis must call
    each collective, with the same shape, in one order."""

    def __init__(self, pg, order: Optional[Tuple[int, ...]], backing,
                 name: str = "world"):
        self.pg, self.order, self.backing, self.name = pg, order, backing, name
        self.size = dist.get_world_size(pg)
        g = dist.get_rank(pg)
        self.index = g if order is None else order.index(g)
        self.capacity = 0
        self.seq = 0
        self._arenas: list = []         # every rank's, by axis index
        self._counters: Optional[_Counters] = None
        self._reads = None              # event after the last reads

    # -- set-up and growth ------------------------------------------------
    def _quiesce(self) -> None:
        """Wait for this rank's reads of the last collective."""
        if self._reads is not None:
            self._reads.synchronize()

    def _grow(self, nbytes: int, device) -> None:
        """Reallocate both slots at ``nbytes`` or more and map the peers'
        new arenas (collective over the group: each rank grows at the
        same collective, to the same size). The old arenas are dropped
        only after the exchange, by which every rank's reads of them are
        done."""
        cap = min(max(ARENA_MIN_BYTES, 2 * self.capacity, nbytes),
                  ARENA_MAX_BYTES)
        cap = -(-cap // ARENA_MIN_BYTES) * ARENA_MIN_BYTES
        self._quiesce()
        if self._counters is None:
            self._counters = _Counters(self.pg, self.size,
                                       dist.get_rank(self.pg))
        mine = self.backing.alloc(2 * cap, device)
        handles = [None] * self.size
        dist.all_gather_object(handles, self.backing.share(mine),
                               group=self.pg)
        self._counters.unlink()                 # every rank has mapped it
        peers = []
        for j in range(self.size):
            g = j if self.order is None else self.order[j]
            if j == self.index:
                peers.append(mine)
                continue
            try:
                peers.append(self.backing.open(handles[g]))
            except Exception as e:      # the map failed: name it, no fallback
                raise RuntimeError(
                    f"{self.backing.name} map of axis {self.name}'s arena "
                    f"of its rank {j} failed: {type(e).__name__}: {e}") from e
        self._arenas, self.capacity = peers, cap

    def drop_peers(self) -> None:
        """Drop the peers' maps (after this rank's reads of them)."""
        self._quiesce()
        self._arenas = [a if j == self.index else None
                        for j, a in enumerate(self._arenas)]

    def close(self) -> None:
        """Drop the peers' maps and this rank's slots."""
        self.drop_peers()
        self._arenas, self.capacity = [], 0
        if self._counters is not None:
            self._counters.unlink()

    # -- one collective -----------------------------------------------------
    def _rounds(self, x2: torch.Tensor, kind: str, write: bool = True,
                extra=()):
        """The rounds of one collective over ``x2`` (rows, m): each takes
        columns ``a:b`` of every row, at most a slot of bytes. Per round
        this rank copies its piece into its slot (unless not ``write``)
        and signals, then yields ``(a, b, views)``, ``views[j]`` rank j's
        piece in axis order (this rank's own at its index); once the
        caller has queued its reads, the next round begins."""
        rows, m = x2.shape
        step = max(1, ARENA_MAX_BYTES // max(1, rows * x2.element_size()))
        for a in range(0, m, step):
            b = min(m, a + step)
            piece = x2[:, a:b]
            nbytes = piece.numel() * piece.element_size()
            if nbytes > self.capacity:
                self._grow(nbytes, x2.device)
            self.seq += 1
            off = (self.seq % 2) * self.capacity
            views = [piece if j == self.index else
                     self._arenas[j][off:off + nbytes].view(x2.dtype)
                     .view(rows, b - a) for j in range(self.size)]
            if write:
                self._arenas[self.index][off:off + nbytes].view(
                    x2.dtype).view(rows, b - a).copy_(piece)
            if x2.device.type == "cuda":
                torch.cuda.current_stream(x2.device).synchronize()
            self._quiesce()
            tag = zlib.crc32(repr((kind, tuple(x2.shape), str(x2.dtype),
                                   a, b, extra)).encode())
            self._counters.signal(self.seq, tag,
                                  f"{kind} over axis {self.name}")
            yield a, b, views
            if x2.device.type == "cuda":
                if self._reads is None:
                    self._reads = torch.cuda.Event()
                self._reads.record(torch.cuda.current_stream(x2.device))

    def _reduce(self, x2: torch.Tensor, row: int, kind: str,
                op) -> torch.Tensor:
        """Row ``row`` of x2 combined over the ranks by ``op`` (in place on
        its first argument) in axis order: the same bits on every rank."""
        out = torch.empty(x2.shape[1], dtype=x2.dtype, device=x2.device)
        for a, b, views in self._rounds(x2, kind):
            o = out[a:b]
            o.copy_(views[0][row])
            for v in views[1:]:
                op(o, v[row])
        return out

    @torch.no_grad()
    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the axis in axis order, in x's dtype (the same bits on
        every rank)."""
        return self._reduce(x.detach().reshape(1, -1), 0, "psum",
                            torch.Tensor.add_).view(x.shape)

    @torch.no_grad()
    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x.detach().reshape(1, -1), 0, "pmax",
                            lambda o, v: torch.maximum(o, v, out=o)
                            ).view(x.shape)

    @torch.no_grad()
    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Block ``index`` of axis 0 summed over the ranks in axis order."""
        out = self._reduce(x.detach().reshape(self.size, -1), self.index,
                           "reduce_scatter", torch.Tensor.add_)
        return out.view((x.shape[0] // self.size,) + tuple(x.shape[1:]))

    def _gather(self, x2: torch.Tensor, row: int, kind: str) -> torch.Tensor:
        """Row ``row`` of every rank's x2, stacked in axis order."""
        out = torch.empty((self.size, x2.shape[1]), dtype=x2.dtype,
                          device=x2.device)
        for a, b, views in self._rounds(x2, kind):
            for j, v in enumerate(views):
                out[j, a:b].copy_(v[row])
        return out

    @torch.no_grad()
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        out = self._gather(x.detach().reshape(1, -1), 0, "all_gather")
        return out.view((self.size * x.shape[0],) + tuple(x.shape[1:]))

    @torch.no_grad()
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(x.detach().reshape(self.size, -1), self.index,
                            "all_to_all").view(x.shape)

    @torch.no_grad()
    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        x = x.detach()
        r = self.index
        src = [s for s, d in perm if d == r]
        if all(s == d for s, d in perm):        # no pair crosses: no round
            return x.clone() if src else torch.zeros_like(x)
        sends = any(s == r and d != r for s, d in perm)
        out = torch.zeros(x.numel(), dtype=x.dtype, device=x.device)
        for a, b, views in self._rounds(x.reshape(1, -1), "ppermute",
                                        write=sends,
                                        extra=tuple(sorted(perm))):
            if src:
                out[a:b].copy_(views[src[0]][0])
        return out.view(x.shape)


#: this process's arenas, by (process group, slot order)
_ARENAS: dict = {}
_ARENAS_LOCK = threading.Lock()


def _arena(group) -> Arena:
    """The `Arena` of ``group`` in this process, made on first use."""
    key = (_pg(group), _order(group))
    with _ARENAS_LOCK:
        arena = _ARENAS.get(key)
        if arena is None:
            arena = _ARENAS[key] = Arena(key[0], key[1], CudaIpc(),
                                         _axis_name(group))
    return arena


def close_arenas() -> None:
    """Release every arena of this process: the peers' maps first, then,
    once every rank of the default group has dropped its own (a barrier),
    this rank's memory. Collective over the default group."""
    with _ARENAS_LOCK:
        arenas = list(_ARENAS.values())
        _ARENAS.clear()
    for arena in arenas:
        arena.drop_peers()
    dist.barrier()
    for arena in arenas:
        arena.close()


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """One round of point-to-point sends: rank ``s`` sends ``x`` to rank
    ``d`` for every ``(s, d)`` in ``perm``; returns what this rank
    received, or zeros of x's shape where it is no destination."""
    srcs = [s for s, _ in perm]
    dsts = [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError(f"ppermute sources and destinations must be "
                         f"unique: {list(perm)}")
    _note("collective-permute", group, x.numel() * x.element_size())
    if _meta(group):
        return _meta_result(x, tuple(x.shape))
    with count.hidden():
        if x.device.type == "cuda":
            return _arena(group).ppermute(x, perm)
        return _permute_round(x, perm, group)


def _permute_round(x, perm, group):
    """`ppermute` of a CPU tensor over the ``gloo`` wire."""
    r = rank(group)
    send_to = [d for s, d in perm if s == r]
    recv_from = [s for s, d in perm if d == r]
    if not recv_from and not send_to:
        return torch.zeros_like(x)
    if send_to == [r]:                       # (r, r): a local copy
        return x.clone()
    ops = []
    if send_to:
        ops.append(dist.P2POp(dist.isend, x.detach().contiguous(),
                              _peer(group, send_to[0]), _pg(group)))
    if recv_from:
        buf = torch.empty(x.shape, dtype=x.dtype)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, recv_from[0]),
                              _pg(group)))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not recv_from:
        return torch.zeros_like(x)
    return buf


class Record:
    """The collectives this process issues while it is open (``with
    Record() as rec:``), over real axes and meta axes alike: ``entries``
    holds ``(kind, axis name, output bytes)`` in issue order, with the
    reference's kinds (``KINDS``). An axis is named by its `Axis` name
    (``"data"``, ``"model"``, ``"pod,data"`` for a joint axis), a bare
    process group ``"world"``. Object collectives (`broadcast_object`)
    move pickles, not tensors, and are not recorded."""

    KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

    def __init__(self):
        self.entries: list = []

    def __enter__(self) -> "Record":
        _RECORDS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _RECORDS.remove(self)

    def by_kind(self) -> dict:
        """``{"kind@axis": {"count": n, "bytes": b}}``, sorted."""
        out: dict = {}
        for kind, axis, nbytes in self.entries:
            e = out.setdefault(f"{kind}@{axis}", {"count": 0, "bytes": 0})
            e["count"] += 1
            e["bytes"] += nbytes
        return dict(sorted(out.items()))

    def totals(self) -> dict:
        """Bytes by kind and the number of collectives: the reference's
        ``hlo_analysis.collective_bytes`` record."""
        out = {k: 0 for k in self.KINDS}
        for kind, _, nbytes in self.entries:
            out[kind] += nbytes
        out["count"] = len(self.entries)
        return out


#: the open `Record`s
_RECORDS: list = []


def _axis_name(group) -> str:
    return group.name if isinstance(group, Axis) else "world"


def _note(kind: str, group, nbytes: int) -> None:
    for rec in _RECORDS:
        rec.entries.append((kind, _axis_name(group), int(nbytes)))


def _meta_result(x: torch.Tensor, shape) -> torch.Tensor:
    """What a collective over a meta axis returns: a meta tensor of the
    result's shape and x's type."""
    return torch.empty(shape, dtype=x.dtype, device="meta")


#: the bytes a collective over a meta axis records, ``fn(kind, x, out)``
#: (a planted fault swaps it: `planted_record_fault`)
_META_BYTES = {"fn": lambda kind, x, out: out.numel() * out.element_size()}


@contextlib.contextmanager
def planted_record_fault():
    """For the length of the block a reduce-scatter over a meta axis
    records its input's bytes instead of its output's, so that a check
    of the recording can show it fails."""
    saved = _META_BYTES["fn"]
    _META_BYTES["fn"] = lambda kind, x, out: \
        x.numel() * x.element_size() if kind == "reduce-scatter" \
        else saved(kind, x, out)
    try:
        yield
    finally:
        _META_BYTES["fn"] = saved


def _collective(kind: str, shape_of: Callable):
    """``fn(x, group)`` as a recorded collective of ``kind`` whose result
    has shape ``shape_of(x.shape, axis size)``: over a meta axis it moves
    nothing and returns a meta tensor of that shape; over a real one it
    runs ``fn``, whose transport the work count does not see."""
    def deco(fn):
        @functools.wraps(fn)
        def inner(x, group=None):
            if _meta(group):
                out = _meta_result(x, shape_of(tuple(x.shape), group.size))
                _note(kind, group, _META_BYTES["fn"](kind, x, out))
                return out
            with count.hidden():
                out = fn(x, group)
            _note(kind, group, out.numel() * out.element_size())
            return out
        return inner
    return deco


def _same(shape, n):
    return shape


def _tiled(shape, n):
    return (shape[0] * n,) + shape[1:]


def _scattered(shape, n):
    return (shape[0] // n,) + shape[1:]


class Tally:
    """Counts and times the collectives this process issues over one mesh
    axis, by its name (``"model"``), while it is open (``with
    Tally("model", device):``; the training step opens one a step).
    ``counts`` is by function (``psum``, ``pmax``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``), ``seconds`` their sum, each
    between two synchronizations of the calling thread's stream on
    ``device`` (on the card; the transport waits for the work queued
    before a collective anyway, so the first costs nothing more, and a
    sync thread's stream is not waited for). Collectives on other axes,
    or on a process group that is not an `Axis`, are not counted."""

    def __init__(self, axis_name: str, device=None):
        self.axis_name = axis_name
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.counts: "collections.Counter" = collections.Counter()
        self.seconds = 0.0
        self._prev = None

    def __enter__(self) -> "Tally":
        global _TALLY
        self._prev, _TALLY = _TALLY, self
        return self

    def __exit__(self, *exc) -> None:
        global _TALLY
        _TALLY = self._prev

    def clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return time.perf_counter()


#: the open `Tally`, or None
_TALLY: Optional[Tally] = None


def _tallied(fn):
    """``fn(x, group)``, counted and timed by the open `Tally` when
    ``group`` is the axis it counts."""
    @functools.wraps(fn)
    def inner(x, group=None):
        t = _TALLY
        if t is None or not isinstance(group, Axis) or \
                group.name != t.axis_name:
            return fn(x, group)
        t0 = t.clock()
        out = fn(x, group)
        t.seconds += t.clock() - t0
        t.counts[fn.__name__] += 1
        return out
    return inner


@_tallied
@_collective("all-reduce", _same)
def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (sum), out of place."""
    if x.device.type == "cuda":
        return _arena(group).psum(x)
    buf = _copy(x)
    dist.all_reduce(buf, group=_pg(group))
    return buf


@_tallied
@_collective("all-reduce", _same)
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (elementwise max), out of place."""
    if x.device.type == "cuda":
        return _arena(group).pmax(x)
    buf = _copy(x)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=_pg(group))
    return buf


@_tallied
@_collective("all-gather", _tiled)
def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-gather, concatenated along axis 0 (tiled)."""
    if x.device.type == "cuda":
        return _arena(group).all_gather(x)
    buf = _copy(x)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=_pg(group))
    order = _order(group)
    if order is not None:                     # group rank -> axis order
        parts = [parts[g] for g in order]
    return torch.cat(parts, dim=0)


@_tallied
@_collective("reduce-scatter", _scattered)
def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's reduce-scatter (sum): axis 0 split into p equal
    blocks, and this rank gets the sum over the ranks of block i, i its
    index along ``group`` (``jax.lax.psum_scatter(scatter_dimension=0,
    tiled=True)``, the transpose of `all_gather`)."""
    if x.device.type == "cuda":
        return _arena(group).reduce_scatter(x)
    buf = _copy(x)
    n = size(group)
    order = _order(group)
    if order is not None:          # block i goes to group rank order[i]
        blocks = buf.chunk(n)
        buf = torch.cat([blocks[order.index(g)] for g in range(n)])
    out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]),
                      dtype=buf.dtype)
    dist.reduce_scatter_tensor(out, buf, group=_pg(group))
    return out


@_tallied
@_collective("all-to-all", _same)
def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-to-all: axis 0 split into p equal blocks, block
    j goes to rank j, and the received blocks are stacked in rank order
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    if x.device.type == "cuda":
        return _arena(group).all_to_all(x)
    buf = _copy(x)
    order = _order(group)
    if order is not None:          # block j goes to group rank order[j]
        blocks = buf.chunk(len(order))
        inv = [order.index(g) for g in range(len(order))]
        buf = torch.cat([blocks[j] for j in inv])
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=_pg(group))
    if order is not None:          # received in group-rank order
        blocks = out.chunk(len(order))
        out = torch.cat([blocks[g] for g in order])
    return out


def broadcast_object(obj, group=None):
    """``obj`` (picklable) of the rank at index 0 along ``group``, on
    every rank; the other ranks' ``obj`` is ignored (over a meta axis,
    this rank's own)."""
    if _meta(group):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=_peer(group, 0), group=_pg(group))
    return box[0]


def max_over_ranks(values: Sequence[float], group=None) -> list:
    """Elementwise maximum of ``values`` over the ranks, on every rank
    (over a meta axis, this rank's own)."""
    _note("all-reduce", group, 8 * len(values))
    if _meta(group):
        return list(values)
    with count.hidden():
        t = torch.tensor(list(values), dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_pg(group))
        return t.tolist()


class SyncThread:
    """One thread that runs the jobs handed to `submit` in submission
    order, each to its end, then returns their results from `join`.

    On a CUDA ``device`` the thread runs every job on its own stream:
    `submit` records an event on the submitting thread's current stream
    (the stream that produced the job's tensors), the job's stream waits
    for it before the job starts, and each tensor among the job's
    arguments is marked as used on the job's stream (``record_stream``),
    so the caching allocator does not hand its memory out again while
    the job may still read it. `join` makes the joining thread's current
    stream wait for the job stream and marks every tensor of the results
    as used there. A job that raises ends the thread's work (the jobs
    after it are skipped): `join` raises its error. ``busy_s`` sums the
    jobs' seconds on the thread's clock."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self.busy_s = 0.0
        self._jobs: "queue.Queue" = queue.Queue()
        self._results: list = []
        self._error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, fn: Callable, *args) -> None:
        """Queue ``fn(*args)`` behind the jobs already submitted."""
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record()
            for t in pytree.leaves(args):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(self.stream)
        self._jobs.put((fn, args, event))

    def _run(self) -> None:
        while True:
            job = self._jobs.get()
            if job is None:                   # join's end marker
                return
            if self._error is not None:
                continue
            fn, args, event = job
            t0 = time.perf_counter()
            try:
                if self.stream is None:
                    self._results.append(fn(*args))
                else:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(self.stream):
                        self.stream.wait_event(event)
                        self._results.append(fn(*args))
            except Exception as e:            # raised again by join
                self._error = e
            self.busy_s += time.perf_counter() - t0

    def join(self) -> list:
        """Wait for every job; returns their results in order."""
        self._jobs.put(None)
        self._thread.join()
        if self._error is not None:
            raise self._error
        if self.stream is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_stream(self.stream)
            for t in pytree.leaves(self._results):
                if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                    t.record_stream(current)
        return self._results


# ---------------------------------------------------------------------------
# the mesh of ranks
# ---------------------------------------------------------------------------
class RankMesh:
    """The ranks of the default group laid out over named axes (the
    reference's ``Mesh``; ``shape`` and ``axis_names`` read alike):
    row-major, or flat slot ``i`` holding rank ``device_order[i]`` (a
    tuned `MeshMapping`'s order, the mapped mesh's ``mesh.devices``).

    Creating one is collective: every rank of the default group must
    build the same mesh, in the same order as any other mesh, because
    each ``dist.new_group`` call is (a rank that skips one hangs the
    others until the timeout). ``device`` is where this rank keeps its
    buffers (``group.device_of``), for code that makes its own."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 device=None, timeout_s: float = TIMEOUT_S,
                 device_order: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} must pair up, names unique")
        world = size()
        if int(np.prod(shape)) != world:
            raise ValueError(f"mesh {shape} needs {int(np.prod(shape))} "
                             f"ranks, the group has {world}")
        order = np.arange(world) if device_order is None \
            else np.asarray([int(r) for r in device_order])
        if sorted(order.tolist()) != list(range(world)):
            raise ValueError(f"device_order must be a permutation of "
                             f"0..{world - 1}; got {list(order)}")
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        #: global rank at each mesh coordinate (the reference's
        #: ``mesh.devices``)
        self.ranks = order.reshape(shape)
        self.device = device
        self.timeout_s = timeout_s
        self._axes = {}
        for name in axis_names:
            self._axes[name] = self._line_axis((name,))

    def _line_axis(self, names: Tuple[str, ...]) -> Axis:
        """This rank's `Axis` over the ranks that differ only along
        ``names`` (their coordinates row-major in mesh order). Collective
        unless the other axes hold one rank: then the line is the whole
        default group and no group is made."""
        idx = [self.axis_names.index(n) for n in names]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        n = int(np.prod([self.ranks.shape[i] for i in idx]))
        lines = np.transpose(self.ranks, rest + idx).reshape(-1, n)
        name = names[0] if len(names) == 1 else ",".join(names)
        if len(names) > 1 and len(lines) == 1:
            order = tuple(int(g) for g in lines[0])
            return Axis(name, None, n,
                        None if order == tuple(range(n)) else order)
        me = rank()
        timeout = datetime.timedelta(seconds=self.timeout_s)
        axis = None
        for line in lines:                        # every rank, same order
            pg = dist.new_group(line.tolist(), timeout=timeout)
            if me in line:
                groups = tuple(dist.get_group_rank(pg, int(g))
                               for g in line)
                axis = Axis(name, pg, n,
                            None if groups == tuple(range(n)) else groups)
        return axis

    def axis(self, name: str) -> Axis:
        """This rank's sub-group along ``name``."""
        return self._axes[name]

    def joint(self, names: Sequence[str]) -> Axis:
        """This rank's sub-group over the axes ``names`` together (in
        mesh order), its index the row-major coordinate on them: the
        reference's collective over a tuple of axes (``psum(x, ("pod",
        "data"))``). With a ``model`` axis above 1 it is this rank's
        line: the ranks of its model coordinate, in the mesh's (or the
        mapping's) slot order. Made on first use and kept; the first call
        for a set of names is collective when the other axes hold more
        than one rank: every rank makes every line's group, in the same
        order, so a caller makes it where every rank runs the same code
        (the training step makes the data axes' when it is built, not in
        the forward, where another rank may be inside a model-axis
        collective)."""
        names = tuple(n for n in self.axis_names if n in names)
        if len(names) == 1:
            return self._axes[names[0]]
        if names not in self._axes:
            self._axes[names] = self._line_axis(names)
        return self._axes[names]

    @property
    def size(self) -> int:
        return int(self.ranks.size)


class MetaMesh:
    """A recording mesh: `RankMesh`'s interface (``axis_names``, ``shape``,
    ``ranks``, ``axis``, ``joint``, ``size``) over no process group,
    standing for the rank at ``coords`` (default: every coordinate 0,
    the device whose program the reference reports). Its axes are
    `MetaAxis` objects, so the collectives over them move nothing and are
    recorded (`Record`); its ``device`` is ``meta``. Building one is not
    collective and needs no ``torch.distributed``: it can stand for one
    rank of a 256- or 512-rank mesh on any machine."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 coords: Optional[Sequence[int]] = None):
        shape = tuple(int(s) for s in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names "
                             f"{axis_names} must pair up, names unique")
        coords = tuple(int(c) for c in (coords or (0,) * len(shape)))
        if len(coords) != len(shape) or any(
                not 0 <= c < n for c, n in zip(coords, shape)):
            raise ValueError(f"coordinates {coords} outside mesh {shape}")
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, shape))
        self.ranks = np.arange(int(np.prod(shape))).reshape(shape)
        self.coords = coords
        self.device = torch.device("meta")

    @property
    def rank(self) -> int:
        """The global rank this mesh stands for (row-major)."""
        return int(self.ranks[self.coords])

    def axis(self, name: str) -> MetaAxis:
        i = self.axis_names.index(name)
        return MetaAxis(name, None, self.shape[name], index=self.coords[i])

    def joint(self, names: Sequence[str]) -> MetaAxis:
        """The axes ``names`` together (in mesh order), indexed by the
        row-major coordinate on them."""
        names = tuple(n for n in self.axis_names if n in names)
        if len(names) == 1:
            return self.axis(names[0])
        n, index = 1, 0
        for name in names:
            size = self.shape[name]
            index = index * size + self.coords[self.axis_names.index(name)]
            n *= size
        return MetaAxis(",".join(names), None, n, index=index)

    @property
    def size(self) -> int:
        return int(self.ranks.size)


# ---------------------------------------------------------------------------
# process groups on one host
# ---------------------------------------------------------------------------
def spawn(fn: Callable, world: int, args: tuple = (), *,
          timeout_s: float = TIMEOUT_S):
    """Run ``fn(*args)`` in ``world`` new processes that form one ``gloo``
    group, and return rank 0's return value (picklable).

    The processes start with the ``forkserver`` method: CUDA forbids
    ``fork`` once initialised, and the server, started on the first call
    of this process, imports torch once and never touches the card, so
    each group forks from it instead of importing torch in every rank
    (seconds a rank); each rank takes the caller's current standard
    output, error and environment, as a spawned one would. The ranks
    meet through a ``FileStore`` in a temporary directory, so concurrent
    runs on one host need no free port. If a rank raises, the others are
    stopped and the error is raised here.
    """
    torch.multiprocessing.set_forkserver_preload(FORKSERVER_PRELOAD)
    sys.stdout.flush()
    sys.stderr.flush()
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        result = os.path.join(d, "rank0.pkl")
        torch.multiprocessing.start_processes(
            _entry, args=(fn, world, init, result, args, timeout_s,
                          _Caller()),
            nprocs=world, join=True, start_method="forkserver")
        with open(result, "rb") as f:
            return pickle.load(f)


class _Caller:
    """The caller's standard output and error and its environment,
    handed to a rank: a forkserver's child inherits the server's (the
    caller's at its first `spawn`), not the caller's at this one."""

    def __init__(self, fds=None, env=None):
        self.fds, self.env = fds, env

    def __reduce__(self):
        from multiprocessing import reduction
        return (_Caller, ((reduction.DupFd(1), reduction.DupFd(2)),
                          dict(os.environ)))

    def attach(self) -> None:
        for src, dst in zip(self.fds, (1, 2)):
            fd = src.detach()
            os.dup2(fd, dst)
            os.close(fd)
        os.environ.clear()
        os.environ.update(self.env)


def _entry(r: int, fn: Callable, world: int, init: str, result: str,
           args: tuple, timeout_s: float, caller: _Caller) -> None:
    caller.attach()
    # MKL's default code path is not bit-reproducible from one process to
    # the next on the same host (a 2-rank whisper step's gradients before
    # the sync differed between runs in ~1 of 4 groups on the CPU); its
    # conditional numerical reproducibility mode is, and it is read at
    # the rank's first BLAS call
    os.environ.setdefault("MKL_CBWR", "COMPATIBLE")
    # the ranks share the host's cores: with each rank's default of one
    # intra-op thread per core, their spinning thread pools starve each
    # other (a 64K-element add took 27 ms instead of 0.04 at 4 ranks)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "gloo", init_method=init, rank=r, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        if r == 0:
            with open(result, "wb") as f:
                # protocol 5 writes a tensor's bytes at half protocol
                # 4's cost (a run's kept params are gigabytes)
                pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        close_arenas()
    except Exception:
        # the caller raises the first rank's error it sees, which may be
        # a peer's lost connection: each rank's own goes to stderr
        print(f"rank {r} of {world} failed:", file=sys.stderr, flush=True)
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def device_of(device: Optional[str]) -> torch.device:
    """The device a rank keeps its buffers on: ``cuda`` is ``cuda:0`` for
    every rank (ranks on one card), ``cpu`` the host."""
    if device in (None, "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the ranks on the host")
        torch.cuda.set_device(0)
        return torch.device("cuda", 0)
    return torch.device(device)
