"""The rank transport: what stands in for ``shard_map``, ``axis_index`` and
``jax.lax.ppermute`` in the reference.

The reference runs an algorithm once, as one SPMD program over a mesh
axis. The port runs it in every process of a ``torch.distributed`` group,
rank-local: ``rank()`` is a Python int, and each ``ppermute`` is one
``batch_isend_irecv`` round between the pairs the permutation names.

Ranks on one card. NCCL refuses two ranks on one device, so the ranks are
processes under a ``gloo`` group, each holding its buffers on ``cuda:0``.
Every payload is staged through host memory (``.cpu()``, the gloo wire,
``.to(device)``) while the reduce step runs on the card, in the
``segment_combine`` kernel. Timings of this transport measure the
schedule and the host staging, not a GPU fabric. A CPU tensor crosses
without staging. This module is the whole transport: a multi-card NCCL
path would drop the staging here and change nothing above it.

``ppermute`` keeps ``jax.lax.ppermute``'s semantics exactly: a rank that
is no destination in ``perm`` gets zeros, a rank may send without
receiving, and a pair ``(i, i)`` is a local copy. Sources and
destinations must each be unique, as in JAX.

The ``"xla"`` algorithms use the backend's built-ins: ``psum``,
``all_gather`` and ``all_to_all``.

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
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: how long a rank waits on a collective (and on sub-group creation)
#: before it fails instead of hanging
TIMEOUT_S = 600.0


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


def _pg(group):
    return group.group if isinstance(group, Axis) else group


def _order(group) -> Optional[Tuple[int, ...]]:
    return group.order if isinstance(group, Axis) else None


def rank(group=None) -> int:
    """This rank's index along ``group`` (its axis coordinate)."""
    r = dist.get_rank(_pg(group))
    order = _order(group)
    return r if order is None else order.index(r)


def size(group=None) -> int:
    return dist.get_world_size(_pg(group))


def barrier(group=None) -> None:
    dist.barrier(_pg(group))


def _peer(group, r: int) -> int:
    """The global rank at index ``r`` along ``group``."""
    order = _order(group)
    r = r if order is None else order[r]
    pg = _pg(group)
    return r if pg is None else dist.get_global_rank(pg, r)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A contiguous host tensor with x's values that the caller may
    overwrite (a copy, for a CPU x too)."""
    return x.detach().to("cpu", copy=True, memory_format=torch.contiguous_format)


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
    r = rank(group)
    send_to = [d for s, d in perm if s == r]
    recv_from = [s for s, d in perm if d == r]
    if not recv_from and not send_to:
        return torch.zeros_like(x)
    if send_to == [r]:                       # (r, r): a local copy
        return x.clone()
    ops = []
    if send_to:
        payload = x.detach().contiguous() if x.device.type == "cpu" \
            else x.detach().to("cpu")
        ops.append(dist.P2POp(dist.isend, payload, _peer(group, send_to[0]),
                              _pg(group)))
    if recv_from:
        buf = torch.empty(x.shape, dtype=x.dtype)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, recv_from[0]),
                              _pg(group)))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not recv_from:
        return torch.zeros_like(x)
    return buf.to(x.device)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (sum), out of place."""
    buf = _to_host(x)
    dist.all_reduce(buf, group=_pg(group))
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-gather, concatenated along axis 0 (tiled)."""
    buf = _to_host(x)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=_pg(group))
    order = _order(group)
    if order is not None:                     # group rank -> axis order
        parts = [parts[g] for g in order]
    return torch.cat(parts, dim=0).to(x.device)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-to-all: axis 0 split into p equal blocks, block
    j goes to rank j, and the received blocks are stacked in rank order
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    buf = _to_host(x)
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
    return out.to(x.device)


def max_over_ranks(values: Sequence[float], group=None) -> list:
    """Elementwise maximum of ``values`` over the ranks, on every rank."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_pg(group))
    return t.tolist()


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
        me = rank()
        timeout = datetime.timedelta(seconds=timeout_s)
        self._axes = {}
        for i, name in enumerate(axis_names):
            lines = np.moveaxis(self.ranks, i, -1).reshape(-1, shape[i])
            for line in lines:                    # every rank, same order
                pg = dist.new_group(line.tolist(), timeout=timeout)
                if me in line:
                    groups = tuple(dist.get_group_rank(pg, int(g))
                                   for g in line)
                    self._axes[name] = Axis(
                        name, pg, shape[i],
                        None if groups == tuple(range(shape[i]))
                        else groups)

    def axis(self, name: str) -> Axis:
        """This rank's sub-group along ``name``."""
        return self._axes[name]

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

    The processes start with the ``spawn`` method (CUDA forbids ``fork``
    once initialised) and meet through a ``FileStore`` in a temporary
    directory, so concurrent runs on one host need no free port. If a
    rank raises, the others are stopped and the error is raised here.
    """
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        result = os.path.join(d, "rank0.pkl")
        torch.multiprocessing.start_processes(
            _entry, args=(fn, world, init, result, args, timeout_s),
            nprocs=world, join=True, start_method="spawn")
        with open(result, "rb") as f:
            return pickle.load(f)


def _entry(r: int, fn: Callable, world: int, init: str, result: str,
           args: tuple, timeout_s: float) -> None:
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
                pickle.dump(out, f)
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
