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
``all_gather`` and ``all_to_all``; ``pmax`` serves the vocab-parallel
loss's row max.

Threads. Every function here may be called from any one thread of a
rank, as long as no other thread of that rank issues a collective at
the same time: the ``gloo`` groups are used by one thread at a time, and
every rank must issue its collectives in one order. `SyncThread` is the
one place the port calls them off the main thread: the
backward-overlapped gradient sync hands it one job a released layer
while autograd runs the layers below, and the main thread issues no
collective until it has joined the thread. (On a ``model`` axis,
expert or tensor parallelism, the backward issues collectives of its
own, so there the layers sync inside the backward and no thread runs:
``launch/steps.py``.) On the
card the thread works on a CUDA stream of its own, so the host
staging's stream synchronizes
(``.to("cpu")``, ``.to(device)``) wait for the sync's own copies and
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
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import functools
import os
import pickle
import queue
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree

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


class Tally:
    """Counts and times the collectives this process issues over one mesh
    axis, by its name (``"model"``), while it is open (``with
    Tally("model", device):``; the training step opens one a step).
    ``counts`` is by function (``psum``, ``pmax``, ``all_gather``,
    ``reduce_scatter``, ``all_to_all``), ``seconds`` their sum, each
    between two synchronizations of ``device`` (on the card; the host
    staging waits for the work queued before a collective anyway, so
    the first costs nothing more). Collectives on other axes, or on a
    process group that is not an `Axis`, are not counted."""

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
            torch.cuda.synchronize(self.device)
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
def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (sum), out of place."""
    buf = _to_host(x)
    dist.all_reduce(buf, group=_pg(group))
    return buf.to(x.device)


@_tallied
def pmax(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (elementwise max), out of place."""
    buf = _to_host(x)
    dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=_pg(group))
    return buf.to(x.device)


@_tallied
def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-gather, concatenated along axis 0 (tiled)."""
    buf = _to_host(x)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=_pg(group))
    order = _order(group)
    if order is not None:                     # group rank -> axis order
        parts = [parts[g] for g in order]
    return torch.cat(parts, dim=0).to(x.device)


@_tallied
def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's reduce-scatter (sum): axis 0 split into p equal
    blocks, and this rank gets the sum over the ranks of block i, i its
    index along ``group`` (``jax.lax.psum_scatter(scatter_dimension=0,
    tiled=True)``, the transpose of `all_gather`)."""
    buf = _to_host(x)
    n = size(group)
    order = _order(group)
    if order is not None:          # block i goes to group rank order[i]
        blocks = buf.chunk(n)
        buf = torch.cat([blocks[order.index(g)] for g in range(n)])
    out = torch.empty((buf.shape[0] // n,) + tuple(buf.shape[1:]),
                      dtype=buf.dtype)
    dist.reduce_scatter_tensor(out, buf, group=_pg(group))
    return out.to(x.device)


@_tallied
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


def broadcast_object(obj, group=None):
    """``obj`` (picklable) of the rank at index 0 along ``group``, on
    every rank; the other ranks' ``obj`` is ignored."""
    box = [obj]
    dist.broadcast_object_list(box, src=_peer(group, 0), group=_pg(group))
    return box[0]


def max_over_ranks(values: Sequence[float], group=None) -> list:
    """Elementwise maximum of ``values`` over the ranks, on every rank."""
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
