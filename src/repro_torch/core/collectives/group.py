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
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def rank(group=None) -> int:
    return dist.get_rank(group)


def size(group=None) -> int:
    return dist.get_world_size(group)


def barrier(group=None) -> None:
    dist.barrier(group)


def _peer(group, r: int) -> int:
    return r if group is None else dist.get_global_rank(group, r)


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
                              group))
    if recv_from:
        buf = torch.empty(x.shape, dtype=x.dtype)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, recv_from[0]),
                              group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not recv_from:
        return torch.zeros_like(x)
    return buf.to(x.device)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (sum), out of place."""
    buf = _to_host(x)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-gather, concatenated along axis 0 (tiled)."""
    buf = _to_host(x)
    parts = [torch.empty_like(buf) for _ in range(size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=0).to(x.device)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-to-all: axis 0 split into p equal blocks, block
    j goes to rank j, and the received blocks are stacked in rank order
    (``jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    buf = _to_host(x)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=group)
    return out.to(x.device)


def max_over_ranks(values: Sequence[float], group=None) -> list:
    """Elementwise maximum of ``values`` over the ranks, on every rank."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t.tolist()


# ---------------------------------------------------------------------------
# process groups on one host
# ---------------------------------------------------------------------------
def spawn(fn: Callable, world: int, args: tuple = (), *,
          timeout_s: float = 600.0):
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
