"""Collective algorithm implementations (survey §2, Table 2) on a
``torch.distributed`` group (port of ``repro/core/collectives/algorithms.py``).

The reference writes each algorithm as ``jax.lax.ppermute`` rounds inside
``shard_map``. Here every function runs inside each rank of the group,
rank-local: ``r`` is a Python int, a ``dynamic_slice`` is plain slicing,
a ``jnp.where`` on the rank is a Python branch, and each ``ppermute`` is
one ``batch_isend_irecv`` round (``group.py``). The schedule of each
algorithm — ring vs recursive halving vs Bruck vs binomial tree — is the
reference's round for round, so on the same inputs every non-``"xla"``
algorithm gives the reference's bits.

Conventions (the reference's):
  * ``axis`` is the process group (``None``: the default group) and
    ``axis_size`` its size (powers of two where asserted; Bruck, ring and
    recursive doubling ``all_gather`` run at any size);
  * "allreduce"-class take/return the full local buffer;
  * "reduce_scatter" returns this rank's 1/p shard; "allgather" the
    p-times-larger concatenation;
  * ``segments>1`` splits transfers for pipelining (survey "segmentation");
  * every reduce step runs ``kernels.ops.segment_combine``: the
    hand-written CUDA kernel for a CUDA tensor, its plain version for a
    CPU tensor. The ring and the ring reduce-scatter own their buffer (a
    fresh copy, ``_flatten_pad``) and combine into its row views in
    place; the others combine out of place.

One difference in work, not in result: ``reduce_binomial`` combines only
on the ranks that receive in a round. The reference's SPMD program also
combines zeros on the others and discards the result, so the port counts
fewer ``segment_combine`` launches there (``PERF.md``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import group as grp
from repro_torch.kernels import ops as kops


def _combine(a, b, op, out=None):
    return kops.segment_combine(a, b, op, out=out)


def _ring_perm(p, shift=1):
    return [(i, (i + shift) % p) for i in range(p)]


def _log2(p: int) -> int:
    k = p.bit_length() - 1
    assert (1 << k) == p, f"axis size {p} must be a power of two"
    return k


def _flatten_pad(x, mult):
    """A fresh flat copy of x, zero-padded to a multiple of ``mult`` (the
    algorithms write into it in place)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % mult
    flat = F.pad(flat, (0, pad)) if pad else flat.clone()
    return flat, x.shape, x.numel()


def _unflatten(flat, shape, size):
    return flat[:size].reshape(shape)


def _tiled(buf, x):
    """(p, m) rows of x-shaped shards -> the (p * x.shape[0], ...)
    concatenation (flat for a 1-d x)."""
    p = buf.shape[0]
    if x.dim() > 1:
        return buf.reshape((p * x.shape[0],) + tuple(x.shape[1:]))
    return buf.reshape(-1)


# ===========================================================================
# ALL-REDUCE
# ===========================================================================
def allreduce_xla(x, axis, axis_size, *, op="add", segments=1):
    del axis_size, segments
    assert op == "add"
    return grp.psum(x, axis)


def allreduce_recursive_doubling(x, axis, axis_size, *, op="add", segments=1):
    """log2(p) rounds of full-buffer exchange at doubling distance (§2.1.5)."""
    del segments
    p = axis_size
    out = x
    for s in range(_log2(p)):
        d = 1 << s
        perm = [(i, i ^ d) for i in range(p)]
        recv = grp.ppermute(out, perm, axis)
        out = _combine(out, recv, op)
    return out


def allreduce_ring(x, axis, axis_size, *, op="add", segments=1):
    """Bandwidth-optimal ring: reduce-scatter then allgather, optionally
    segmented for pipelining (§2.1.5 Ring)."""
    p = axis_size
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, p * segments)
    m = flat.numel() // p
    buf = flat.reshape(p, m)
    seg = m // segments
    perm = _ring_perm(p)

    for g in range(segments):
        sl = slice(g * seg, (g + 1) * seg)
        # --- reduce-scatter ---
        for s in range(p - 1):
            send_idx = (r - s) % p
            recv_idx = (r - s - 1) % p
            recv = grp.ppermute(buf[send_idx, sl], perm, axis)
            acc = buf[recv_idx, sl]            # a view: combined in place
            _combine(acc, recv, op, out=acc)
        # --- allgather ---
        for s in range(p - 1):
            send_idx = (r + 1 - s) % p
            recv = grp.ppermute(buf[send_idx, sl], perm, axis)
            buf[(r - s) % p, sl] = recv
    return _unflatten(buf.reshape(-1), shape, size)


def allreduce_rabenseifner(x, axis, axis_size, *, op="add", segments=1):
    """Recursive (vector) halving reduce-scatter + distance-doubling
    allgather (§2.1.5 Rabenseifner)."""
    del segments
    p = axis_size
    k = _log2(p)
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, p)

    # --- reduce-scatter by recursive halving ---
    buf = flat
    for s in range(k):
        d = p >> (s + 1)                      # partner distance
        half = buf.numel() // 2
        low, high = buf[:half], buf[half:]
        bit = (r & d) != 0                    # 1 -> own the HIGH half
        send, keep = (low, high) if bit else (high, low)
        perm = [(i, i ^ d) for i in range(p)]
        recv = grp.ppermute(send, perm, axis)
        buf = _combine(keep, recv, op)

    # --- allgather by distance doubling / vector doubling ---
    for s in reversed(range(k)):
        d = p >> (s + 1)
        perm = [(i, i ^ d) for i in range(p)]
        recv = grp.ppermute(buf, perm, axis)
        bit = (r & d) != 0
        buf = torch.cat([recv, buf] if bit else [buf, recv])
    return _unflatten(buf, shape, size)


def allreduce_reduce_bcast(x, axis, axis_size, *, op="add", segments=1):
    """Binomial-tree reduce to rank 0 followed by binomial broadcast
    ("Reduce followed by Broadcast", §2.1.5)."""
    del segments
    red = reduce_binomial(x, axis, axis_size, op=op)
    return broadcast_binomial(red, axis, axis_size)


def allreduce_allgather_reduce(x, axis, axis_size, *, op="add", segments=1):
    """Allgather everyone's buffer then reduce locally ("Allgather followed
    by Reduce", §2.1.5) — latency-optimal only for tiny messages."""
    del segments
    assert op == "add"
    gathered = allgather_recursive_doubling(x[None], axis, axis_size)
    # jnp.sum's arithmetic: fp32 accumulation over axis 0 in order, one
    # cast back to the wire dtype
    acc = gathered[0].float()
    for row in gathered[1:]:
        acc = acc + row.float()
    return acc.to(x.dtype)


# ===========================================================================
# REDUCE-SCATTER
# ===========================================================================
def reduce_scatter_xla(x, axis, axis_size, *, op="add", segments=1):
    """The backend's all-reduce, then this rank's shard: the shard the
    reference's ``psum_scatter`` returns."""
    del segments
    assert op == "add"
    flat, shape, size = _flatten_pad(x, axis_size)
    return grp.psum(flat, axis).reshape(axis_size, -1)[grp.rank(axis)]


def reduce_scatter_ring(x, axis, axis_size, *, op="add", segments=1):
    del segments
    p = axis_size
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, p)
    m = flat.numel() // p
    buf = flat.reshape(p, m)
    perm = _ring_perm(p)
    for s in range(p - 1):
        send_idx = (r - s - 1) % p
        recv_idx = (r - s - 2) % p
        recv = grp.ppermute(buf[send_idx], perm, axis)
        acc = buf[recv_idx]                    # a view: combined in place
        _combine(acc, recv, op, out=acc)
    # with the shifted schedule, rank r ends owning exactly chunk r
    return buf[r]


def reduce_scatter_halving(x, axis, axis_size, *, op="add", segments=1):
    """Recursive vector halving (the reduce-scatter phase of Rabenseifner)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, p)
    buf = flat
    for s in range(_log2(p)):
        d = p >> (s + 1)
        half = buf.numel() // 2
        low, high = buf[:half], buf[half:]
        bit = (r & d) != 0
        send, keep = (low, high) if bit else (high, low)
        perm = [(i, i ^ d) for i in range(p)]
        recv = grp.ppermute(send, perm, axis)
        buf = _combine(keep, recv, op)
    return buf


# ===========================================================================
# ALL-GATHER   (input: local shard; output: (p * shard) concatenation)
# ===========================================================================
def allgather_xla(x, axis, axis_size, *, segments=1):
    del axis_size, segments
    return grp.all_gather(x, axis)


def allgather_ring(x, axis, axis_size, *, segments=1):
    del segments
    p = axis_size
    r = grp.rank(axis)
    m = x.numel()
    buf = torch.zeros((p, m), dtype=x.dtype, device=x.device)
    buf[r] = x.reshape(m)
    perm = _ring_perm(p)
    for s in range(p - 1):
        send_idx = (r - s) % p
        recv = grp.ppermute(buf[send_idx], perm, axis)
        buf[(r - s - 1) % p] = recv
    return _tiled(buf, x)


def allgather_recursive_doubling(x, axis, axis_size, *, segments=1):
    del segments
    p = axis_size
    if p & (p - 1):
        # XOR partnering (i ^ d) only pairs ranks when p is a power of
        # two; at other fan-outs run the dissemination schedule, which
        # has the same ceil(log2 p) round count and wire bytes.
        return allgather_bruck(x, axis, axis_size)
    r = grp.rank(axis)
    k = _log2(p)
    m = x.numel()
    buf = x.reshape(1, m)
    for s in range(k):
        d = 1 << s
        perm = [(i, i ^ d) for i in range(p)]
        recv = grp.ppermute(buf, perm, axis)
        bit = (r & d) != 0
        buf = torch.cat([recv, buf] if bit else [buf, recv], dim=0)
    # row index bit s is rank bit s, so the rows are in rank order
    return _tiled(buf, x)


def allgather_bruck(x, axis, axis_size, *, segments=1):
    del segments
    p = axis_size
    r = grp.rank(axis)
    m = x.numel()
    buf = x.reshape(1, m)
    # generalized (dissemination) Bruck: at distance d each rank holds
    # blocks [r, r+d) and forwards the first min(d, p-d) of them, so the
    # held run grows to exactly p with no duplicate blocks at ANY p.
    d = 1
    while d < p:
        nb = min(d, p - d)
        perm = [(i, (i - d) % p) for i in range(p)]   # send to rank-d
        recv = grp.ppermute(buf[:nb], perm, axis)     # receive from rank+d
        buf = torch.cat([buf, recv], dim=0)
        d += nb
    # rank r holds blocks [r, r+1, ..., r+p-1] (mod p); rotate into order
    buf = torch.roll(buf, shifts=r, dims=0)
    return _tiled(buf, x)


def allgather_gather_bcast(x, axis, axis_size, *, segments=1):
    """Binomial gather to rank 0 (zero-padded slots + add) then binomial
    broadcast ("Gather followed by Broadcast", §2.1.4)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    m = x.numel()
    buf = torch.zeros((p, m), dtype=x.dtype, device=x.device)
    buf[r] = x.reshape(m)
    red = reduce_binomial(buf, axis, p, op="add")     # gather via sparse add
    out = broadcast_binomial(red, axis, p)
    return _tiled(out, x)


# ===========================================================================
# BROADCAST (root = 0) / REDUCE (root = 0, valid at root)
# ===========================================================================
def broadcast_xla(x, axis, axis_size, *, segments=1):
    del segments
    # the reference's idiom: select root's value via masked psum
    masked = x if grp.rank(axis) == 0 else torch.zeros_like(x)
    return grp.psum(masked, axis)


def broadcast_binomial(x, axis, axis_size, *, segments=1):
    del segments
    p = axis_size
    r = grp.rank(axis)
    out = x
    for s in range(_log2(p)):
        a = 1 << s
        perm = [(i, i + a) for i in range(a) if i + a < p]
        recv = grp.ppermute(out, perm, axis)
        if a <= r < 2 * a:
            out = recv
    return out


def broadcast_binary_tree(x, axis, axis_size, *, segments=1):
    """Binary tree: each inner node forwards to children 2i+1 and 2i+2
    (§2.1.1 Binary Tree). Depth ~log2(p) but only two sends per node —
    less pairwise parallelism than binomial, as the survey notes."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    out = x
    # level-order: parents [2^l - 1, 2^(l+1) - 1) send to 2i+1, 2i+2
    level = 0
    while (1 << level) - 1 < p:
        lo = (1 << level) - 1
        hi = min((1 << (level + 1)) - 1, p)
        # the two child sends of each parent are two sequential rounds
        # (matching the cost model's 2*log2(p) rounds)
        for side in (1, 2):
            perm = [(i, 2 * i + side) for i in range(lo, hi)
                    if 2 * i + side < p]
            if not perm:
                continue
            recv = grp.ppermute(out, perm, axis)
            if r in [d for _, d in perm]:
                out = recv
        level += 1
    return out


def broadcast_pipelined_binary(x, axis, axis_size, *, segments=4):
    """Pipelined tree (§2.1.1): binary-tree topology, message streamed in
    segments so inner levels overlap."""
    p = axis_size
    flat, shape, size = _flatten_pad(x, max(1, segments))
    seg = flat.numel() // max(1, segments)
    outs = []
    for g in range(max(1, segments)):
        outs.append(broadcast_binary_tree(flat[g * seg:(g + 1) * seg],
                                          axis, p))
    return _unflatten(torch.cat(outs), shape, size)


def broadcast_flat_tree(x, axis, axis_size, *, segments=1):
    """Root sends the full message to every rank in turn — the survey's
    pedagogical worst case for large p."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    out = x
    for dst in range(1, p):
        recv = grp.ppermute(out, [(0, dst)], axis)
        if r == dst:
            out = recv
    return out


def broadcast_chain(x, axis, axis_size, *, segments=1):
    """Pipelined chain: segments flow rank i -> i+1 (§2.1.1 Chain)."""
    p = axis_size
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, segments)
    seg = flat.numel() // segments
    perm = [(i, i + 1) for i in range(p - 1)]
    outs = []
    for g in range(segments):
        cur = flat[g * seg:(g + 1) * seg]
        for s in range(p - 1):
            recv = grp.ppermute(cur, perm, axis)
            # rank s+1 takes the value now; ranks past the wavefront keep
            # forwarding what they receive; ranks before it already hold
            # the final value
            if r >= s + 1:
                cur = recv
        outs.append(cur)
    return _unflatten(torch.cat(outs), shape, size)


def broadcast_van_de_geijn(x, axis, axis_size, *, segments=1):
    """Binomial scatter + ring allgather — the survey's very-long-message
    broadcast (§2.1.1)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    flat, shape, size = _flatten_pad(x, p)
    m = flat.numel() // p
    buf = flat.reshape(p, m)

    # --- binomial scatter: rank 0 halves its range each round ---
    for s in range(_log2(p)):
        d = p >> (s + 1)
        senders = [i for i in range(p) if i % (2 * d) == 0]
        perm = [(i, i + d) for i in senders]
        start = min(r + d, p - d)
        recv = grp.ppermute(buf[start:start + d], perm, axis)
        if r % (2 * d) == d:
            buf[r:r + d] = recv

    # --- ring allgather of the p chunks ---
    gathered = allgather_ring(buf[r], axis, p)
    return _unflatten(gathered.reshape(-1), shape, size)


def reduce_binomial(x, axis, axis_size, *, op="add", segments=1):
    """Binomial-tree reduce toward rank 0 (valid at root). Only the ranks
    that receive in a round combine (the reference's SPMD program also
    combines zeros elsewhere and discards them)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    out = x
    for s in reversed(range(_log2(p))):
        a = 1 << s
        perm = [(i, i - a) for i in range(a, min(2 * a, p))]
        recv = grp.ppermute(out, perm, axis)
        if r < a:
            out = _combine(out, recv, op)
    return out


# ===========================================================================
# ALL-TO-ALL   (input (p, chunk...) -> output (p, chunk...))
# ===========================================================================
def alltoall_xla(x, axis, axis_size, *, segments=1):
    del axis_size, segments
    return grp.all_to_all(x, axis)


def alltoall_pairwise(x, axis, axis_size, *, segments=1):
    """p-1 rounds; at round s exchange with partners at +-s (§2, AlltoAll)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    m = x.numel() // p
    buf = x.reshape(p, m)
    out = torch.zeros_like(buf)
    out[r] = buf[r]
    for s in range(1, p):
        send_to = [(i, (i + s) % p) for i in range(p)]
        recv = grp.ppermute(buf[(r + s) % p], send_to, axis)
        out[(r - s) % p] = recv
    return out.reshape(x.shape)


def alltoall_bruck(x, axis, axis_size, *, segments=1):
    """log2(p) rounds moving ~half the buffer each round (latency-optimal,
    factor-2 bandwidth overhead)."""
    del segments
    p = axis_size
    r = grp.rank(axis)
    k = _log2(p)
    m = x.numel() // p
    # phase 1: local rotation so chunk for rank (r+j) sits at row j
    buf = torch.roll(x.reshape(p, m), shifts=-r, dims=0)
    # phase 2: for each bit, send rows whose index has that bit set to r+2^s
    for s in range(k):
        d = 1 << s
        sel = [j for j in range(p) if j & d]           # static index list
        perm = [(i, (i + d) % p) for i in range(p)]
        recv = grp.ppermute(buf[sel], perm, axis)
        buf[sel] = recv
    # phase 3: after phase 2, row j holds the block from rank (r - j) mod p;
    # reverse then rotate to restore source-rank order
    buf = torch.roll(buf.flip(0), shifts=r + 1, dims=0)
    return buf.reshape(x.shape)


# ===========================================================================
# BARRIER
# ===========================================================================
def barrier_dissemination(axis, axis_size, *, device="cpu"):
    """Butterfly/dissemination barrier (§2.1.3): log2(p) signalling rounds."""
    p = axis_size
    tok = torch.zeros((1,), dtype=torch.float32, device=device)
    for s in range(_log2(p)):
        d = 1 << s
        perm = [(i, (i + d) % p) for i in range(p)]
        tok = tok + grp.ppermute(tok, perm, axis)
    return tok


def barrier_linear(axis, axis_size, *, device="cpu"):
    """Centralised barrier: everyone signals rank 0, rank 0 releases."""
    p = axis_size
    tok = torch.ones((1,), dtype=torch.float32, device=device)
    arr = reduce_binomial(tok, axis, p, op="add")      # arrival
    return broadcast_flat_tree(arr, axis, p)           # exit (linear release)


# ===========================================================================
# registry
# ===========================================================================
ALGORITHMS: Dict[str, Dict[str, Callable]] = {
    "all_reduce": {
        "xla": allreduce_xla,
        "ring": allreduce_ring,
        "recursive_doubling": allreduce_recursive_doubling,
        "rabenseifner": allreduce_rabenseifner,
        "reduce_bcast": allreduce_reduce_bcast,
        "allgather_reduce": allreduce_allgather_reduce,
    },
    "reduce_scatter": {
        "xla": reduce_scatter_xla,
        "ring": reduce_scatter_ring,
        "recursive_halving": reduce_scatter_halving,
    },
    "all_gather": {
        "xla": allgather_xla,
        "ring": allgather_ring,
        "recursive_doubling": allgather_recursive_doubling,
        "bruck": allgather_bruck,
        "gather_bcast": allgather_gather_bcast,
    },
    "broadcast": {
        "xla": broadcast_xla,
        "binomial": broadcast_binomial,
        "binary_tree": broadcast_binary_tree,
        "pipelined_binary": broadcast_pipelined_binary,
        "flat_tree": broadcast_flat_tree,
        "chain": broadcast_chain,
        "van_de_geijn": broadcast_van_de_geijn,
    },
    "all_to_all": {
        "xla": alltoall_xla,
        "pairwise": alltoall_pairwise,
        "bruck": alltoall_bruck,
    },
    "reduce": {
        "binomial": reduce_binomial,
    },
    "barrier": {
        "dissemination": barrier_dissemination,
        "linear": barrier_linear,
    },
}


def get(op: str, algorithm: str) -> Callable:
    if algorithm.startswith("synth:"):
        # synthesized step programs (synth.py) dispatch by family name;
        # the runner materializes + verifies at the call-time axis_size
        from repro_torch.core.collectives import synth
        return synth.runner(op, algorithm[len("synth:"):])
    try:
        return ALGORITHMS[op][algorithm]
    except KeyError:
        raise KeyError(
            f"no algorithm {algorithm!r} for {op!r}; "
            f"have {sorted(ALGORITHMS.get(op, {}))}") from None
