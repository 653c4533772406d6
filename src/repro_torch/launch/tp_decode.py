"""Tensor-parallel decode through the tuned `Communicator` (port of
``repro/launch/tp_decode.py``).

The decode hot loop's collectives are the per-token all-gather of
vocab-parallel logits and the all-reduce of partial logits: this module
routes BOTH through a `Communicator`, so the serving launcher executes
the artifact's choice instead of only printing the plan. The requests
the step executes and the requests `Communicator.explain` renders are
built by the SAME functions below, so the reported plan is exactly the
executed plan.

As in the reference, the model compute is replicated in every rank of
the ``model`` axis (the reference's JAX 0.4 ``shard_map`` fallback; here
each rank is a process holding the full params); the logits collective
runs the tuned wire schedule over the axis. Numerics are exact by
construction, so tuned decode is bit-identical to the one-process
decode:

  * all_gather: each rank keeps its contiguous V/p logits columns
    (the same values as those columns of the full logits) and the tuned
    all-gather reassembles them in rank order;
  * all_reduce: each rank zeroes every column it does not own and the
    tuned sum (every reduce step in the ``segment_combine`` kernel on
    the card) combines disjoint supports; adding exact zeros never
    perturbs the surviving addend.
"""
from __future__ import annotations

from typing import List

import torch

from repro_torch import pytree
from repro_torch.comms import CollectiveRequest, Communicator, PlanReport
from repro_torch.core.collectives import group as grp
from repro_torch.core.collectives.dispatch import apply_collective
from repro_torch.models.layers import pad_vocab

TP_COLLECTIVES = ("all_gather", "all_reduce")


def logits_request(collective: str, batch: int, vocab: int, p: int,
                   *, axis: str = "model", itemsize: int = 2,
                   dtype: str = "bfloat16") -> CollectiveRequest:
    """The decode loop's logits-assembly request: the V/p shard for
    all_gather, the full (Megatron-padded) buffer for all_reduce — the
    exact lookup `assemble_logits` performs per token."""
    nbytes = batch * pad_vocab(vocab) * itemsize
    if collective == "all_gather":
        nbytes //= p
    return CollectiveRequest(collective, nbytes, axis=axis, axis_size=p,
                             dtype=dtype)


def decode_requests(batch: int, d_model: int, vocab: int, p: int,
                    *, axis: str = "model", itemsize: int = 2
                    ) -> List[CollectiveRequest]:
    """All decode-time collective requests of a TP model: the per-layer
    residual all-reduce and the vocab-parallel logits all-gather."""
    return [
        CollectiveRequest("all_reduce", batch * d_model * itemsize,
                          axis=axis, axis_size=p, dtype="bfloat16"),
        logits_request("all_gather", batch, vocab, p, axis=axis,
                       itemsize=itemsize),
    ]


def tp_decode_plan(comm: Communicator, batch: int, d_model: int,
                   vocab: int, p: int, itemsize: int = 2) -> PlanReport:
    """The decode-time collective plan the serving launcher reports
    before entering the loop — rendered by `Communicator.explain` over
    the same requests the step functions build."""
    return comm.explain(decode_requests(batch, d_model, vocab, p,
                                        itemsize=itemsize))


def executed_spec(comm: Communicator, collective: str, batch: int,
                  vocab: int, p: int, itemsize: int = 2):
    """(nbytes, spec) of the logits collective `build_tp_decode_step`
    will actually run — the same request builder as the step, so the
    launcher reports exactly what executes."""
    req = logits_request(collective, batch, vocab, p, itemsize=itemsize)
    return req.nbytes, comm.spec(req)


def assemble_logits(logits: torch.Tensor, mesh, comm: Communicator, *,
                    collective: str = "all_gather", axis: str = "model",
                    executed: set = None) -> torch.Tensor:
    """This rank's replicated ``(B, V)`` logits, reassembled through the
    tuned ``collective`` over ``axis`` from each rank's own V/p columns
    (every rank returns the same tensor). ``executed`` collects the
    ``(nbytes, algorithm, segments)`` each call ran."""
    if collective not in TP_COLLECTIVES:
        raise ValueError(f"collective {collective!r} not in "
                         f"{TP_COLLECTIVES}")
    p = mesh.shape[axis]
    B, V = logits.shape
    if V % p:
        raise ValueError(f"vocab {V} not divisible by tp={p}")
    shard = V // p
    ax = mesh.axis(axis)
    r = grp.rank(ax)
    # the wire message: the V/p shard for all_gather, the full masked
    # logits buffer for all_reduce — the same request explain() renders
    req = logits_request(collective, B, V, p, axis=axis,
                         itemsize=logits.element_size(),
                         dtype=pytree.dtype_name(logits.dtype))
    spec = comm.spec(req)
    if executed is not None:
        executed.add((req.nbytes, spec.algorithm, spec.segments))
    if collective == "all_gather":
        # vocab-parallel: own columns, transposed so the gather's
        # leading-axis concatenation lands in rank order
        own = logits[:, r * shard:(r + 1) * shard].T.contiguous()
        return apply_collective("all_gather", own, ax, p, spec).T
    # partial-sum form: zero the columns other ranks own; the tuned
    # all-reduce of disjoint supports is an exact reassembly
    masked = torch.zeros_like(logits)
    masked[:, r * shard:(r + 1) * shard] = \
        logits[:, r * shard:(r + 1) * shard]
    return apply_collective("all_reduce", masked, ax, p, spec)


def build_tp_decode_step(api, mesh, comm: Communicator, *,
                         collective: str = "all_gather",
                         axis: str = "model"):
    """``step(params, cache, tokens) -> (logits, cache)`` whose per-token
    logits assembly runs the tuned collective over ``axis`` (inside
    every rank of the mesh); ``step.executed`` collects the
    ``(nbytes, algorithm, segments)`` it ran."""
    if collective not in TP_COLLECTIVES:
        raise ValueError(f"collective {collective!r} not in "
                         f"{TP_COLLECTIVES}")

    def step(params, cache, tokens):
        logits, new_cache = api.decode_step(params, cache, tokens)
        return assemble_logits(logits, mesh, comm, collective=collective,
                               axis=axis, executed=step.executed), new_cache

    step.executed = set()
    return step
