"""The training step (port of ``build_train_step`` in
``repro/launch/steps.py``), run inside every rank of a data-parallel
group.

The reference builds one jitted program over a mesh: the untuned
(``"xla"``) path lets XLA all-reduce the gradients of a batch sharded
over the data axes; the tuned path runs forward, backward, the
Communicator's gradient sync and the optimizer inside one ``shard_map``.
The port's ranks are processes (`group.RankMesh`), each holding its rows
of the global batch (`sharding.batch_rows`) and a full replica of the
params, so both paths are the same three phases in every rank:

  1. forward and backward of this rank's rows (``torch.autograd.grad``;
     attention through the flash kernels), optionally accumulated over
     ``overlap_microbatches``;
  2. gradient sync: tuned, ``comm.sync_gradients(grads, mean=True)``
     (flat, N-level or bucketed, as the Communicator resolved); untuned,
     the backend's all-reduce of every leaf over the data-parallel ranks,
     averaged; then the loss is averaged over the data axes;
  3. the local AdamW step with ``cosine_with_warmup``, which leaves the
     replicas equal wherever the synced gradients are.

Not ported (each raises ``NotImplementedError`` naming its ROADMAP.md
Queue 1 step): the backward-overlapped sync (``overlap_backward``, step
9), expert and tensor parallelism (a ``model`` axis over 1, step 8) and
FSDP param sharding (step 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch import pytree
from repro_torch.comms import Communicator
from repro_torch.configs.base import (
    CollectiveConfig,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    validate_collectives,
)
from repro_torch.core.collectives import group as grp
from repro_torch.models.registry import build_model
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.parallel import sharding as sh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainStep:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    over this rank's rows ``rows`` of the global batch (``fn(...,
    keep_grads=True)``: ``metrics["local_grads_fingerprint"]`` is the
    `pytree.fingerprint` of this rank's gradients before the sync, and
    ``["grads"]`` the synced tree), with the model
    (``api``) and optimizer (``opt``) it was built over; ``grad(params,
    batch) -> ((loss, aux), grads)`` is its first phase alone, this
    rank's gradients before the sync."""

    fn: Callable
    grad: Callable
    api: Any
    opt: AdamW
    tuned: bool
    rows: slice


def _pmean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Mean of ``x`` over the mesh ``axes`` (``jax.lax.pmean``)."""
    n = 1
    for a in axes:
        x = grp.psum(x, mesh.axis(a))
        n *= mesh.shape[a]
    return x / n


def _synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_train_step(
    cfg: ModelConfig,
    shape: ShapeConfig,
    parallel: ParallelConfig,
    coll: CollectiveConfig,
    mesh,
    *,
    lr: float = 3e-4,
    total_steps: int = 1000,
    warmup_steps: int = 100,
    communicator: Optional[Communicator] = None,
    device="cuda",
) -> TrainStep:
    """The step of this rank; ``communicator`` is the launch's (one per
    process, built by the launcher — possibly with a live-fabric probe);
    when None, one is resolved from the CollectiveConfig. Every metric
    but the loss is this rank's: ``compute_s``, ``sync_s`` and ``opt_s``
    time the three phases, each ended by synchronizing the device."""
    comm = communicator or Communicator.from_config(coll, mesh)
    tuned = comm.is_tuned
    validate_collectives(coll, parallel, tuned=tuned)
    if coll.overlap_backward:
        raise NotImplementedError(
            "the backward-overlapped gradient sync (--overlap-backward) "
            "comes with ROADMAP.md Queue 1 step 9")
    if sh.model_size(mesh) > 1:
        raise NotImplementedError(
            "a model-parallel axis (expert or tensor parallelism inside "
            "the training step) comes with ROADMAP.md Queue 1 step 8")
    if parallel.shard_params_over_data:
        raise NotImplementedError(
            "FSDP param sharding comes with ROADMAP.md Queue 1 step 10")
    dev = torch.device(device)
    cd = _DTYPES[parallel.compute_dtype]
    api = build_model(cfg, compute_dtype=cd,
                      param_dtype=_DTYPES[parallel.param_dtype],
                      remat=parallel.remat != "none", device=dev)
    opt = AdamW(lr=lr)
    dpx = sh.dp_axes(mesh)
    dp = sh.dp_size(mesh)
    rows = sh.batch_rows(mesh, shape.global_batch)

    def lr_scale(step):
        return cosine_with_warmup(step, warmup_steps=warmup_steps,
                                  total_steps=total_steps)

    def value_and_grad(params, batch):
        leaves, treedef = pytree.flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        p = treedef.unflatten(leaves)
        if parallel.gather_in_compute_dtype:
            p = pytree.tree_map(lambda x: x.to(torch.bfloat16)
                                if x.dtype == torch.float32 else x, p)
        loss, aux = api.loss(p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return (loss.detach(), aux), treedef.unflatten(grads)

    def grad_fn(params, batch):
        """value_and_grad, optionally microbatched (survey §4.1 CCTP: the
        reference scans over k tiles of the batch, summing loss/k and
        grads/k)."""
        k = max(1, coll.overlap_microbatches)
        if k == 1:
            return value_and_grad(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % k:
            raise ValueError(f"batch {B} not divisible by {k} microbatches")
        acc = None
        for i in range(k):
            mb = {n: t[i * (B // k):(i + 1) * (B // k)]
                  for n, t in batch.items()}
            (l, aux), g = value_and_grad(params, mb)
            if acc is None:
                acc = (torch.zeros_like(l),
                       pytree.tree_map(torch.zeros_like, aux),
                       pytree.tree_map(torch.zeros_like, g))
            acc = (acc[0] + l / k,
                   pytree.tree_map(lambda a, b: a + b / k, acc[1], aux),
                   pytree.tree_map(lambda a, b: a + b / k, acc[2], g))
        return (acc[0], acc[1]), acc[2]

    def sync(grads):
        if tuned:
            return comm.sync_gradients(grads, mean=True)
        # the backend's all-reduce over the data-parallel ranks (the
        # whole group: no model axis), averaged
        return pytree.tree_map(lambda g: grp.psum(g) / dp, grads)

    def fn(params, opt_state, batch, keep_grads=False):
        t0 = time.perf_counter()
        (loss, aux), grads = grad_fn(params, batch)
        _synchronize(dev)
        t1 = time.perf_counter()
        kept = {}
        if keep_grads:          # between the phases, untimed
            kept["local_grads_fingerprint"] = pytree.fingerprint(grads)
        t1b = time.perf_counter()
        grads = sync(grads)
        loss = _pmean(loss, mesh, dpx)
        aux = pytree.tree_map(lambda v: _pmean(v, mesh, dpx), aux)
        _synchronize(dev)
        t2 = time.perf_counter()
        new_params, new_opt = opt.update(grads, opt_state, params,
                                         lr_scale=lr_scale(opt_state.step))
        _synchronize(dev)
        t3 = time.perf_counter()
        metrics = {"loss": loss, **aux, "compute_s": t1 - t0,
                   "sync_s": t2 - t1b, "opt_s": t3 - t2, **kept}
        if keep_grads:
            metrics["grads"] = grads
        return new_params, new_opt, metrics

    return TrainStep(fn=fn, grad=grad_fn, api=api, opt=opt, tuned=tuned,
                     rows=rows)
