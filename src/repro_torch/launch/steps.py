"""The step builders (port of ``repro/launch/steps.py``): the training
step, run inside every rank of a data-parallel group, and the prefill
and decode steps of the compile-free accounting (``launch/dryrun.py``),
with ``serve_plan`` and ``build_step``, the one entry over the three.

The reference builds one jitted program over a mesh: the untuned
(``"xla"``) path lets XLA all-reduce the gradients of a batch sharded
over the data axes; the tuned path runs forward, backward, the
Communicator's gradient sync and the optimizer inside one ``shard_map``.
The port's ranks are processes (`group.RankMesh`), each holding its rows
of the global batch (`sharding.batch_rows`) and a full replica of the
params (or, on a ``model`` axis, its slices of them: below), so both
paths are the same three phases in every rank:

  1. forward and backward of this rank's rows (``torch.autograd.grad``;
     attention through the flash kernels, the SSD scan of the SSM and
     hybrid families through the SSD chunk kernels), optionally
     accumulated over ``overlap_microbatches``;
  2. gradient sync: tuned, ``comm.sync_gradients(grads, mean=True)``
     (flat, N-level or bucketed, as the Communicator resolved); untuned,
     the backend's all-reduce of every leaf over the data-parallel ranks,
     averaged; then the loss is averaged over the data axes;
  3. the local AdamW step with ``cosine_with_warmup``, which leaves the
     replicas equal wherever the synced gradients are.

With ``overlap_backward`` (tuned only, as in the reference) phases 1 and
2 overlap: the forward and backward run under a release sink
(``comm.release_sink(..., overlap=True)``), whose thread syncs each
layer's gradients, deepest first, while autograd computes the layers
below; ``comm.sync_gradients_streamed`` then joins it and syncs the
residual (embeddings, final norm). The step's metrics keep their
meanings: ``compute_s`` is the forward and backward (ended by
synchronizing the backward's stream alone; the sync's stream runs on),
``sync_s`` the sync the step waits for after the backward (all of it
without overlap; with overlap, the wait for the sync thread plus the
residual sync), ``opt_s`` the optimizer; with overlap,
``release_sync_s`` adds the sync thread's busy seconds and
``release_events`` the released layers in release order.

Every family trains: dense, VLM (the dense stack over ``[patches |
tokens]``), MoE, SSM, hybrid and enc-dec. The hybrid's mamba layers
release under their global indices, its shared block syncs with the
residual; the enc-dec family's layers release as ``("decoder", i)`` and
then ``("encoder", i)``, each stack under its own key, and its
``enc_pos``, ``enc_final`` and embeddings sync with the residual.

Expert parallelism (the MoE family on a ``model`` axis above 1). The
reference runs it inside the one manual program of its tuned step
(``ep_manual``) and, untuned, in a nested ``shard_map`` that XLA
partitions. The port's ranks are processes, so every path takes the
manual form (`models.moe_model`): the rows of the batch split over the
data axes as before and replicated over ``model``, each rank's
sequence chunk through its local experts. Its per-rank backward is the
gradient of the SUM of the tp model ranks' (equal) losses, as the
reference's transposes make it: expert-shard gradients carry a factor
tp, and each rank's replicated-param gradients hold only its own
chunk's expert-path part. `ep_correct` fixes that replica factor on
both paths (expert gradients divided by tp, replicated ones averaged
over ``model``), then the sync runs over the data tiers only, so an
expert slice is synced among the ranks that hold it. Under
``overlap_backward`` the correction follows
``sync_gradients_streamed``: it is linear, so the values are the
reference's (which corrects before its streamed sync) up to reduction
order. The backward itself issues ``model``-axis collectives there (the
exchange's and the sequence gather's gradients) on the main thread,
while the sync thread syncs each released layer over the data tiers on
its own stream: the two use two axes, each with its own ``gloo`` group
and arena (`group.Arena`). AdamW clips by the whole tree's norm
(`ep_global_norm`), so the replicated params stay equal on every rank.
The reference's untuned path, XLA's partitioning, is the oracle the
tests hold the port's ``"xla"`` path to.

Tensor parallelism (every other family on a ``model`` axis above 1).
The reference stores the params Megatron-style over ``model``
(``param_specs``: heads, FFN columns and vocab split where the axis
divides them) in both its steps; XLA partitions the model axis, also
inside its tuned step's manual region, which is manual over the data
axes only, so its Communicator syncs over data. The port's ranks hold
their `sharding.tp_shard` slices and run the blocks column- and
row-parallel with explicit all-reduces over ``model`` (the backend's,
`layers.copy_to_model` and `layers.reduce_from_model`: the
reference's model-axis collectives are XLA's, never its
Communicator's). After the backward, `tp_correct` sums over ``model``
the gradients of the replicated key/value leaves that split query
heads only partly use; every other gradient is already whole (a
replicated leaf's, equal on every rank) or this rank's slice of it.
Then the sync runs over the data tiers only, tuned or ``"xla"``, among
the ranks that hold each slice, and AdamW clips by the whole tree's
norm (`split_global_norm` over `sharding.split_kinds`). Under
``overlap_backward`` the sync thread syncs each released layer over the
data tiers while the backward's model-axis collectives run on the main
thread, as under expert parallelism; `tp_correct` follows
``sync_gradients_streamed`` (linear, so the values are the plain
step's up to reduction order).

FSDP (``ParallelConfig.shard_params_over_data``; the untuned step
only, as in the reference: `validate_collectives` rejects a tuned sync
and ``overlap_backward``). The reference stores each weight split over
the data axes (``param_specs``' ``fsdp`` rule) and XLA gathers it where
the forward reads it and reduce-scatters its gradient. Each port rank
holds its `sharding.fsdp_shard` of the full seeded draw; the forward
gathers the rest of the tree (embeddings, the hybrid's shared block)
once and each layer's params where they enter the model, each through
one `layers.GatherPoint` all-gather over the data axes
(`sharding.data_axis`); the backward reduce-scatters their cotangents
at the same points, so each shard's gradient arrives summed over the
data ranks and the sync only divides it by dp; the replicated leaves
(norms, positions, biases) take the backend's all-reduce over the data
axes, averaged. AdamW clips by `split_global_norm` and updates the
shards. ``gather_in_compute_dtype`` casts the shards before the gather
(bf16 on the wire, in the gathered weights and in the reduce-scatter).
``compute_s`` includes the gathers and reduce-scatters; ``gather_s``
and ``reduce_scatter_s`` time them apart, and ``collectives`` counts
the step's gathers, reduce-scatters and all-reduces over the data axes.

FSDP on a ``model`` axis above 1 composes both halves of
``param_specs``, as the reference's production layout does: each rank
holds `sharding.shard` of the full draw, its tensor-parallel slices (or
experts) cut to its FSDP shard on another dimension. The data axes are
then the data ranks of this rank's model coordinate (`data_axis`, made
when the step is built): the gather points gather the model slices
whole over them, so the blocks' tensor-parallel operators, and the MoE
dispatch, see what they see without FSDP. A step issues, on every rank
in the same order, on autograd's one thread: the gathers and the
model-axis collectives of the forward in program order, then the
backward's model-axis all-reduces and each gather point's
reduce-scatter as the graph releases them; then `tp_correct` (the mixed
layout's key/value gradients summed over ``model``) or `ep_correct`;
then the sync over the data axes (shards divided by dp, every other
leaf all-reduced over this model coordinate's data ranks and
averaged); then the clip's norm, each leaf's squares summed over
exactly the axes that cut it (`split_global_norm` over
`sharding.split_kinds`: whole, ``model``, data or both). With a model
axis, ``model_s`` and ``model_collectives`` (all-reduces, all-gathers,
all-to-alls; also in ``collectives`` under FSDP) time and count the
step's collectives over ``model`` (`group.Tally`).
"""
from __future__ import annotations

import contextlib
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
from repro_torch.models import layers as L
from repro_torch.models import moe
from repro_torch.models.registry import build_model, train_batch_shapes
from repro_torch.optim import AdamW, cosine_with_warmup
from repro_torch.parallel import sharding as sh

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the top-level keys of the per-layer param lists (``bridge.STACKED``):
#: each layer gathers at its own point, the rest of the tree at one
_LAYER_KEYS = ("layers", "encoder", "decoder")


@dataclasses.dataclass
class TrainStep:
    """``fn(params, opt_state, batch) -> (params, opt_state, metrics)``
    over this rank's rows ``rows`` of the global batch (``fn(...,
    keep_grads=True)``: ``metrics["local_grads_fingerprint"]`` is the
    `pytree.fingerprint` of this rank's gradients before the sync, and
    ``["grads"]`` the synced tree; the update writes into ``params`` and
    ``opt_state``, as `AdamW.update` does), with the model
    (``api``) and optimizer (``opt``) it was built over; ``grad(params,
    batch) -> ((loss, aux), grads)`` is its first phase alone, this
    rank's gradients before `ep_correct` / `tp_correct` and the sync.
    ``init(gen)`` draws the params this rank holds: all of them, or its
    `sharding.shard` of the full draw (its experts with ``ep_axis``, its
    tensor-parallel slices with ``tp_axis``, each cut to its FSDP shard
    with ``fsdp``; the full draw is freed before it returns; on ``meta``,
    ``init(None)`` makes the same tree with no storage).
    ``example_args(gen)``: ``(params, opt_state, batch)`` of this rank, the
    batch its rows of zeros (on ``meta``: the reference's stand-ins)."""

    fn: Callable
    grad: Callable
    api: Any
    opt: AdamW
    tuned: bool
    rows: slice
    mesh: Any = None
    ep_axis: Optional[str] = None
    tp_axis: Optional[str] = None
    fsdp: bool = False
    shape: Optional[ShapeConfig] = None

    def init(self, gen: Optional[torch.Generator]):
        return sh.shard(self.api.init(gen), self.mesh, self.api.cfg,
                        self.fsdp)

    @property
    def model_axis(self) -> Optional[str]:
        """The ``model`` axis this step splits params over, or None."""
        return self.ep_axis or self.tp_axis

    def kinds(self, tree) -> dict:
        """A held tree's leaves by the halves of the mesh that cut them
        (`sharding.split_kinds`: ``{(): whole, ("model",): ..., ("data",):
        ..., ("model", "data"): ...}``, the kinds that occur)."""
        return sh.split_kinds(tree, self.api.cfg, self.mesh, self.fsdp)

    def gather(self, tree):
        """A held tree with every split leaf gathered whole (FSDP shards
        over the data axes, then slices over the model axis), on every
        rank (collective over them); the tree itself otherwise."""
        return sh.gather(tree, self.mesh, self.api.cfg, self.fsdp)

    def example_args(self, gen: Optional[torch.Generator] = None) -> tuple:
        params = self.init(gen)
        return (params, self.opt.init(params),
                batch_args(self.api.cfg, self.shape, self.rows,
                           self.api.device))


def batch_args(cfg: ModelConfig, shape: ShapeConfig, rows: slice, device,
               labels: bool = True) -> dict:
    """This rank's rows of a global batch of ``shape`` as zeros (on
    ``meta``, shapes and types alone): tokens and labels, with the
    enc-dec family's frames and the VLM's patches
    (``registry.train_batch_shapes``)."""
    n = rows.stop - rows.start
    return {name: torch.zeros((n,) + tuple(shp[1:]), dtype=dt,
                              device=device)
            for name, (shp, dt) in train_batch_shapes(cfg, shape).items()
            if labels or name != "labels"}


def ep_correct(grads, mesh, ep_axis: str = "model"):
    """Fix the expert-parallel replica factor of this rank's gradients
    (the reference's ``ep_correct``, ``repro/launch/steps.py``): expert
    shards divided by tp, replicated leaves averaged over ``ep_axis``
    (their sum over the ranks is tp x the true gradient)."""
    tp = mesh.shape[ep_axis]
    return sh.map_ep(grads, lambda g: g / tp,
                     lambda g: _pmean(g, mesh, (ep_axis,)))


#: the faults of the expert-parallel step `planted_ep_fault` plants
EP_FAULTS = ("undivided", "not_pmeaned", "identity_reverse")


def _undivided(grads, mesh, ep_axis: str = "model"):
    return sh.map_ep(grads, lambda g: g,
                     lambda g: _pmean(g, mesh, (ep_axis,)))


def _not_pmeaned(grads, mesh, ep_axis: str = "model"):
    tp = mesh.shape[ep_axis]
    return sh.map_ep(grads, lambda g: g / tp, lambda g: g)


def _reshaped(buf, axis, tp, algorithm):
    """The reverse exchange's shape change with no exchange."""
    return buf.reshape(-1, buf.shape[1] // tp, buf.shape[2])


def _reshaped_back(buf, axis, tp, algorithm):
    return buf.reshape(buf.shape[0] // tp, -1, buf.shape[2])


@contextlib.contextmanager
def planted_ep_fault(fault: str):
    """Plant one fault of the expert-parallel step in this process for
    the length of the block, so that a check can show it fails:
    ``"undivided"`` leaves the expert gradients undivided by tp and
    ``"not_pmeaned"`` the replicated ones unaveraged over the model axis
    (`ep_correct`); ``"identity_reverse"`` replaces the reverse dispatch
    exchange, and its gradient, by a reshape. Adam's first step hides a
    gradient's scale, so the step's synced gradients show each fault,
    its params need not."""
    saved = globals()["ep_correct"], moe._DIRECTIONS["rev"]
    if fault == "undivided":
        globals()["ep_correct"] = _undivided
    elif fault == "not_pmeaned":
        globals()["ep_correct"] = _not_pmeaned
    elif fault == "identity_reverse":
        moe._DIRECTIONS["rev"] = (_reshaped, _reshaped_back)
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {EP_FAULTS}")
    try:
        yield
    finally:
        globals()["ep_correct"], moe._DIRECTIONS["rev"] = saved


#: the axes a kind of leaf's squares are summed over in the clip's norm
#: (a planted fault swaps it: `planted_fsdp_fault`)
_NORM_AXES = {"fn": lambda kind: kind}


def split_global_norm(parts, axes) -> torch.Tensor:
    """The global norm of the whole gradient tree from a rank that holds
    a part of it: ``parts`` = ``{kind: tree}`` (`sharding.split_kinds`),
    each kind's sum of squares summed over the axes that cut it (``axes``
    maps ``"model"`` and ``"data"`` to a `group.Axis`), the same bits on
    every rank. (The reference's untuned step, the oracle, clips by this
    norm; under expert parallelism its tuned step clips each rank by its
    own slice's norm, under tensor parallelism it sees whole leaves.)"""
    total = 0
    for kind, tree in parts.items():
        sq = sum(torch.sum(torch.square(x.to(torch.float32)))
                 for x in pytree.leaves(tree))
        for name in _NORM_AXES["fn"](kind):
            sq = grp.psum(sq, axes[name])
        total = total + sq
    return torch.sqrt(total)


def ep_global_norm(grads, mesh, ep_axis: str = "model") -> torch.Tensor:
    """`split_global_norm` of a rank holding a slice of its experts."""
    rep, split = sh.ep_split(grads)
    return split_global_norm({(): rep, ("model",): split},
                             {"model": mesh.axis(ep_axis)})


def tp_correct(grads, mesh, cfg, tp_axis: str = "model"):
    """Sum over ``tp_axis`` the gradients of the replicated key/value
    leaves that the split query heads only partly use (`sharding.tp_mixed`:
    each rank's backward gives the part of its own query heads). Every
    other replicated leaf's gradient comes out whole and equal on every
    rank (the blocks' `layers.copy_to_model` sums the cotangents), and
    each split leaf's is its slice of the whole gradient."""
    axis = mesh.axis(tp_axis)
    return sh.tp_partial(grads, lambda g: grp.psum(g, axis), cfg,
                         mesh.shape[tp_axis])


#: the faults of the tensor-parallel step `planted_tp_fault` plants
TP_FAULTS = ("copy_not_summed", "kv_not_summed")


@contextlib.contextmanager
def planted_tp_fault(fault: str):
    """Plant one fault of the tensor-parallel step in this process for
    the length of the block: ``"copy_not_summed"`` skips the all-reduce
    in `layers.copy_to_model`'s backward (each rank keeps its own part
    of a replicated activation's cotangent); ``"kv_not_summed"`` skips
    `tp_correct` (the key/value gradients of the mixed layout stay
    partial)."""
    saved = globals()["tp_correct"], L._COPY_BACKWARD["fn"]
    if fault == "copy_not_summed":
        L._COPY_BACKWARD["fn"] = lambda ct, axis: ct
    elif fault == "kv_not_summed":
        globals()["tp_correct"] = lambda grads, mesh, cfg, tp_axis="model": \
            grads
    else:
        raise ValueError(f"unknown fault {fault!r}; one of {TP_FAULTS}")
    try:
        yield
    finally:
        globals()["tp_correct"], L._COPY_BACKWARD["fn"] = saved


#: the faults of the FSDP step `planted_fsdp_fault` plants
FSDP_FAULTS = ("not_reduced", "gathered_reversed")
#: the fault of the clip's norm on a mesh with both halves
NORM_FAULTS = ("norm_one_axis",)


def _own_block(x, axis):
    return x.chunk(axis.size)[grp.rank(axis)].clone()


def _reversed_gather(x, axis):
    return grp.all_gather(x, axis).view(axis.size, -1).flip(0).reshape(-1)


@contextlib.contextmanager
def planted_fsdp_fault(fault: str):
    """Plant one fault of the FSDP step in this process for the length of
    the block: ``"not_reduced"`` makes the gather points' backward keep
    this rank's block of the cotangents instead of reduce-scattering
    them; ``"gathered_reversed"`` gathers the shards in reverse rank
    order; ``"norm_one_axis"`` (`NORM_FAULTS`) sums the squares of the
    leaves cut by both halves over ``model`` only in the clip's norm."""
    saved = dict(L._FSDP_COLLECTIVES), _NORM_AXES["fn"]
    if fault == "not_reduced":
        L._FSDP_COLLECTIVES["reduce_scatter"] = _own_block
    elif fault == "gathered_reversed":
        L._FSDP_COLLECTIVES["gather"] = _reversed_gather
    elif fault == "norm_one_axis":
        _NORM_AXES["fn"] = lambda kind: kind[:1]
    else:
        raise ValueError(f"unknown fault {fault!r}; one of "
                         f"{FSDP_FAULTS + NORM_FAULTS}")
    try:
        yield
    finally:
        L._FSDP_COLLECTIVES.update(saved[0])
        _NORM_AXES["fn"] = saved[1]


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


def _local_fingerprint(grads, sink) -> list:
    """`pytree.fingerprint` of this rank's gradients before any sync,
    leaf by leaf in tree order: each released layer's as the sink took it
    at its release (the layers under every released key: ``layers``, or
    the enc-dec family's ``encoder`` and ``decoder``), the residual's
    from ``grads``."""
    released = {tag[0] for tag in sink.fingerprints}
    out = []
    for key in sorted(grads):           # pytree's order of a dict
        if key in released:
            for i in range(len(grads[key])):
                out.extend(sink.fingerprints[(key, i)])
        else:
            out.extend(pytree.fingerprint(grads[key]))
    return out


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
    time the three phases, each ended by synchronizing the device (see
    the module's text for their meanings under ``overlap_backward``)."""
    comm = communicator or Communicator.from_config(coll, mesh)
    tuned = comm.is_tuned
    validate_collectives(coll, parallel, tuned=tuned)
    overlap = coll.overlap_backward     # tuned: validate_collectives
    ep_axis = tp_axis = None
    if sh.model_size(mesh) > 1:
        if cfg.family == "moe":
            ep_axis = "model"
        else:
            tp_axis = "model"
    fsdp = parallel.shard_params_over_data
    dev = torch.device(device)
    cd = _DTYPES[parallel.compute_dtype]
    api = build_model(cfg, compute_dtype=cd,
                      param_dtype=_DTYPES[parallel.param_dtype],
                      remat=parallel.remat != "none", device=dev,
                      ep_axis=ep_axis, tp_axis=tp_axis, mesh=mesh,
                      a2a_algorithm=comm)
    opt = AdamW(lr=lr)
    model_axis = ep_axis or tp_axis
    dpx = sh.dp_axes(mesh)
    dp = sh.dp_size(mesh)
    rows = sh.batch_rows(mesh, shape.global_batch)
    point = data_ax = None
    if fsdp:
        # made here, where every rank makes it (`RankMesh.joint`): with
        # a model axis, the data ranks of this rank's model coordinate
        data_ax = sh.data_axis(mesh)
        point = L.GatherPoint(data_ax,
                              lambda tree: sh.fsdp_dims(tree, cfg, dp), dev)

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
        if point is None:
            loss, aux = api.loss(p, batch)
        else:
            # the rest of the tree gathered once, each layer's params
            # where they enter the model
            rest = point({k: v for k, v in p.items()
                          if k not in _LAYER_KEYS})
            p = {**{k: v for k, v in p.items() if k in _LAYER_KEYS},
                 **rest}
            del rest
            with L.gather_scope(point):
                loss, aux = api.loss(p, batch)
        del p
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        aux = pytree.tree_map(lambda t: t.detach(), aux)
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
        if fsdp:
            # the shards' gradients arrive summed by the backward's
            # reduce-scatter; every other leaf (replicated, or a model
            # slice whole over data) all-reduces over data_ax, averaged
            leaves, treedef = pytree.flatten(grads)
            return treedef.unflatten([
                g / dp if d is not None else grp.psum(g, data_ax) / dp
                for g, d in zip(leaves, sh.fsdp_dims(grads, cfg, dp))])
        if model_axis is None:
            # the backend's all-reduce over the data-parallel ranks (the
            # whole group: no model axis), averaged
            return pytree.tree_map(lambda g: grp.psum(g) / dp, grads)
        # over the data axes only: among the ranks that hold each slice
        return pytree.tree_map(lambda g: _pmean(g, mesh, dpx), grads)

    def correct(grads):
        if ep_axis is not None:
            return ep_correct(grads, mesh, ep_axis)
        if tp_axis is not None:
            return tp_correct(grads, mesh, cfg, tp_axis)
        return grads

    def overlapped(params, batch, keep_grads):
        """Forward and backward under a release sink whose thread syncs
        each layer as autograd releases it; the step's phase-1 result
        and the sink, whose syncs may still run."""
        sink = comm.release_sink(coll.bucket_bytes, overlap=True,
                                 device=dev, fingerprint=keep_grads)
        with L.release_scope(sink):
            (loss, aux), grads = value_and_grad(params, batch)
        if dev.type == "cuda":      # the backward's stream, not the sync's
            torch.cuda.current_stream(dev).synchronize()
        return (loss, aux), grads, sink

    def run(params, opt_state, batch, keep_grads):
        if point is not None:
            point.reset()
        t0 = time.perf_counter()
        if overlap:
            (loss, aux), grads, sink = overlapped(params, batch, keep_grads)
        else:
            (loss, aux), grads = grad_fn(params, batch)
            _synchronize(dev)
        t1 = time.perf_counter()
        kept = {}
        if keep_grads:          # between the phases, untimed
            kept["local_grads_fingerprint"] = \
                _local_fingerprint(grads, sink) if overlap \
                else pytree.fingerprint(grads)
        t1b = time.perf_counter()
        if overlap:
            grads = comm.sync_gradients_streamed(grads, sink, mean=True)
            kept["release_sync_s"] = sink.busy_s
            kept["release_events"] = [i for _, i in sink.events]
            del sink                    # its synced layers, before correct
            grads = correct(grads)
        else:
            grads = correct(grads)      # the raw tree freed before the sync
            grads = sync(grads)
        loss = _pmean(loss, mesh, dpx)
        aux = pytree.tree_map(lambda v: _pmean(v, mesh, dpx), aux)
        _synchronize(dev)
        t2 = time.perf_counter()
        gnorm = parts = None
        if opt.grad_clip and (model_axis or fsdp):
            parts = step.kinds(grads)
            gnorm = split_global_norm(parts, {
                "model": mesh.axis(model_axis) if model_axis else None,
                "data": data_ax})
        new_params, new_opt = opt.update(grads, opt_state, params,
                                         lr_scale=lr_scale(opt_state.step),
                                         gnorm=gnorm)
        _synchronize(dev)
        t3 = time.perf_counter()
        metrics = {"loss": loss, **aux, "compute_s": t1 - t0,
                   "sync_s": t2 - t1b, "opt_s": t3 - t2, **kept}
        if point is not None:
            n_rep = sum(d is None for d in sh.fsdp_dims(params, cfg, dp))
            metrics.update(
                gather_s=point.gather_s,
                reduce_scatter_s=point.reduce_scatter_s,
                collectives={
                    "gathers": point.gathers,
                    "reduce_scatters": point.reduce_scatters,
                    # the leaves not sharded, the loss and aux over each
                    # data axis, the clip's norm's sums over the data axes
                    "all_reduces": n_rep + len(dpx) * (
                        1 + len(pytree.leaves(aux)))
                    + sum("data" in kind for kind in parts or ())})
        if gnorm is not None:
            metrics["grad_norm"] = gnorm
        if keep_grads:
            metrics["grads"] = grads
        return new_params, new_opt, metrics

    def fn(params, opt_state, batch, keep_grads=False):
        if model_axis is None:
            return run(params, opt_state, batch, keep_grads)
        with grp.Tally(model_axis, dev) as tally:
            new_params, new_opt, metrics = run(params, opt_state, batch,
                                               keep_grads)
        c = tally.counts
        model = {"model_all_reduces": c["psum"] + c["pmax"],
                 "model_all_gathers": c["all_gather"],
                 "model_all_to_alls": c["all_to_all"]}
        metrics.update(model_s=tally.seconds, model_collectives=model)
        if "collectives" in metrics:
            metrics["collectives"].update(model)
        return new_params, new_opt, metrics

    step = TrainStep(fn=fn, grad=grad_fn, api=api, opt=opt, tuned=tuned,
                     rows=rows, mesh=mesh, ep_axis=ep_axis, tp_axis=tp_axis,
                     fsdp=fsdp, shape=shape)
    return step


# ---------------------------------------------------------------------------
# serving steps: the prefill and decode steps the dry-run accounts
# ---------------------------------------------------------------------------
LONG_CONTEXT_WINDOW = 8192


@dataclasses.dataclass
class ServePlan:
    run: bool
    cache_len: int = 0
    window: int = 0
    reason: str = ""


def serve_plan(cfg: ModelConfig, shape: ShapeConfig) -> ServePlan:
    """The reference's decode policy (``repro/launch/steps.serve_plan``)."""
    S = shape.seq_len
    if cfg.family == "ssm":
        return ServePlan(run=True, cache_len=0, window=0)
    if cfg.family == "encdec":
        if S > 32_768:
            return ServePlan(run=False, reason=(
                "whisper decoder is architecturally capped; 500k windowed "
                "decoder self-attention exercises nothing real (DESIGN §4)"))
        return ServePlan(run=True, cache_len=S, window=0)
    if S > 32_768:
        # sub-quadratic requirement: sliding window for attention caches
        return ServePlan(run=True, cache_len=LONG_CONTEXT_WINDOW,
                         window=LONG_CONTEXT_WINDOW)
    return ServePlan(run=True, cache_len=S, window=0)


@dataclasses.dataclass
class ServeStep:
    """A prefill or decode step of this rank: ``fn(*example_args())``.
    Prefill: ``fn(params, batch) -> logits`` of the last position (this
    rank's vocab block on a ``model`` axis that splits the vocab, as the
    reference's output stays sharded); decode: ``fn(params, cache,
    tokens) -> (next tokens (B, 1) int32, cache)``. ``example_args(gen)``
    draws this rank's held params (``gen`` None on ``meta``) and makes its
    rows of the inputs: zeros, and for decode the whole cache cut to
    this rank's block (`sharding.cache_shard`)."""

    kind: str
    fn: Callable
    api: Any
    mesh: Any
    rows: slice
    shape: ShapeConfig
    fsdp: bool = False
    cache_len: int = 0
    shard_cache_seq: bool = False
    #: the keywords the decode step passes the family's ``decode_step``
    #: (its model and sequence axes)
    decode_kw: dict = dataclasses.field(default_factory=dict)

    def init(self, gen: Optional[torch.Generator]):
        return sh.shard(self.api.init(gen), self.mesh, self.api.cfg,
                        self.fsdp)

    def example_args(self, gen: Optional[torch.Generator] = None) -> tuple:
        cfg, dev = self.api.cfg, self.api.device
        params = self.init(gen)
        if self.kind == "prefill":
            return params, batch_args(cfg, self.shape, self.rows, dev,
                                      labels=False)
        cache = sh.cache_shard(
            self.api.init_cache(self.shape.global_batch,
                                max(self.cache_len, 1)),
            self.mesh, cfg, shard_cache_seq=self.shard_cache_seq)
        tokens = torch.zeros((self.rows.stop - self.rows.start, 1),
                             dtype=torch.int32, device=dev)
        return params, cache, tokens


def _serve_model(cfg, mesh, parallel, device, window=0):
    """The model of a serving step (bf16 params, as the reference's) and
    the axes its step runs over: ``ep_axis`` for the MoE family on a
    ``model`` axis above 1, else ``tp`` (that axis), and the FSDP gather
    point."""
    dev = torch.device(device)
    api = build_model(cfg, window=window, param_dtype=torch.bfloat16,
                      compute_dtype=_DTYPES[parallel.compute_dtype],
                      device=dev)
    tp = ep_axis = None
    if sh.model_size(mesh) > 1:
        if cfg.family == "moe":
            ep_axis = "model"
        else:
            tp = mesh.axis("model")
    point = None
    if parallel.shard_params_over_data:
        dp = sh.dp_size(mesh)
        point = L.GatherPoint(sh.data_axis(mesh),
                              lambda tree: sh.fsdp_dims(tree, cfg, dp), dev)
    return api, tp, ep_axis, point


def _gathered_rest(params, point):
    """Under FSDP: the params with the rest of the tree (all but the
    per-layer lists) gathered once, each layer's at its point."""
    if point is None:
        return params
    rest = point({k: v for k, v in params.items() if k not in _LAYER_KEYS})
    return {**{k: v for k, v in params.items() if k in _LAYER_KEYS}, **rest}


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                       parallel: ParallelConfig, coll: CollectiveConfig,
                       mesh, *, communicator: Optional[Communicator] = None,
                       device="cuda") -> ServeStep:
    """Forward pass producing logits over the prompt (inference-prefill):
    each family's forward and logits, with the ``model`` axis as training
    runs it (tensor parallelism, or expert parallelism for the MoE
    family, whose dispatch all-to-all goes through the Communicator),
    under FSDP through the gather points; no gradient."""
    comm = communicator or Communicator.from_config(coll, mesh)
    api, tp, ep_axis, point = _serve_model(cfg, mesh, parallel, device)
    cd = _DTYPES[parallel.compute_dtype]
    from repro_torch.models import encdec, hybrid, moe_model, ssm, vlm
    from repro_torch.models import transformer as T

    def forward(params, batch):
        if cfg.family == "encdec":
            enc = encdec.encode(params, batch["audio"], cfg,
                                compute_dtype=cd, tp=tp)
            return encdec.decode_train(params, batch["tokens"], enc, cfg,
                                       compute_dtype=cd, tp=tp)
        if cfg.family == "vlm":
            x = vlm.assemble_embeds(params, batch, cfg, cd, tp=tp)
            return T.forward(params, x, cfg, compute_dtype=cd, tp=tp)
        if cfg.family == "moe":
            x = T.embed_tokens(params, batch["tokens"], cfg, cd)
            h, _ = moe_model.forward(params, x, cfg, ep_axis=ep_axis,
                                     mesh=mesh, a2a_algorithm=comm,
                                     compute_dtype=cd)
            return h
        x = T.embed_tokens(params, batch["tokens"], cfg, cd, tp=tp)
        if cfg.family == "ssm":
            return ssm.forward(params, x, cfg, compute_dtype=cd)
        if cfg.family == "hybrid":
            return hybrid.forward(params, x, cfg, compute_dtype=cd, tp=tp)
        return T.forward(params, x, cfg, compute_dtype=cd, tp=tp)

    @torch.no_grad()
    def fn(params, batch):
        if point is not None:
            point.reset()
        p = _gathered_rest(params, point)
        with L.gather_scope(point):
            h = forward(p, batch)
        return T.logits_fn(p, h, cfg, cd, tp, gather=False)[:, -1]

    return ServeStep(kind="prefill", fn=fn, api=api, mesh=mesh,
                     rows=sh.batch_rows(mesh, shape.global_batch),
                     shape=shape, fsdp=parallel.shard_params_over_data)


def build_decode_step(cfg: ModelConfig, shape: ShapeConfig,
                      parallel: ParallelConfig, coll: CollectiveConfig,
                      mesh, *, shard_cache_seq: bool = False,
                      device="cuda") -> ServeStep:
    """One-token serve step against a ``serve_plan`` cache: the family's
    ``decode_step`` on this rank's params (`sharding.shard`) and its
    block of a dense cache (`sharding.cache_shard`), on a ``model`` axis
    tensor-parallel (its vocab-parallel logits gathered for the argmax)
    or, for the MoE family, expert-parallel in its training layout (the
    reference decodes MoE with ``ep_axis=None``; a storage layout: the
    values are the one-process decode's); then the greedy next token."""
    del coll
    plan = serve_plan(cfg, shape)
    if not plan.run:
        raise ValueError(plan.reason)
    api, tp, ep_axis, point = _serve_model(cfg, mesh, parallel, device,
                                           window=plan.window)
    model = mesh.axis("model") if sh.model_size(mesh) > 1 else None
    kw = {}
    if ep_axis is not None:
        kw.update(ep_axis=ep_axis, mesh=mesh)
    elif tp is not None:
        kw["tp"] = tp
    if model is not None and shard_cache_seq and cfg.family != "ssm":
        if plan.cache_len % model.size == 0:
            kw["seq_axis"] = model
        if cfg.family == "encdec" and cfg.encoder_seq % model.size == 0:
            kw["cross_seq_axis"] = model

    @torch.no_grad()
    def fn(params, cache, tokens):
        if point is not None:
            point.reset()
        p = _gathered_rest(params, point)
        with L.gather_scope(point):
            logits, new_cache = api.decode_step(p, cache, tokens, **kw)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return nxt, new_cache

    return ServeStep(kind="decode", fn=fn, api=api, mesh=mesh,
                     rows=sh.batch_rows(mesh, shape.global_batch),
                     shape=shape, fsdp=parallel.shard_params_over_data,
                     cache_len=plan.cache_len,
                     shard_cache_seq=shard_cache_seq, decode_kw=kw)


def build_step(cfg: ModelConfig, shape: ShapeConfig,
               parallel: Optional[ParallelConfig] = None,
               coll: Optional[CollectiveConfig] = None, mesh=None, **kw):
    """The step of ``shape.kind``: `build_train_step`,
    `build_prefill_step` or `build_decode_step` (``shard_cache_seq``
    only for decode); each has ``fn`` and ``example_args``."""
    parallel = parallel or ParallelConfig()
    coll = coll or CollectiveConfig()
    if shape.kind == "train":
        return build_train_step(cfg, shape, parallel, coll, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, parallel, coll, mesh, **kw)
    return build_decode_step(cfg, shape, parallel, coll, mesh, **kw)
