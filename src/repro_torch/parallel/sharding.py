"""Data-parallel axes, each rank's rows of the batch, and each rank's
experts, tensor-parallel slices, FSDP shards or block of a decode cache
(port of ``repro/parallel/sharding.py``: ``dp_axes``, ``dp_size``,
``model_size``, ``batch_specs``, ``ep_param_specs`` as `map_ep`,
``param_specs``' ``model`` half as `tp_dim` and its data half as
`fsdp_dim`, and ``cache_specs``).

The reference shards a global batch over the data-parallel mesh axes
(``P(("pod", "data"), ...)``) and replicates the params; ``shard_map``
hands each device its block. The port's ranks each hold their own
block: `batch_rows` is the slice of the global batch that the
reference's layout gives this rank, from its coordinates on the mesh's
data axes (row-major, outermost axis first; in a remapped mesh the
coordinate of a rank is its slot's, ``group.rank(axis)``).

Expert parallelism: the reference splits the MoE experts of each layer
(``w_gate``, ``w_up``, ``w_down``, stacked ``(L, E, ...)``) over the
``model`` axis on E and replicates everything else (its
``ep_param_specs``; here `map_ep` treats the two kinds of leaf apart).
A port rank at coordinate ``m`` of the axis holds the experts
``[m * E/tp, (m+1) * E/tp)`` of every layer (`expert_range`): every
rank draws the full params from the same generator and keeps its slice
(`ep_shard`), so each rank's layout equals a one-rank draw's, sliced;
`ep_gather` puts the slices back together (checkpoints).

Tensor parallelism (every other family on a ``model`` axis above 1):
the reference stores the params Megatron-style (``param_specs``'
``model`` half): attention heads (``wq``/``wk``/``wv``, their biases
and ``wo``), the dense FFN's hidden columns and the vocab rows of
``tok`` and columns of ``out`` split over ``model``, each only where
the axis divides the count, everything else (norms, positions, the SSM
projections and parameters) replicated. `tp_dim` is that rule for one
of the port's per-layer leaves (the reference's stacked leaves carry a
lead layer dimension, so its split dimension is one higher), `tp_shard`
cuts every leaf of a full draw to this rank's slice, and `tp_gather`
puts the slices of a held tree back together (checkpoints, tests).
`tp_held_dim` reads the same layout off a held leaf, from the config's
counts. `tp_partial` names the replicated key/value leaves that split
query heads only partly use (their gradients are summed over
``model``).

FSDP (``ParallelConfig.shard_params_over_data``, ZeRO-3 style): the
reference splits each weight along one dimension over all the data axes
together (``param_specs``' data half, its ``fsdp(dim)`` rule), where
their product divides it; the norms, biases, positions and the SSM's
small parameters stay replicated. `fsdp_dim` is that rule for a
per-layer leaf, `fsdp_held_dim` reads it off a held shard, `fsdp_shard`
cuts a full draw to this rank's shard (the block of its `dp_index`),
and `fsdp_gather` puts the shards back together on every rank
(checkpoints, kept params, tests).
`data_axis` is the one `group.Axis` over the data axes whose collectives
move the shards (its index is `dp_index`): on a mesh with a ``model``
axis above 1, the data ranks of this rank's model coordinate.

Both halves together (FSDP on a ``model`` axis above 1): ``param_specs``
gives a leaf ``"model"`` on one dimension and the data axes on another,
never the same one (heads, FFN columns, vocab or experts over
``model``; ``d`` or ``d_inner`` over data). `shard` cuts a full draw
to the model half first (`tp_shard`, or `ep_shard` for the MoE family)
and then to the data half (`fsdp_shard`, the block of `dp_index`: the
data index is the same on every model coordinate); `gather` is its
inverse (`fsdp_gather`, then `tp_gather` / `ep_gather`). Each half
reads its dimension off a held leaf from the config's counts of the
dimension it splits, which the other half never cuts, so
`tp_held_dim` and `fsdp_held_dim` read a leaf cut by both halves as
they read one cut by one. `held_kinds` names the halves that cut a held
leaf, `split_kinds` splits a tree into the four kinds (whole, split
over ``model``, sharded over data, both), which the clip's norm and the
replica check treat apart.

The mesh is always passed in: there is no module-level current mesh
(the reference's ``set_current_mesh`` / ``_CURRENT_MESH``). The
reference's ``constrain_*`` helpers and its sequence sharding of the
residual stream are XLA layout hints that change no value beyond the
order of a reduction, so the port has none: its blocks run their
collectives explicitly (``models/layers.py``).

Decode caches (the decode step of ``launch/steps.py``): `cache_specs` is
the reference's rule over the port's caches, which keep the reference's
stacked layouts (KV ``(L, B, T, KV, Dh)``, the enc-dec family's cross
KV ``(L, B, T_enc, H, Dh)``, conv ``(L, B, W-1, Cd)``, SSD state ``(L,
B, H, N, P)``): the batch over the data axes, kv heads (or SSD heads)
over ``model`` where the axes divide them, or, with
``shard_cache_seq``, a KV cache's slots over ``model`` instead of its
heads. Each leaf's spec is a tuple of entries as the reference's
``PartitionSpec`` holds them (the data axes' tuple, ``"model"`` or
None a dimension). `cache_shard` cuts a whole cache to this rank's
block of every leaf.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.core.collectives import group as grp

#: the MoE block's expert weights, split over the expert-parallel axis
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
#: the kinds of held leaf `split_kinds` tells apart: the halves of the
#: mesh each is split over (``"data"``: all the data axes together)
KINDS = ((), ("model",), ("data",), ("model", "data"))


def dp_axes(mesh) -> Tuple[str, ...]:
    """Data-parallel mesh axes, outermost first ("dcn" across the WAN
    links, "pod" across pods, "data" inside)."""
    return tuple(a for a in ("dcn", "pod", "data") if a in mesh.axis_names)


def dp_size(mesh) -> int:
    s = 1
    for a in dp_axes(mesh):
        s *= mesh.shape[a]
    return s


def model_size(mesh) -> int:
    return mesh.shape.get("model", 1)


def dp_index(mesh) -> int:
    """This rank's block of a batch sharded over the data axes: its
    coordinates on them, row-major in mesh order."""
    i = 0
    for a in dp_axes(mesh):
        i = i * mesh.shape[a] + grp.rank(mesh.axis(a))
    return i


def batch_rows(mesh, global_batch: int) -> slice:
    """The rows of a ``global_batch``-row batch that this rank holds: the
    reference's ``batch_specs`` splits the batch axis over the data axes
    when they divide it, else replicates it."""
    n = dp_size(mesh)
    if global_batch % n:
        return slice(0, global_batch)
    per = global_batch // n
    i = dp_index(mesh)
    return slice(i * per, (i + 1) * per)


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------
def _map_with_path(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_map_with_path(v, fn, path + (i,))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(path, tree)


def _is_expert(path) -> bool:
    """A MoE block's expert weight: ``.../moe/{w_gate,w_up,w_down}``
    (not the dense residual MLP's, ``.../moe/dense/w_*``)."""
    return len(path) >= 2 and path[-2] == "moe" and \
        path[-1] in EXPERT_LEAVES


def expert_range(mesh, num_experts: int, ep_axis: str = "model"
                 ) -> Tuple[int, int]:
    """The experts ``[lo, hi)`` this rank holds."""
    tp = mesh.shape[ep_axis]
    if num_experts % tp:
        raise ValueError(f"{num_experts} experts not divisible by axis "
                         f"{ep_axis}={tp}")
    m = grp.rank(mesh.axis(ep_axis))
    per = num_experts // tp
    return m * per, (m + 1) * per


def ep_shard(params, mesh, ep_axis: str = "model"):
    """``params`` (every expert) with each expert weight cut to this
    rank's `expert_range` (a copy, so the full tensor can be freed)."""
    def cut(path, t):
        if not _is_expert(path):
            return t
        lo, hi = expert_range(mesh, t.shape[0], ep_axis)
        return t[lo:hi].clone()
    return _map_with_path(params, cut)


def ep_gather(tree, mesh, ep_axis: str = "model"):
    """The inverse of `ep_shard`: every expert weight gathered over the
    axis in axis order, on every rank. Collective over ``ep_axis``."""
    axis = mesh.axis(ep_axis)
    return _map_with_path(
        tree, lambda path, t: grp.all_gather(t, axis) if _is_expert(path)
        else t)


def map_ep(tree, expert, replicated):
    """``expert(leaf)`` on every expert weight, ``replicated(leaf)`` on
    every other leaf, in the same order on every rank."""
    return _map_with_path(
        tree, lambda path, t: expert(t) if _is_expert(path)
        else replicated(t))


def ep_split(tree):
    """``(replicated, experts)``: two trees of ``tree``'s structure, each
    with the other's leaves set to ``None`` (an empty node)."""
    return (map_ep(tree, lambda t: None, lambda t: t),
            map_ep(tree, lambda t: t, lambda t: None))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
#: the attention leaves whose head dimension may split over ``model``
#: (``wq``/``wk``/``wv`` ``(d, H, Dh)``, biases ``(H, Dh)``, ``wo``
#: ``(H, Dh, d)``), and the dimension
_HEAD_DIM = {"wq": 1, "wk": 1, "wv": 1, "bq": 0, "bk": 0, "bv": 0,
             "wo": 0}
#: the key/value leaves: replicated where the kv heads do not divide
#: the axis and the query heads do (`tp_partial`)
KV_LEAVES = ("wk", "wv", "bk", "bv")


def _tp_candidate(path, ndim: int) -> Optional[int]:
    """The dimension of a per-layer leaf that ``param_specs`` would put
    on ``model`` if the axis divided it, from the leaf's name."""
    name = path[-1] if path else None
    if not isinstance(name, str):
        return None
    if name == "tok":                       # (Vp, d): vocab rows
        return 0
    if name == "out":                       # (d, Vp): vocab columns
        return 1
    if name in ("w_gate", "w_up", "w_down"):
        if ndim != 2:                       # a MoE expert stack (E, ...)
            return None
        return 0 if name == "w_down" else 1     # (ff, d) / (d, ff)
    return _HEAD_DIM.get(name)


def tp_dim(path, shape, tp: int) -> Optional[int]:
    """The dimension of the full per-layer leaf at ``path`` (its keys)
    with ``shape`` that a ``model`` axis of ``tp`` splits, or None (the
    leaf is replicated): ``param_specs``' rule, with its divisibility
    guard."""
    d = _tp_candidate(path, len(shape))
    if tp > 1 and d is not None and shape[d] % tp == 0:
        return d
    return None


def _tp_count(name: str, cfg) -> int:
    """The full size of the split dimension of leaf ``name``."""
    if name in ("tok", "out"):
        from repro_torch.models.layers import pad_vocab
        return pad_vocab(cfg.vocab_size)
    if name in ("w_gate", "w_up", "w_down"):
        return cfg.d_ff
    return cfg.num_kv_heads if name in KV_LEAVES else cfg.num_heads


def tp_held_dim(path, shape, cfg, tp: int) -> Optional[int]:
    """The dimension of a HELD leaf (a rank's `tp_shard` slice) that is
    split over a ``model`` axis of ``tp``, or None."""
    d = _tp_candidate(path, len(shape))
    if tp > 1 and d is not None and shape[d] * tp == _tp_count(path[-1],
                                                               cfg):
        return d
    return None


def tp_mixed(cfg, tp: int) -> bool:
    """Whether the query heads split over ``tp`` and the kv heads do not
    (the key/value leaves stay replicated, each rank reading the kv
    heads of its query heads)."""
    return tp > 1 and cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp != 0


def tp_shard(params, mesh, tp_axis: str = "model"):
    """``params`` (full leaves) with every leaf that `tp_dim` splits cut
    to this rank's slice along the axis (a copy, so the full tensor can
    be freed)."""
    tp = mesh.shape[tp_axis]
    m = grp.rank(mesh.axis(tp_axis))

    def cut(path, t):
        d = tp_dim(path, t.shape, tp)
        if d is None:
            return t
        n = t.shape[d] // tp
        return t.narrow(d, m * n, n).clone()
    return _map_with_path(params, cut)


def tp_gather(tree, mesh, cfg, tp_axis: str = "model"):
    """The inverse of `tp_shard` on a held tree (params, or anything of
    their structure: gradients, Adam's moments): every split leaf
    gathered over the axis in axis order, on every rank. Collective over
    ``tp_axis``."""
    axis, tp = mesh.axis(tp_axis), mesh.shape[tp_axis]

    def gather(path, t):
        d = tp_held_dim(path, t.shape, cfg, tp)
        if d is None:
            return t
        whole = grp.all_gather(t.movedim(d, 0).contiguous(), axis)
        return whole.movedim(0, d).contiguous()
    return _map_with_path(tree, gather)


def tp_partial(tree, fn, cfg, tp: int):
    """``fn(leaf)`` on the key/value leaves that the split query heads
    only partly use (`tp_mixed`), every other leaf as it is."""
    if not tp_mixed(cfg, tp):
        return tree
    return _map_with_path(
        tree, lambda path, t: fn(t) if path[-1] in KV_LEAVES else t)


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------
def data_axis(mesh):
    """This rank's `group.Axis` over all the data axes together, its
    index `dp_index` (``mesh.joint``: the whole group without a
    ``model`` axis above 1)."""
    return mesh.joint(dp_axes(mesh))


def _fsdp_candidate(path, ndim: int) -> Optional[int]:
    """The dimension of a per-layer leaf that ``param_specs`` would put
    on the data axes if they divided it, from the leaf's name."""
    name = path[-1] if path else None
    if not isinstance(name, str):
        return None
    if name == "tok":                       # (Vp, d)
        return 1
    if name in ("out", "wq", "wk", "wv", "router", "in_proj", "out_proj"):
        return 0                            # (d, ...), out_proj (d_inner, d)
    if name == "wo":                        # (H, Dh, d)
        return 2
    if name in ("w_gate", "w_up", "w_down"):
        if ndim == 3:                       # a MoE expert stack (E, ...)
            return 2 if name == "w_down" else 1
        return 1 if name == "w_down" else 0     # (ff, d) / (d, ff)
    return None


def fsdp_dim(path, shape, dp: int) -> Optional[int]:
    """The dimension of the full per-layer leaf at ``path`` with
    ``shape`` that FSDP over ``dp`` data ranks splits, or None (the leaf
    is replicated): ``param_specs``' ``fsdp`` rule, with its
    divisibility guard."""
    d = _fsdp_candidate(path, len(shape))
    if dp > 1 and d is not None and shape[d] % dp == 0:
        return d
    return None


def fsdp_held_dim(path, shape, cfg, dp: int) -> Optional[int]:
    """The dimension of a HELD leaf (a rank's `fsdp_shard` shard, also
    cut over ``model`` or not) that is split over ``dp`` data ranks, or
    None: the candidate dimension, ``d`` or ``d_inner``, read against the
    config's count, which a ``model`` cut never changes."""
    d = _fsdp_candidate(path, len(shape))
    full = cfg.d_inner if path and path[-1] == "out_proj" else cfg.d_model
    if dp > 1 and d is not None and shape[d] * dp == full:
        return d
    return None


def fsdp_shard(params, mesh):
    """``params`` (full leaves) with every leaf that `fsdp_dim` splits cut
    to this rank's block, the `dp_index`-th of `dp_size` (a copy, so the
    full tensor can be freed)."""
    dp, i = dp_size(mesh), dp_index(mesh)

    def cut(path, t):
        d = fsdp_dim(path, t.shape, dp)
        if d is None:
            return t
        n = t.shape[d] // dp
        return t.narrow(d, i * n, n).clone()
    return _map_with_path(params, cut)


def fsdp_gather(tree, mesh, cfg):
    """The inverse of `fsdp_shard` on a held tree (params, or anything of
    their structure: gradients, Adam's moments): every shard gathered
    over the data axes in `dp_index` order, on every rank. Collective
    over them."""
    axis, dp = data_axis(mesh), dp_size(mesh)

    def gather(path, t):
        d = fsdp_held_dim(path, t.shape, cfg, dp)
        if d is None:
            return t
        whole = grp.all_gather(t.movedim(d, 0).contiguous(), axis)
        return whole.movedim(0, d).contiguous()
    return _map_with_path(tree, gather)


def fsdp_dims(tree, cfg, dp: int) -> list:
    """`fsdp_held_dim` of every leaf of a held tree, in `pytree.leaves`
    order (None where the leaf is replicated)."""
    def dim(path, t):
        d = fsdp_held_dim(path, t.shape, cfg, dp)
        return -1 if d is None else d
    return [None if d < 0 else d
            for d in pytree.leaves(_map_with_path(tree, dim))]


# ---------------------------------------------------------------------------
# both halves
# ---------------------------------------------------------------------------
def shard(params, mesh, cfg, fsdp: bool = True):
    """This rank's held tree of a full draw: on a ``model`` axis above 1
    its experts (`ep_shard`, the MoE family) or tensor-parallel slices
    (`tp_shard`), then, with ``fsdp``, its FSDP shard of each of those
    (`fsdp_shard`)."""
    if model_size(mesh) > 1:
        params = ep_shard(params, mesh) if cfg.family == "moe" \
            else tp_shard(params, mesh)
    return fsdp_shard(params, mesh) if fsdp else params


def shard_leaf(path, t, mesh, cfg, fsdp: bool = True):
    """`shard` of the one full leaf ``t`` at ``path`` (a key path as the
    tree walks give it): this rank's block of it. A checkpoint's
    ``restore(shard=...)`` cuts each whole leaf so."""
    tree = t
    for k in reversed(path):
        tree = {k: tree}
    tree = shard(tree, mesh, cfg, fsdp)
    for k in path:
        tree = tree[k]
    return tree


def gather(tree, mesh, cfg, fsdp: bool = True):
    """The inverse of `shard` on a held tree (params, gradients, Adam's
    moments): the FSDP shards gathered over the data axes of this rank's
    model coordinate, then the model slices over ``model``, on every
    rank. Collective over both."""
    if fsdp:
        tree = fsdp_gather(tree, mesh, cfg)
    if model_size(mesh) > 1:
        tree = ep_gather(tree, mesh) if cfg.family == "moe" \
            else tp_gather(tree, mesh, cfg)
    return tree


def held_kinds(path, shape, cfg, mesh, fsdp: bool) -> Tuple[str, ...]:
    """The halves of the mesh that cut a held leaf (an entry of `KINDS`):
    ``"model"`` where it is this rank's experts or tensor-parallel slice,
    ``"data"`` where it is an FSDP shard."""
    tp = model_size(mesh)
    out = ()
    if tp > 1 and (_is_expert(path) if cfg.family == "moe"
                   else tp_held_dim(path, shape, cfg, tp) is not None):
        out += ("model",)
    if fsdp and fsdp_held_dim(path, shape, cfg, dp_size(mesh)) is not None:
        out += ("data",)
    return out


def split_kinds(tree, cfg, mesh, fsdp: bool) -> dict:
    """``{kind: tree}`` for each kind of `KINDS` that some leaf of the
    held ``tree`` has: ``tree``'s structure with every other kind's
    leaves set to ``None``."""
    kinds = pytree.leaves(_map_with_path(
        tree, lambda path, t: KINDS.index(held_kinds(path, t.shape, cfg,
                                                     mesh, fsdp))))
    return {kind: _map_with_path(
        tree, lambda path, t, k=kind: t if held_kinds(
            path, t.shape, cfg, mesh, fsdp) == k else None)
        for j, kind in enumerate(KINDS) if j in kinds}


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def cache_specs(cache, cfg, mesh, *, shard_cache_seq: bool = False):
    """The reference's ``cache_specs``: for each leaf of a decode cache
    the tuple of its dimensions' mesh entries (the data axes, ``"model"``
    or None). KV caches: batch over the data axes; kv heads over
    ``model`` when divisible, or, with ``shard_cache_seq``, the sequence
    (flash-decode style); conv states the batch only; SSD states the
    batch and the heads."""
    del cfg                      # the reference's signature; shapes decide
    tp = model_size(mesh)
    dpx = dp_axes(mesh)
    dsz = dp_size(mesh)

    def rule(path, leaf):
        name = "/".join(str(k) for k in path)
        shape = tuple(leaf.shape)
        if name.endswith("length") or len(shape) == 0:
            return ()
        if name in ("k", "v", "xk", "xv") or name.endswith("/k") \
                or name.endswith("/v") or name.endswith("xk") \
                or name.endswith("xv"):
            # (L, B, T, KV, Dh)
            bspec = dpx if _div(shape[1], dsz) else None
            kvspec = "model" if (_div(shape[3], tp) and tp > 1
                                 and not shard_cache_seq) else None
            tspec = "model" if (shard_cache_seq and _div(shape[2], tp)
                                and tp > 1) else None
            return (None, bspec, tspec, kvspec, None)
        if "conv" in name:                        # (L, B, W-1, Cd)
            bspec = dpx if _div(shape[1], dsz) else None
            return (None, bspec, None, None)
        if "ssd" in name:                         # (L, B, H, N, P)
            bspec = dpx if _div(shape[1], dsz) else None
            hspec = "model" if (_div(shape[2], tp) and tp > 1) else None
            return (None, bspec, hspec, None, None)
        bspec = dpx if (len(shape) > 1 and _div(shape[1], dsz)) else None
        return (None, bspec, *(None,) * (len(shape) - 2)) \
            if len(shape) >= 2 else (None,) * len(shape)

    return _map_with_path(cache, rule)


def cache_shard(cache, mesh, cfg, *, shard_cache_seq: bool = False):
    """This rank's block of every leaf of a whole decode cache, as
    `cache_specs` lays it out: the block of `dp_index` where the data
    axes split a dimension, of this rank's ``model`` coordinate where
    ``model`` does (a copy, so the whole cache can be freed)."""
    specs = cache_specs(cache, cfg, mesh, shard_cache_seq=shard_cache_seq)
    dp, i = dp_size(mesh), dp_index(mesh)
    tp = model_size(mesh)
    m = grp.rank(mesh.axis("model")) if tp > 1 else 0

    def cut(path, t):
        spec = specs
        for k in path:
            spec = spec[k]
        if not any(e is not None for e in spec):
            return t
        for d, e in enumerate(spec):
            if e is None:
                continue
            n, j = (tp, m) if e == "model" else (dp, i)
            c = t.shape[d] // n
            t = t.narrow(d, j * c, c)
        return t.clone()
    return _map_with_path(cache, cut)
