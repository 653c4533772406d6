"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions over parameter dicts of tensors, in the reference's
layouts (``wq`` is ``(d, H, Dh)``, ``wo`` is ``(H, Dh, d)``, ``embed.out``
is ``(d, Vp)``), so the JAX package's params cross over unchanged
(``repro_torch.bridge``). The fused loss (``lm_head_loss``) and
``cross_entropy`` are here for training, and so are the gradient release
points of the backward-overlapped sync (``release_scope``,
``grad_release``: an identity ``torch.autograd.Function`` over one
layer's param dict in place of the reference's ``custom_vjp``). The
sharding constraints, which are identities on one device, are left out.

Tensor parallelism (training on a ``model`` axis, ``tp``: that axis, a
`group.Axis`). The reference stores the params Megatron-style and XLA
inserts the collectives; the port's blocks issue them: `copy_to_model`
(identity forward, the backend's all-reduce of the cotangent backward)
where a replicated activation enters a split product, and
`reduce_from_model` (all-reduce forward, identity backward) where the
ranks' partial sums leave it (`split_matmul`). The attention block runs this rank's
heads and the MLP its FFN columns wherever the axis divides their count
(`split`, the reference's divisibility guard); the embedding looks up
this rank's vocab rows and the fused loss runs on this rank's vocab
columns (`lm_head_loss`). Where the query heads split and the kv heads
do not, each rank reads the kv heads of its query heads out of the
replicated ``wk``/``wv`` (`local_heads`), whose gradients the training
step then sums over the axis.

FSDP (training with ``ParallelConfig.shard_params_over_data``). Each
rank holds its shard of every weight that the data axes split
(``parallel/sharding.py``); XLA gathers them for the reference, the
port at its gather points: `gathered` over one layer's params, where
they enter the model (beside each release point), and over the rest of
the tree once a forward (the training step). A `GatherPoint`, installed
by `gather_scope` as a release sink is by `release_scope`, gathers
every shard of the tree in one all-gather over the data axes (one
autograd node, `_Gather`); its backward reduce-scatters their
cotangents in one collective (the gather's transpose), so each rank's
gradient of a shard arrives summed over the data ranks. A weight used
more than once (the hybrid's shared block) is gathered once, and its
gradient reduce-scatters once, summed over its uses.

FSDP with tensor or expert parallelism (both on a ``model`` axis above
1): a held leaf is this rank's model slice cut to its FSDP shard on
another dimension, and the `GatherPoint` gathers over the data ranks of
this rank's model coordinate (``sharding.data_axis``), so the tensor-
parallel operators above (`copy_to_model`, `reduce_from_model`,
`split_matmul`, `vocab_embedding`, the vocab-parallel loss,
`local_heads`) and the MoE dispatch see the model slice whole, as
without FSDP. Every rank issues the two kinds of collective in one
order, on one thread: in the forward, each gather point's all-gather
where the program reaches it and the model-axis all-reduces of the
blocks between them; in the backward (autograd's thread, the same graph
on every rank, so the same order), the model-axis all-reduces of each
block and each gather point's reduce-scatter as autograd releases its
cotangents, the deepest layer's first.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import group as grp
from repro_torch.kernels import ops
# the dense decode's contraction and ring rule are the paged gather path's
from repro_torch.kernels.ref import cache_attention, ring_slot_positions

Params = dict
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, fan_in: Optional[int] = None,
               dtype=torch.float32, device="cpu") -> torch.Tensor:
    """N(0, 1/fan_in), the reference's ``dense_init`` distribution (not its
    numbers: the draws come from ``gen``, on the generator's device).
    With no generator on the ``meta`` device: the leaf's shape and type
    alone (``ModelAPI.init_meta``, the reference's ``jax.eval_shape`` of
    its init)."""
    if gen is None:
        if torch.device(device).type != "meta":
            raise ValueError("dense_init draws from a generator; only a "
                             "meta leaf takes none")
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * fan_in ** -0.5).to(device=device, dtype=dtype)


# ---------------------------------------------------------------------------
# gradient release points
# ---------------------------------------------------------------------------
# A release point is an identity on the forward pass that, on the backward
# pass, hands the cotangent of one layer's parameters to an installed sink
# (repro_torch.comms.communicator._ReleaseSink) the moment autograd
# materializes it, so that layer's sync can start while the layers below
# it are still in their backward. The sink's return value is the
# cotangent that flows on to the parameters. With no sink installed the
# tree is returned untouched (no autograd node at all), so the unhooked
# backward is bit-identical by construction.
_RELEASE_SINK = None


@contextlib.contextmanager
def release_scope(sink):
    """Install ``sink`` as the active gradient-release sink for the block.
    The block must enclose the forward: each release point takes the sink
    that was active when the forward passed it."""
    global _RELEASE_SINK
    prev = _RELEASE_SINK
    _RELEASE_SINK = sink
    try:
        yield sink
    finally:
        _RELEASE_SINK = prev


class _GradRelease(torch.autograd.Function):
    """Identity over a layer's param leaves; its backward hands their
    cotangents, as the layer's tree, to ``sink.release(tag, tree)``."""

    @staticmethod
    def forward(ctx, tag, sink, treedef, *leaves):
        ctx.tag, ctx.sink, ctx.treedef = tag, sink, treedef
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *cts):
        out = ctx.sink.release(ctx.tag, ctx.treedef.unflatten(list(cts)))
        return (None, None, None, *pytree.leaves(out))


def grad_release(tag, tree):
    """Mark ``tree`` (one layer's param dict) as a gradient-release
    boundary tagged ``tag`` (``("layers", i)``: ``tag[0]`` is the
    top-level key the released leaves live under). Identity unless a sink
    is installed via :func:`release_scope`."""
    sink = _RELEASE_SINK
    if sink is None:
        return tree
    leaves, treedef = pytree.flatten(tree)
    return treedef.unflatten(list(
        _GradRelease.apply(tag, sink, treedef, *leaves)))


# ---------------------------------------------------------------------------
# FSDP gather points
# ---------------------------------------------------------------------------
_GATHER_POINT = None
#: the collectives of a gather point (a planted fault swaps one:
#: ``launch.steps.planted_fsdp_fault``)
_FSDP_COLLECTIVES = {"gather": grp.all_gather,
                     "reduce_scatter": grp.reduce_scatter}


@contextlib.contextmanager
def gather_scope(point):
    """Install ``point`` (a `GatherPoint`) for the block, which must
    enclose the forward."""
    global _GATHER_POINT
    prev = _GATHER_POINT
    _GATHER_POINT = point
    try:
        yield point
    finally:
        _GATHER_POINT = prev


def gathered(tree):
    """``tree`` (one layer's params) with every FSDP shard gathered
    whole by the installed `GatherPoint`; ``tree`` itself without one."""
    point = _GATHER_POINT
    return tree if point is None else point(tree)


class GatherPoint:
    """Gathers the shards of a tree over ``axis`` (the data axes'
    `group.Axis`) in one all-gather, and reduce-scatters their
    cotangents in one collective in the backward. ``dims(tree)`` gives
    each leaf's split dimension in `pytree.leaves` order (None where it
    is replicated). Counts its collectives (``gathers``,
    ``reduce_scatters``) and their seconds on this rank (``gather_s``,
    ``reduce_scatter_s``; on the card each between two synchronizations
    of the device, so a collective's wait for the work queued before it
    is not counted in it)."""

    def __init__(self, axis, dims, device="cpu"):
        self.axis, self.dims = axis, dims
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        self.gathers = self.reduce_scatters = 0
        self.gather_s = self.reduce_scatter_s = 0.0

    def __call__(self, tree):
        leaves, treedef = pytree.flatten(tree)
        dims = self.dims(tree)
        idx = [j for j, d in enumerate(dims) if d is not None]
        if not idx:
            return tree
        whole = _Gather.apply(self, tuple(dims[j] for j in idx),
                              *(leaves[j] for j in idx))
        for j, t in zip(idx, whole):
            leaves[j] = t
        return treedef.unflatten(leaves)

    def _clock(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def gather(self, shards, dims):
        """The whole leaves of ``shards``, each split along its entry of
        ``dims``, block i from data index i (one dtype: the params')."""
        t0 = self._clock()
        n = self.axis.size
        flat = torch.cat([t.movedim(d, 0).reshape(-1)
                          for t, d in zip(shards, dims)])
        rows = _FSDP_COLLECTIVES["gather"](flat, self.axis).view(n, -1)
        out, off = [], 0
        for t, d in zip(shards, dims):
            moved = t.movedim(d, 0).shape
            part = rows[:, off:off + t.numel()].reshape(
                (n * moved[0],) + tuple(moved[1:]))
            out.append(part.movedim(0, d).contiguous())
            off += t.numel()
        self.gathers += 1
        self.gather_s += self._clock() - t0
        return out

    def reduce_scatter(self, cts, dims):
        """This rank's shards of the cotangents ``cts`` of whole leaves,
        each summed over the data ranks."""
        t0 = self._clock()
        n = self.axis.size
        flat = torch.cat([ct.movedim(d, 0).reshape(n, -1)
                          for ct, d in zip(cts, dims)], dim=1)
        mine = _FSDP_COLLECTIVES["reduce_scatter"](flat.reshape(-1),
                                                   self.axis)
        out, off = [], 0
        for ct, d in zip(cts, dims):
            moved = ct.movedim(d, 0).shape
            size = ct.numel() // n
            part = mine[off:off + size].reshape(
                (moved[0] // n,) + tuple(moved[1:]))
            out.append(part.movedim(0, d).contiguous())
            off += size
        self.reduce_scatters += 1
        self.reduce_scatter_s += self._clock() - t0
        return out


class _Gather(torch.autograd.Function):
    """`GatherPoint.gather` forward, `GatherPoint.reduce_scatter` of the
    cotangents backward (on autograd's thread, in the same order on
    every rank: the graphs are alike)."""

    @staticmethod
    def forward(ctx, point, dims, *shards):
        ctx.point, ctx.dims = point, dims
        return tuple(point.gather(shards, dims))

    @staticmethod
    def backward(ctx, *cts):
        return (None, None, *ctx.point.reduce_scatter(cts, ctx.dims))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
def _psum(ct, axis):
    return grp.psum(ct.contiguous(), axis)


#: the backward of `copy_to_model` (a planted fault swaps it:
#: ``launch.steps.planted_tp_fault``)
_COPY_BACKWARD = {"fn": _psum}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the all-reduce of the cotangent over ``axis``
    backward (Megatron's ``f``)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _COPY_BACKWARD["fn"](ct, ctx.axis), None


class _ReduceFromModel(torch.autograd.Function):
    """The all-reduce over ``axis`` forward; identity backward
    (Megatron's ``g``)."""

    @staticmethod
    def forward(ctx, x, axis):
        return grp.psum(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def copy_to_model(x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` (the same on every rank of ``axis``) entering a computation
    split over the axis: each rank's cotangent holds only its part."""
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum over ``axis`` of the ranks' partial ``x``."""
    return _ReduceFromModel.apply(x, axis)


def split_matmul(eq: str, a: torch.Tensor, w: torch.Tensor, compute_dtype,
                 tp=None, *, reduce: bool = False) -> torch.Tensor:
    """``einsum(eq, a, w)`` in the compute dtype. Over ``tp`` (``w`` this
    rank's slice) the compute-dtype operands multiply and accumulate in
    fp32, as the tensor cores do, and the product is rounded once, where
    the unsplit product is: a column-parallel product (``a`` the same on
    every rank) takes ``a`` through its own `copy_to_model`, so the
    ranks' fp32 partial input gradients are summed before they are
    rounded, each product's apart, as autograd rounds each unsplit
    product's input gradient before it adds them; a row-parallel one
    (``reduce=True``, ``a`` this rank's split activation) is rounded
    after `reduce_from_model` sums the ranks' fp32 partials. So the
    split changes the order of fp32 sums, not where bf16 rounds (two
    bf16 partials summed would round twice)."""
    cd = compute_dtype
    if tp is None:
        return torch.einsum(eq, a.to(cd), w.to(cd))
    a = a.to(cd).float()
    if not reduce:
        a = copy_to_model(a, tp)
    out = torch.einsum(eq, a, w.to(cd).float())
    if reduce:
        out = reduce_from_model(out, tp)
    return out.to(cd)


def split(tp, n: int):
    """``tp`` where ``n`` (heads, FFN columns, vocab rows) divides over
    the axis, else None: the leaves stay whole on every rank and the
    computation runs whole, with no collective."""
    return tp if tp is not None and n % tp.size == 0 else None


def _kv_index(cfg: ModelConfig, hl: int, m: int):
    """The kv heads that query heads ``[m*hl, (m+1)*hl)`` read, as a
    slice where they form a group layout of their own, else one kv head
    per query head."""
    g = cfg.num_heads // cfg.num_kv_heads
    idx = [(m * hl + j) // g for j in range(hl)]
    uniq = sorted(set(idx))
    per = hl // len(uniq)
    if hl % len(uniq) == 0 and idx == [uniq[j // per] for j in range(hl)]:
        return slice(uniq[0], uniq[-1] + 1)
    return idx


def local_heads(p: Params, cfg: ModelConfig, tp) -> Params:
    """The attention leaves this rank computes with over ``tp`` (the
    heads split by `split`): its slices as held, and, where the kv heads
    stay whole (``num_kv_heads`` not divisible), the kv heads its query
    heads read."""
    if cfg.num_kv_heads % tp.size == 0:
        return p
    idx = _kv_index(cfg, p["wq"].shape[1], grp.rank(tp))
    out = dict(p)
    for n, dim in (("wk", 1), ("wv", 1), ("bk", 0), ("bv", 0)):
        if n in p:
            out[n] = p[n][(slice(None),) * dim + (idx,)]
    return out


def vocab_embedding(tokens: torch.Tensor, tok: torch.Tensor, tp=None):
    """``F.embedding(tokens, tok)``, or, over ``tp``, with ``tok`` this
    rank's rows of the vocab: ids outside them look up zeros, and the
    ranks' lookups are summed (one rank holds each id)."""
    if tp is None:
        return F.embedding(tokens, tok)
    lo = grp.rank(tp) * tok.shape[0]
    own = (tokens >= lo) & (tokens < lo + tok.shape[0])
    e = F.embedding(torch.where(own, tokens - lo, 0), tok)
    return reduce_from_model(torch.where(own[..., None], e, 0), tp)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (full or partial — GLM-family "2d"/half rotary)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, rotary_pct: float, theta: float,
                     device="cpu"):
    rot_dim = int(head_dim * rotary_pct)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / (theta ** (exps / rot_dim))
    return inv, rot_dim


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               rotary_pct: float = 1.0, theta: float = 10000.0):
    """x: (B, S, H, D); positions: (S,) or (B, S). Rotates interleaved
    pairs (x[..., 0::2], x[..., 1::2]) of the first ``rot_dim`` dims."""
    D = x.shape[-1]
    inv, rot_dim = rope_frequencies(D, rotary_pct, theta, x.device)
    if rot_dim == 0:
        return x
    pos = positions.float()
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * inv[None, None, :]          # (B, S, rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot_dim].float()
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    rot = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([rot.to(x.dtype), x[..., rot_dim:]], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------
def attention_params(gen, cfg: ModelConfig, dtype=torch.float32,
                     device="cpu") -> Params:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(gen, (d, H, Dh), d, **kw),
        "wk": dense_init(gen, (d, KV, Dh), d, **kw),
        "wv": dense_init(gen, (d, KV, Dh), d, **kw),
        "wo": dense_init(gen, (H, Dh, d), H * Dh, **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), **kw)
        p["bk"] = torch.zeros((KV, Dh), **kw)
        p["bv"] = torch.zeros((KV, Dh), **kw)
    return p


def attention_block(
    x: torch.Tensor,              # (B, S, d)
    p: Params,
    cfg: ModelConfig,
    positions: torch.Tensor,      # (S,) or (B, S) absolute positions of x
    *,
    causal: bool = True,
    window: int = 0,
    kv_cache=None,                # optional decode cache, dense or paged
    return_kv: bool = False,      # prefill: return this block's k/v for caching
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
    tp=None,                      # training: the tensor-parallel axis
):
    """Returns (out, new_kv) — new_kv is None unless kv_cache/return_kv given.

    With ``tp`` (training) and heads that split over it, ``p`` holds
    this rank's heads (`local_heads`); the q, k and v products are
    column-parallel and the output projection row-parallel
    (`split_matmul`).

    Decode (``kv_cache`` given, one new token) takes one of two forms:

      * dense, ``{k, v, length}``: ``(B, T, KV, Dh)`` views and
        ``length`` as a scalar, as the reference does, or as a ``(B,)``
        tensor: each row then writes its own ring slot ``length[b] % T``
        and sees its own valid slots (``cache_attention``);
      * paged, ``{k_pool, v_pool, block_tables, length}``: one layer's
        ``(NB, bs, KV, Dh)`` pools, the ``(B, nb)`` block tables and
        ``(B,)`` lengths. Row b's token goes to ring slot
        ``s = length[b] % (nb * bs)``, i.e. ``pool[tables[b, s // bs],
        s % bs]``, and ``ops.paged_attention`` (impl ``attn_impl``) then
        reads the pools through the tables, the token included.

    Either way the token's k/v are written into the cache's tensors IN
    PLACE; the returned dict holds those same tensors and ``length + 1``.

    Decode on a ``model`` axis (``tp``; the reference's decode step over
    ``cache_specs``' layout): a dense cache split by kv heads holds this
    rank's heads (``p`` its slices); a replicated one under split query
    heads (the mixed layout) is written and read at the kv heads its
    query heads read; a cache with ``"seq_axis"`` holds this rank's
    slots of every head (`_seq_split_decode`).
    """
    cd = compute_dtype
    tp = split(tp, cfg.num_heads)
    seq = kv_cache.get("seq_axis") if kv_cache is not None else None
    if seq is not None:
        return _seq_split_decode(x, p, cfg, positions, kv_cache, window, cd,
                                 tp)
    if tp is not None:
        p = local_heads(p, cfg, tp)
    q, k, v = _qkv(x.to(cd), p, cfg, positions, cd, tp, tp)

    new_kv = None
    if kv_cache is not None and x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
    if kv_cache is not None and "block_tables" in kv_cache:
        new_kv = write_paged_token(kv_cache, k[:, 0], v[:, 0])
        out = ops.paged_attention(
            q, new_kv["k_pool"], new_kv["v_pool"], new_kv["block_tables"],
            new_kv["length"], window=window, impl=attn_impl)
    elif kv_cache is not None:
        # decode: insert this step's k/v at slot `length % T` (ring-buffer when
        # T < full context, i.e. sliding-window serving)
        ck, cv = kv_cache["k"], kv_cache["v"]
        B, T = ck.shape[0], ck.shape[1]
        length = torch.as_tensor(kv_cache["length"], device=ck.device)
        # a (B,) index: a 0-d one would be read back to the host (and a
        # meta tensor has no value)
        slot = torch.broadcast_to(length % T, (B,))
        rows = torch.arange(B, device=ck.device)
        ck_r, cv_r = ck, cv
        if ck.shape[2] == k.shape[2]:       # the whole cache or its block
            ck[rows, slot] = k[:, 0].to(ck.dtype)
            cv[rows, slot] = v[:, 0].to(cv.dtype)
        else:
            # a replicated cache under split query heads (the mixed
            # layout): this rank writes and reads the kv heads its query
            # heads read (`local_heads`)
            kvi = _kv_index(cfg, q.shape[2], grp.rank(tp))
            heads = torch.arange(ck.shape[2], device=ck.device)[kvi]
            ck[rows[:, None], slot[:, None], heads] = k[:, 0].to(ck.dtype)
            cv[rows[:, None], slot[:, None], heads] = v[:, 0].to(cv.dtype)
            ck_r, cv_r = ck[:, :, kvi], cv[:, :, kvi]
        new_len = length + 1
        new_kv = {"k": ck, "v": cv, "length": new_len}
        slot_pos = ring_slot_positions(new_len, T)
        out = cache_attention(q, ck_r, cv_r, positions, slot_pos,
                              window=window)
    else:
        out = ops.attention(q, k, v, causal=causal, window=window,
                            impl=attn_impl)
        if return_kv:
            new_kv = {"k": k, "v": v}
    out = split_matmul("bshk,hkd->bsd", out, p["wo"], cd, tp, reduce=True)
    return out.to(x.dtype), new_kv


def _qkv(xc, p, cfg, positions, cd, tp, tp_kv):
    """The block's query, key and value products (the queries over
    ``tp`` column-parallel, the keys and values over ``tp_kv``), biases
    and rotary embeddings."""
    q = split_matmul("bsd,dhk->bshk", xc, p["wq"], cd, tp)
    k = split_matmul("bsd,dhk->bshk", xc, p["wk"], cd, tp_kv)
    v = split_matmul("bsd,dhk->bshk", xc, p["wv"], cd, tp_kv)
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if not cfg.learned_pos and cfg.num_heads:
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
    return q, k, v


def heads_whole(t: torch.Tensor, axis) -> torch.Tensor:
    """(B, S, h, D) blocks of heads split over ``axis`` -> (B, S, H, D),
    in axis order."""
    return grp.all_gather(t.movedim(2, 0).contiguous(), axis).movedim(0, 2)


def take_heads(p: Params, cfg: ModelConfig, axis) -> Params:
    """Whole attention leaves cut to this rank's heads over ``axis`` (its
    block of the query and of the kv heads; both must divide): the
    tensor-parallel slices of ``sharding.tp_shard``, for a block whose
    params are whole on every rank (the MoE family's decode over a cache
    split by kv heads)."""
    m, n = grp.rank(axis), axis.size
    out = dict(p)
    for name, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("bq", 0),
                      ("bk", 0), ("bv", 0), ("wo", 0)):
        if name in p:
            c = p[name].shape[dim] // n
            out[name] = p[name].narrow(dim, m * c, c)
    return out


def seq_split_attention(q, k, v, valid, axis, cache_rounding=True):
    """Attention of ``q`` (B, S, H, Dh), every head, over keys split along
    their positions over ``axis`` (flash-decode style): this rank holds
    ``k``/``v`` (B, Tl, KV, Dh) and ``valid`` (B or 1, Tl), whether each
    of its slots is seen. Each rank's partial softmax is combined over
    the axis (the row max, the sum of exponentials and the weighted
    values; fp32), as ``cache_attention`` scales and rounds (the scaled
    query and the probabilities in the cache's dtype), or, without
    ``cache_rounding``, as ``ref.attention`` does (fp32 throughout). A
    row that sees no key on any rank is not taken."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    g = H // KV
    qr = (q.float() * (Dh ** -0.5)) if not cache_rounding \
        else q * (Dh ** -0.5)
    qr = qr.reshape(B, S, KV, g, Dh)
    if cache_rounding:
        qr = qr.to(k.dtype)
    s = torch.einsum("bskgd,btkd->bkgst", qr.float(), k.float())
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.full((), NEG_INF, device=s.device))
    m = grp.pmax(s.amax(-1, keepdim=True), axis)
    e = torch.exp(s - m)
    den = grp.psum(e.sum(-1), axis)                      # (B, KV, g, S)
    if cache_rounding:
        e = e.to(v.dtype)
    num = grp.psum(torch.einsum("bkgst,btkd->bskgd", e.float(), v.float()),
                   axis)
    out = num / den.permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, Dh).to(q.dtype)


def _seq_split_decode(x, p, cfg, positions, kv_cache, window, cd, tp):
    """One decode step over a dense cache whose slots are split over the
    axis ``kv_cache["seq_axis"]`` (``cache_specs(shard_cache_seq=True)``):
    every head's query, key and value (gathered over ``tp`` where the
    params split them), the token written by the rank that holds its
    slot, `seq_split_attention`, and this rank's heads of the result
    through the row-parallel output projection."""
    seq = kv_cache["seq_axis"]
    tp_kv = tp if tp is not None and cfg.num_kv_heads % tp.size == 0 \
        else None
    q, k, v = _qkv(x.to(cd), p, cfg, positions, cd, tp, tp_kv)
    if tp is not None:
        q = heads_whole(q, tp)
    if tp_kv is not None:
        k, v = heads_whole(k, tp_kv), heads_whole(v, tp_kv)
    ck, cv = kv_cache["k"], kv_cache["v"]
    B, Tl = ck.shape[0], ck.shape[1]
    T, m = Tl * seq.size, grp.rank(seq)
    length = torch.as_tensor(kv_cache["length"], device=ck.device)
    slot = length % T
    own = (slot // Tl == m)[..., None, None]
    rows = torch.arange(B, device=ck.device)
    local = torch.broadcast_to(slot % Tl, (B,))
    ck[rows, local] = torch.where(own, k[:, 0].to(ck.dtype), ck[rows, local])
    cv[rows, local] = torch.where(own, v[:, 0].to(cv.dtype), cv[rows, local])
    new_len = length + 1
    slot_pos = ring_slot_positions(new_len, T)[..., m * Tl:(m + 1) * Tl]
    q_last = positions[..., 0]
    valid = (slot_pos >= 0) & (slot_pos <= q_last[..., None])
    if window > 0:
        valid &= slot_pos > q_last[..., None] - window
    if valid.dim() == 1:
        valid = valid[None]
    out = seq_split_attention(q, ck, cv, valid, seq)
    if tp is not None:
        hl = p["wo"].shape[0]
        out = out[:, :, grp.rank(tp) * hl:(grp.rank(tp) + 1) * hl]
    out = split_matmul("bshk,hkd->bsd", out, p["wo"], cd, tp, reduce=True)
    return out.to(x.dtype), {"k": ck, "v": cv, "length": new_len,
                             "seq_axis": seq}


def write_paged_token(kv_cache, k, v):
    """Write each row's token k/v ``(B, KV, Dh)`` IN PLACE into its ring
    slot ``length % (nb * bs)`` of the paged cache; returns the cache with
    ``length + 1``. Rows of inactive slots point at the null block, so
    their writes land there."""
    kp, vp, bt = kv_cache["k_pool"], kv_cache["v_pool"], kv_cache["block_tables"]
    bs = kp.shape[1]
    length = torch.as_tensor(kv_cache["length"], device=kp.device)
    s = length % (bt.shape[1] * bs)
    blk = bt[torch.arange(bt.shape[0], device=bt.device), s // bs]
    kp[blk, s % bs] = k.to(kp.dtype)
    vp[blk, s % bs] = v.to(vp.dtype)
    return {"k_pool": kp, "v_pool": vp, "block_tables": bt,
            "length": length + 1}


def decode_kv(cache, i: int, length, seq_axis=None):
    """Layer ``i``'s decode cache, dense or paged, from a family cache
    whose KV leaves are stacked on a leading layer axis (``k``/``v`` or
    ``k_pool``/``v_pool``; the block tables are shared by the layers).
    ``seq_axis``: the axis a dense cache's slots are split over."""
    if "block_tables" in cache:
        return {"k_pool": cache["k_pool"][i], "v_pool": cache["v_pool"][i],
                "block_tables": cache["block_tables"], "length": length}
    kv = {"k": cache["k"][i], "v": cache["v"][i], "length": length}
    if seq_axis is not None:
        kv["seq_axis"] = seq_axis
    return kv


def kv_leaves(cache):
    """The KV entries of a decode cache (written in place by the step)."""
    return {n: cache[n] for n in ("k", "v", "k_pool", "v_pool",
                                  "block_tables") if n in cache}


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
def mlp_params(gen, d: int, ff: int, gated: bool = True,
               dtype=torch.float32, device="cpu") -> Params:
    kw = dict(dtype=dtype, device=device)
    p = {"w_up": dense_init(gen, (d, ff), d, **kw),
         "w_down": dense_init(gen, (ff, d), ff, **kw)}
    if gated:
        p["w_gate"] = dense_init(gen, (d, ff), d, **kw)
    return p


def mlp_block(x: torch.Tensor, p: Params, *, gated: bool = True,
              compute_dtype=torch.bfloat16, tp=None) -> torch.Tensor:
    """``tp``: the axis ``p``'s FFN columns are split over (the caller's
    `split`), or None."""
    cd = compute_dtype
    xc = x.to(cd)
    up = split_matmul("bsd,df->bsf", xc, p["w_up"], cd, tp)
    if gated:
        gate = split_matmul("bsd,df->bsf", xc, p["w_gate"], cd, tp)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    out = split_matmul("bsf,fd->bsd", h, p["w_down"], cd, tp, reduce=True)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def pad_vocab(v: int, mult: int = 256) -> int:
    """Megatron-style vocab padding (the reference's layout of ``embed``)."""
    return ((v + mult - 1) // mult) * mult


def embed_params(gen, cfg: ModelConfig, dtype=torch.float32,
                 device="cpu") -> Params:
    vp = pad_vocab(cfg.vocab_size)
    kw = dict(dtype=dtype, device=device)
    p = {
        "tok": dense_init(gen, (vp, cfg.d_model), cfg.d_model, **kw),
        "out": dense_init(gen, (cfg.d_model, vp), cfg.d_model, **kw),
        "final_norm": torch.ones((cfg.d_model,), **kw),
    }
    if cfg.learned_pos:
        # the enc-dec decoder's learned positions (whisper)
        p["pos"] = dense_init(gen, (cfg.max_positions, cfg.d_model),
                              cfg.d_model, **kw)
    return p


def unembed(x: torch.Tensor, p: Params, cfg: ModelConfig,
            compute_dtype=torch.bfloat16, tp=None,
            gather: bool = True) -> torch.Tensor:
    """Final norm and logits, padded vocab columns at -1e30. Over ``tp``
    (``p["out"]`` this rank's vocab columns, where the axis divides the
    padded vocab) each rank computes its columns; ``gather`` puts them
    together over the axis (the argmax of a decode step reads them all),
    else this rank's block is returned."""
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    tp = split(tp, pad_vocab(cfg.vocab_size))
    logits = torch.einsum("bsd,dv->bsv", x.to(compute_dtype),
                          p["out"].to(compute_dtype))
    lo = 0
    if tp is not None and gather:
        logits = grp.all_gather(logits.movedim(-1, 0).contiguous(),
                                tp).movedim(0, -1)
    elif tp is not None:
        lo = grp.rank(tp) * logits.shape[-1]
    # mask padded vocab columns so softmax/argmax never pick them
    V = cfg.vocab_size - lo
    if logits.shape[-1] > V:
        logits[..., max(V, 0):] = NEG_INF
    return logits


def _chunk_nll(x, labels, w, V: int, compute_dtype, tp=None, lo: int = 0):
    """(sum of the masked NLL, count of counted labels) of one chunk of
    rows: its logits exist only inside this call. Over ``tp``, ``w`` is
    this rank's vocab columns ``[lo, lo + w.shape[1])``: the row max,
    the sum of exps and the picked logit are reduced over the axis."""
    logits = split_matmul("bsd,dv->bsv", x, w, compute_dtype, tp)
    if lo + logits.shape[-1] > V:       # padded columns, by global index
        col = lo + torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < V, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    if tp is not None:
        m = grp.pmax(m, tp)
    sumexp = torch.sum(torch.exp(lf - m), dim=-1)
    if tp is not None:
        sumexp = reduce_from_model(sumexp, tp)
    lse = torch.log(sumexp) + m[..., 0]
    mask = (labels >= 0) & (labels < V)
    own = mask & (labels >= lo) & (labels < lo + lf.shape[-1])
    picked = torch.gather(lf, -1,
                          torch.where(own, labels - lo, 0).long()[..., None])
    if tp is not None:
        picked = reduce_from_model(torch.where(own[..., None], picked, 0.0),
                                   tp)
    maskf = mask.float()
    return torch.sum((lse - picked[..., 0]) * maskf), torch.sum(maskf)


class _RecomputedChunkNLL(torch.autograd.Function):
    """`_chunk_nll` that keeps only its inputs and computes the chunk
    again in the backward (what ``torch.utils.checkpoint`` does, whose
    first call imports the compiler stack: seconds in every new
    process; this imports nothing). The recompute issues the chunk's reductions over ``tp``
    again, in the same order on every rank."""

    @staticmethod
    def forward(ctx, x, w, labels, V, compute_dtype, tp, lo):
        ctx.save_for_backward(x, w, labels)
        ctx.args = (V, compute_dtype, tp, lo)
        nll, cnt = _chunk_nll(x, labels, w, V, compute_dtype, tp, lo)
        ctx.mark_non_differentiable(cnt)
        return nll, cnt

    @staticmethod
    def backward(ctx, ct, _):
        x, w, labels = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xr, wr = (t.detach().requires_grad_(n) for t, n in zip((x, w),
                                                                    need))
            nll, _ = _chunk_nll(xr, labels, wr, *ctx.args)
            # ``nll * ct``, not ``grad_outputs=ct`` (the same bits: its
            # backward starts from 1 * ct), whose shape check imports
            # sympy on first use
            got = iter(torch.autograd.grad(
                nll * ct, [t for t, n in zip((xr, wr), need) if n]))
        return (*(next(got) if n else None for n in need),
                None, None, None, None, None)


def lm_head_loss(hidden: torch.Tensor, p: Params, labels: torch.Tensor,
                 cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                 chunk: int = 512, tp=None) -> torch.Tensor:
    """Fused final-norm + unembed + CE, chunked over the sequence with
    recomputation (`_RecomputedChunkNLL` per chunk, as the reference's
    ``jax.checkpoint``): the (tokens x vocab) logits exist
    at most ``chunk`` rows at a time, in the forward and the backward.
    Padded vocab columns are -1e30; labels outside [0, V) count as no
    token. Over ``tp``, ``p["out"]`` holds this rank's vocab columns
    (vocab-parallel): each chunk's logits are a column-parallel product
    (`split_matmul`) and the chunk reduces over the axis, in its
    recompute too (the same collectives in the same order on every
    rank)."""
    x = rms_norm(hidden, p["final_norm"], cfg.norm_eps)
    tp = split(tp, pad_vocab(cfg.vocab_size))
    B, S, d = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = p["out"].to(compute_dtype)
    lo = 0 if tp is None else grp.rank(tp) * w.shape[1]
    nlls, cnts = [], []
    for i in range(0, S + pad, c):
        nll, cnt = _RecomputedChunkNLL.apply(
            x[:, i:i + c], w, labels[:, i:i + c], cfg.vocab_size,
            compute_dtype, tp, lo)
        nlls.append(nll)
        cnts.append(cnt)
    return torch.stack(nlls).sum() / torch.clamp(torch.stack(cnts).sum(),
                                                 min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1) -> torch.Tensor:
    """Mean token NLL; positions with label==ignore (or outside [0, V))
    are masked out."""
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    V = logits.shape[-1]
    mask = (labels != ignore) & (labels >= 0) & (labels < V)
    picked = torch.gather(lf, -1,
                          torch.where(mask, labels, 0).long()[..., None])
    maskf = mask.float()
    nll = lse - picked[..., 0]
    return torch.sum(nll * maskf) / torch.clamp(torch.sum(maskf), min=1.0)
