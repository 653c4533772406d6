"""Mixture-of-Experts block with capacity-bounded top-k routing (port of
``repro/models/moe.py``).

Routing uses sort-based dispatch (a stable argsort by expert id and
capacity clipping) and a grouped expert einsum, as the reference does;
the combine gathers each token's k slot outputs and sums them in a
fixed order where the reference scatter-adds the slots into the
tokens, and the dispatch's gradient sums a token's slots the same way
(`_Dispatch`): on the card the scatter-adds' atomics would change the
bits from call to call. Two execution paths share the routing:

* ``ep_axis=None`` — every expert in this process.
* ``ep_axis="model"`` — expert parallelism over the ``model`` axis of a
  `group.RankMesh`: this rank holds the experts
  ``[m * E/tp, (m+1) * E/tp)`` of its axis coordinate ``m``, routes its
  own tokens (so the capacity C is this rank's, as in the reference),
  and the ``(E, C, d)`` dispatch buffer is exchanged with an all-to-all
  to ``(E/tp, tp*C, d)`` (tokens to their experts) and back after the
  expert FFN (`_exchange`). The all-to-all is the backend's (``"xla"``)
  or one of the survey's algorithms (``algorithms.get("all_to_all",
  name)``); a `Communicator` resolves the name per message size.

The reference takes the exchange's gradient from JAX's transposes; here
each direction is a `torch.autograd.Function` whose backward is the
other direction's exchange of the cotangent (an all-to-all permutes
values, so its transpose is its inverse). `gather_seq` and `pmean` are
the two other collectives of the expert-parallel layer
(``models/moe_model.py``), with the backwards JAX gives
``all_gather(tiled=True)`` (the cotangent summed over the axis, this
rank's chunk kept) and ``pmean`` (the cotangent's mean over the axis).

Tokens are routed in groups: by default the whole call is one group
(``T = B * S`` tokens compete for ``C = max(1, int(T * k *
capacity_factor) // E)`` slots per expert, the reference's batched
capacity); with ``per_row=True`` each batch row is its own group with
its own capacity, which is the reference serving engine's vmap of
batch-1 decodes written out. The router's top-k is per token either way.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import algorithms as alg
from repro_torch.core.collectives import group as grp
from repro_torch.models import layers as L


def moe_params(gen, cfg: ModelConfig, dtype=torch.float32, device="cpu"):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": L.dense_init(gen, (d, E), d, **kw),
        "w_gate": L.dense_init(gen, (E, d, ff), d, **kw),
        "w_up": L.dense_init(gen, (E, d, ff), d, **kw),
        "w_down": L.dense_init(gen, (E, ff, d), ff, **kw),
    }
    if cfg.dense_residual:
        p["dense"] = L.mlp_params(gen, d, cfg.dense_d_ff, gated=True, **kw)
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a group of ``tokens`` tokens."""
    return max(1, int(tokens * cfg.experts_per_token * cfg.capacity_factor)
               // cfg.num_experts)


def _route(x2d: torch.Tensor, router_w: torch.Tensor, k: int):
    """x2d: (T, d) -> gates (T, k) fp32, experts (T, k), aux losses."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # aux: load-balance (Switch) + router z-loss
    T, E = probs.shape
    me = probs.mean(dim=0)                                   # (E,)
    onehot = torch.zeros((T, E), dtype=torch.float32, device=x2d.device)
    onehot.scatter_add_(1, experts, torch.ones_like(gates))
    ce = onehot.mean(dim=0) / k
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return gates, experts, {"lb_loss": lb_loss, "z_loss": z_loss}


def _dispatch_indices(experts: torch.Tensor, gates: torch.Tensor, E: int,
                      C: int):
    """Sort-based capacity dispatch, per group.

    experts/gates: (G, Tg, k). Returns, each (G, E*C):
      gather_idx  token index (within the group) feeding each expert slot
                  (Tg = padding row),
      slot_gate   combine weight per slot,
      slot_token  destination token per slot (Tg = dropped); the same
                  indices as ``gather_idx``, as in the reference;
    and (G, Tg*k), token-major:
      slot_of     the slot of each (token, choice) (E*C = dropped), the
                  inverse map the combine and the dispatch's gradient
                  gather through.
    """
    G, Tg, k = experts.shape
    flat_e = experts.reshape(G, Tg * k)
    flat_g = gates.reshape(G, Tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)       # group by expert
    sorted_e = torch.gather(flat_e, 1, order)
    sorted_g = torch.gather(flat_g, 1, order)
    sorted_tok = order // k
    # rank within the expert group
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(Tg * k, device=experts.device) - first
    slot = torch.where(rank < C, sorted_e * C + rank,
                       torch.full_like(rank, E * C))         # E*C = trash slot
    gather_idx = torch.full((G, E * C + 1), Tg, dtype=torch.long,
                            device=experts.device)
    gather_idx.scatter_(1, slot, sorted_tok)
    slot_gate = torch.zeros((G, E * C + 1), dtype=torch.float32,
                            device=experts.device)
    slot_gate.scatter_(1, slot, sorted_g.float())
    gather_idx = gather_idx[:, :E * C]
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    return gather_idx, slot_gate[:, :E * C], gather_idx, slot_of


class _Dispatch(torch.autograd.Function):
    """``xpad[gather_idx]`` per group: (G, Tg+1, d) -> (G, E*C, d), each
    expert slot's token row. Autograd's backward of a gather adds a
    token's k slots with atomics on the card, in an order that changes
    from call to call; this one gathers each token's slots through
    ``slot_of`` and sums them in a fixed order: the same bits every
    call."""

    @staticmethod
    def forward(ctx, xpad, gather_idx, slot_of, k):
        ctx.save_for_backward(slot_of)
        ctx.k = k
        d = xpad.shape[-1]
        return torch.gather(xpad, 1, gather_idx[..., None].expand(-1, -1, d))

    @staticmethod
    def backward(ctx, ddisp):
        (slot_of,) = ctx.saved_tensors
        dx = _sum_slots(ddisp, slot_of, ctx.k)
        return torch.cat([dx, dx.new_zeros((dx.shape[0], 1, dx.shape[2]))],
                         dim=1), None, None, None


def _pick(slots: torch.Tensor, slot_of: torch.Tensor) -> torch.Tensor:
    """(G, E*C, d) slot rows -> (G, Tg*k, d), the row of each (token,
    choice); a zero row where capacity dropped it."""
    G, _, d = slots.shape
    pad = torch.cat([slots, slots.new_zeros((G, 1, d))], dim=1)
    return torch.gather(pad, 1, slot_of[..., None].expand(-1, -1, d))


def _sum_slots(slots: torch.Tensor, slot_of: torch.Tensor,
               k: int) -> torch.Tensor:
    """Each token's sum of its k slot rows, in a fixed order: (G, E*C, d)
    -> (G, Tg, d)."""
    G, _, d = slots.shape
    return _pick(slots, slot_of).reshape(G, -1, k, d).sum(dim=2)


def _expert_ffn(xg, wg, wu, wd, compute_dtype):
    """xg: (E, C, d); expert weights (E, d, ff) / (E, ff, d). Casts every
    expert's weights to the compute dtype on each call, as the reference
    does."""
    cd = compute_dtype
    gate = torch.einsum("ecd,edf->ecf", xg.to(cd), wg.to(cd))
    up = torch.einsum("ecd,edf->ecf", xg.to(cd), wu.to(cd))
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, wd.to(cd))


# ---------------------------------------------------------------------------
# the expert-parallel collectives, with their gradients
# ---------------------------------------------------------------------------
def _a2a(rows: torch.Tensor, axis, tp: int, algorithm: str) -> torch.Tensor:
    """(tp, m) rows: row j to peer j, received rows in peer order."""
    return alg.get("all_to_all", algorithm)(rows, axis, tp)


def _exchange_fwd(buf, axis, tp, algorithm):
    """(E, C, d) -> (E/tp, tp*C, d): row j of the received rows is peer
    j's chunk for my experts."""
    E, C, d = buf.shape
    el = E // tp
    out = _a2a(buf.reshape(tp, el * C * d), axis, tp, algorithm)
    return out.reshape(tp, el, C, d).transpose(0, 1).reshape(el, tp * C, d)


def _exchange_rev(buf, axis, tp, algorithm):
    """(E/tp, tp*C, d) -> (E, C, d): each peer's slots back home."""
    el, tpC, d = buf.shape
    C = tpC // tp
    chunks = buf.reshape(el, tp, C, d).transpose(0, 1)
    out = _a2a(chunks.reshape(tp, el * C * d), axis, tp, algorithm)
    return out.reshape(tp * el, C, d)


_DIRECTIONS = {"fwd": (_exchange_fwd, _exchange_rev),
               "rev": (_exchange_rev, _exchange_fwd)}


class _Exchange(torch.autograd.Function):
    """One direction of the dispatch exchange; its backward runs the
    other direction on the cotangent, with the same algorithm."""

    @staticmethod
    def forward(ctx, buf, axis, tp, algorithm, direction):
        ctx.args = (axis, tp, algorithm, direction)
        return _DIRECTIONS[direction][0](buf.contiguous(), axis, tp,
                                         algorithm)

    @staticmethod
    def backward(ctx, ct):
        axis, tp, algorithm, direction = ctx.args
        back = _DIRECTIONS[direction][1]
        return back(ct.contiguous(), axis, tp, algorithm), None, None, \
            None, None


def _exchange(buf, axis, tp: int, direction: str, algorithm="xla"):
    """All-to-all on the dispatch buffer over ``axis`` (a `group.Axis`),
    with the survey's algorithm choice. ``algorithm`` is a name or a
    `Communicator`, which resolves the name per (message bytes,
    fan-out) — the tuned MoE dispatch path.

    fwd: (E, C, d) -> (E/tp, tp*C, d)   (tokens to their experts)
    rev: (E/tp, tp*C, d) -> (E, C, d)   (expert outputs back home)
    """
    if not isinstance(algorithm, str):       # a Communicator
        algorithm = algorithm.a2a_algorithm_for(
            buf.numel() * buf.element_size(), axis.name, tp)
    return _Exchange.apply(buf, axis, tp, algorithm, direction)


class _GatherSeq(torch.autograd.Function):
    """``all_gather(x, axis, axis=1, tiled=True)`` over ``axis``; the
    backward sums the cotangent over the axis (the backend's all-reduce)
    and keeps this rank's chunk of it, JAX's transpose."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        ctx.chunk = x.shape[1]
        out = grp.all_gather(x.transpose(0, 1).contiguous(), axis)
        return out.transpose(0, 1).contiguous()

    @staticmethod
    def backward(ctx, ct):
        summed = grp.psum(ct.contiguous(), ctx.axis)
        i = grp.rank(ctx.axis)
        return summed[:, i * ctx.chunk:(i + 1) * ctx.chunk].contiguous(), \
            None


def gather_seq(x: torch.Tensor, axis) -> torch.Tensor:
    """(B, S/tp, d) chunks of the ranks along ``axis`` -> (B, S, d), in
    axis order."""
    return _GatherSeq.apply(x, axis)


class _PMean(torch.autograd.Function):
    """``jax.lax.pmean`` over ``axis``; its backward is the pmean of the
    cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return grp.psum(x, axis) / axis.size

    @staticmethod
    def backward(ctx, ct):
        return grp.psum(ct.contiguous(), ctx.axis) / ctx.axis.size, None


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    return _PMean.apply(x, axis)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              ep_axis: Optional[str] = None, mesh=None, a2a_algorithm="xla",
              compute_dtype=torch.bfloat16, per_row: bool = False):
    """x: (B, S, d), this rank's tokens. Returns (out (B, S, d), aux
    dict). ``per_row`` routes each row as its own group (its own expert
    capacity); the aux losses are over all tokens either way. With
    ``ep_axis`` (a ``mesh`` axis), ``p``'s expert weights are this
    rank's ``E/tp`` experts and the dispatch crosses the axis through
    ``a2a_algorithm`` (a name or a `Communicator`)."""
    if ep_axis is not None and per_row:
        raise ValueError("per-row routing runs without expert parallelism")
    Bq, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = Bq if per_row else 1
    Tg = Bq * S // G
    C = capacity(cfg, Tg)

    gates, experts, aux = _route(x.reshape(-1, d), p["router"], k)
    gather_idx, _, _, slot_of = _dispatch_indices(
        experts.reshape(G, Tg, k), gates.reshape(G, Tg, k), E, C)

    # row Tg of each group is the zero padding row
    xpad = torch.cat([x.reshape(G, Tg, d), x.new_zeros((G, 1, d))], dim=1)
    dispatched = _Dispatch.apply(xpad, gather_idx, slot_of, k)  # (G,E*C,d)
    dispatched = dispatched.reshape(G, E, C, d).transpose(0, 1)
    dispatched = dispatched.reshape(E, G * C, d)
    if ep_axis is not None:
        axis, tp = mesh.axis(ep_axis), mesh.shape[ep_axis]
        if E % tp:
            raise ValueError(f"{E} experts not divisible by axis {tp}")
        # each rank keeps its E/tp experts and receives C slots from
        # every peer
        dispatched = _exchange(dispatched, axis, tp, "fwd", a2a_algorithm)
        out = _expert_ffn(dispatched, p["w_gate"], p["w_up"], p["w_down"],
                          compute_dtype)
        out = _exchange(out, axis, tp, "rev", a2a_algorithm)  # (E, C, d)
    else:
        out = _expert_ffn(dispatched, p["w_gate"], p["w_up"], p["w_down"],
                          compute_dtype)
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # combine, in fp32: each token's k slot outputs weighted by its gates
    # and summed in a fixed order (a scatter-add in the reference; its
    # atomics would change the bits from call to call on the card). The
    # gather's gradient lands on distinct slots.
    picked = _pick(out, slot_of).float() * gates.reshape(G, Tg * k, 1)
    y = picked.reshape(G, Tg, k, d).sum(dim=2)
    y = y.to(x.dtype).reshape(Bq, S, d)

    if cfg.dense_residual:
        y = y + L.mlp_block(x, p["dense"], gated=True,
                            compute_dtype=compute_dtype)
    return y, aux
