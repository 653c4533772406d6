"""Mixture-of-Experts block with capacity-bounded top-k routing (port of
``repro/models/moe.py``), the single-device path (``ep_axis=None``).

Routing uses sort-based dispatch (a stable argsort by expert id and
capacity clipping), a grouped expert einsum and a scatter-add combine,
as the reference does. Expert parallelism (``ep_axis``, the dispatch
all-to-all and the Communicator) comes with the collectives slice
(ROADMAP.md Queue 1 (a)).

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
                  indices as ``gather_idx``, as in the reference.
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
    return gather_idx, slot_gate[:, :E * C], gather_idx


def _expert_ffn(xg, wg, wu, wd, compute_dtype):
    """xg: (E, C, d); expert weights (E, d, ff) / (E, ff, d). Casts every
    expert's weights to the compute dtype on each call, as the reference
    does."""
    cd = compute_dtype
    gate = torch.einsum("ecd,edf->ecf", xg.to(cd), wg.to(cd))
    up = torch.einsum("ecd,edf->ecf", xg.to(cd), wu.to(cd))
    h = F.silu(gate) * up
    return torch.einsum("ecf,efd->ecd", h, wd.to(cd))


def moe_block(x: torch.Tensor, p: dict, cfg: ModelConfig, *,
              ep_axis: Optional[str] = None, compute_dtype=torch.bfloat16,
              per_row: bool = False):
    """x: (B, S, d). Returns (out (B, S, d), aux dict). ``per_row`` routes
    each row as its own group (its own expert capacity); the aux losses
    are over all tokens either way."""
    if ep_axis is not None:
        raise NotImplementedError(
            "expert parallelism (ep_axis) comes with the collectives slice "
            "(comms/*, ROADMAP.md Queue 1 (a)); the port runs ep_axis=None")
    Bq, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    G = Bq if per_row else 1
    Tg = Bq * S // G
    C = max(1, int(Tg * k * cfg.capacity_factor) // E)

    gates, experts, aux = _route(x.reshape(-1, d), p["router"], k)
    gather_idx, slot_gate, slot_token = _dispatch_indices(
        experts.reshape(G, Tg, k), gates.reshape(G, Tg, k), E, C)

    # row Tg of each group is the zero padding row
    xpad = torch.cat([x.reshape(G, Tg, d), x.new_zeros((G, 1, d))], dim=1)
    offs = torch.arange(G, device=x.device)[:, None] * (Tg + 1)
    dispatched = xpad.reshape(G * (Tg + 1), d)[gather_idx + offs]  # (G,E*C,d)
    dispatched = dispatched.reshape(G, E, C, d).transpose(0, 1)
    out = _expert_ffn(dispatched.reshape(E, G * C, d), p["w_gate"],
                      p["w_up"], p["w_down"], compute_dtype)
    out = out.reshape(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

    # combine: scatter-add expert slot outputs back to tokens, in fp32
    flat = out.float() * slot_gate.reshape(-1, 1)
    y = torch.zeros((G * (Tg + 1), d), dtype=torch.float32, device=x.device)
    y.index_add_(0, (slot_token + offs).reshape(-1), flat)
    y = y.reshape(G, Tg + 1, d)[:, :Tg].to(x.dtype).reshape(Bq, S, d)

    if cfg.dense_residual:
        y = y + L.mlp_block(x, p["dense"], gated=True,
                            compute_dtype=compute_dtype)
    return y, aux
