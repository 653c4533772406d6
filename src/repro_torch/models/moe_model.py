"""MoE decoder LM (olmoe / arctic families): GQA attention + MoE FFN (port
of ``repro/models/moe_model.py``).

Params: ``{"embed": {...}, "layers": [{"attn", "moe", "ln1", "ln2"}, ...]}``.

Training (``loss_fn``: cross-entropy plus ``LB_COEF`` x the
load-balance loss and ``Z_COEF`` x the router z-loss, each averaged over
the layers) runs with every expert in this process, or, with ``ep_axis``
and a ``mesh``, expert-parallel over that mesh axis. The reference has
two expert-parallel forms: a nested ``shard_map`` under XLA's
auto-partitioning, and ``ep_manual`` inside the one manual training
program. The port's ranks are processes, so it has one form, the
``ep_manual`` one (`_moe_apply`): this rank's ``S/tp`` chunk of the
sequence, the block over its local experts, the aux losses averaged
over the axis, and the sequence gathered back. Every layer's params
pass a gradient release point, ``("layers", i)``, as in
``models/transformer.py``; ``remat`` recomputes each layer in the
backward (its collectives included, in every rank alike). Under FSDP
each layer's params pass its gather point (``layers.gathered``) first:
the expert stacks, held ``(E/tp, d/dp, ff)``, are gathered over the data
ranks of this rank's model coordinate before the dispatch all-to-all
over ``model``, and their gradient is reduce-scattered over those ranks
after the combine's backward.

Serving takes the dense family's cache (``init_cache``) and its two
decode forms (``transformer.decode_step``), with every expert in this
process. The decode step routes the experts in the form's own way: a
dense cache is one batch whose tokens share the experts' capacity, as
the reference's batched ``decode_step`` does; a paged cache is the
serving engine's, whose rows are independent requests, so each row is
routed as its own group, as the reference's engine does by vmapping a
batch-1 decode.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import group as grp
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import gather_seq, moe_block, moe_params, pmean

LB_COEF = 0.01
Z_COEF = 0.001


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    kw = dict(dtype=dtype, device=device)
    embed = L.embed_params(gen, cfg, **kw)
    layers = [{
        "attn": L.attention_params(gen, cfg, **kw),
        "moe": moe_params(gen, cfg, **kw),
        "ln1": torch.ones((cfg.d_model,), **kw),
        "ln2": torch.ones((cfg.d_model,), **kw),
    } for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers}


def _moe_apply(h, mp, cfg, *, ep_axis, mesh, compute_dtype,
               a2a_algorithm="xla", per_row=False):
    if ep_axis is None:
        return moe_block(h, mp, cfg, compute_dtype=compute_dtype,
                         per_row=per_row)
    # the reference's ep_manual form: h is replicated over the axis;
    # this rank runs the expert block on its sequence chunk and local
    # experts, then gathers the sequence back
    axis, tp = mesh.axis(ep_axis), mesh.shape[ep_axis]
    S = h.shape[1]
    assert S % tp == 0, \
        f"seq {S} not divisible by expert-parallel axis {tp}"
    i = grp.rank(axis)
    hh = h[:, i * (S // tp):(i + 1) * (S // tp)]
    out, aux = moe_block(hh, mp, cfg, ep_axis=ep_axis, mesh=mesh,
                         a2a_algorithm=a2a_algorithm,
                         compute_dtype=compute_dtype)
    aux = {n: pmean(v, axis) for n, v in aux.items()}
    return gather_seq(out, axis), aux


def _layer(x, lp, cfg, positions, *, window, kv, compute_dtype, attn_impl,
           ep_axis=None, mesh=None, a2a_algorithm="xla", return_kv=False,
           per_row=False):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn, new_kv = L.attention_block(
        h, lp["attn"], cfg, positions, causal=True, window=window,
        kv_cache=kv, return_kv=return_kv, compute_dtype=compute_dtype,
        attn_impl=attn_impl)
    x = x + attn
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _moe_apply(h, lp["moe"], cfg, ep_axis=ep_axis, mesh=mesh,
                        compute_dtype=compute_dtype,
                        a2a_algorithm=a2a_algorithm, per_row=per_row)
    return x + y, new_kv, aux


def forward(params, embeds, cfg: ModelConfig, *, window=0,
            ep_axis: Optional[str] = None, mesh=None, a2a_algorithm="xla",
            compute_dtype=torch.bfloat16, attn_impl="auto",
            remat: bool = False):
    """embeds: (B, S, d). Returns (final hidden (B, S, d), aux losses
    averaged over the layers). ``ep_axis``: expert parallelism over that
    axis of ``mesh`` (``a2a_algorithm``: a name or a `Communicator`)."""
    positions = torch.arange(embeds.shape[1], device=embeds.device)

    def body(x, lp):
        y, _, aux = _layer(x, lp, cfg, positions, window=window, kv=None,
                           compute_dtype=compute_dtype, attn_impl=attn_impl,
                           ep_axis=ep_axis, mesh=mesh,
                           a2a_algorithm=a2a_algorithm)
        return y, aux

    x, auxes = embeds, []
    for i, lp in enumerate(params["layers"]):
        # the release point and the FSDP gather wrap the layer's params
        # outside the checkpoint, so a recompute fires neither again
        lp = L.grad_release(("layers", i), L.gathered(lp))
        x, aux = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
        auxes.append(aux)
    aux = {n: torch.stack([a[n] for a in auxes]).mean() for n in auxes[0]}
    return x, aux


def loss_fn(params, batch, cfg: ModelConfig, **kw):
    """(cross-entropy + the weighted aux losses, {"ce", "lb_loss",
    "z_loss"}) of ``batch`` (``tokens``, ``labels``); ``kw`` as
    `forward`'s."""
    cd = kw.get("compute_dtype", torch.bfloat16)
    x = T.embed_tokens(params, batch["tokens"], cfg, cd)
    h, aux = forward(params, x, cfg, **kw)
    ce = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                        compute_dtype=cd)
    total = ce + LB_COEF * aux["lb_loss"] + Z_COEF * aux["z_loss"]
    return total, {"ce": ce, **aux}


init_cache = T.init_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, *, window=0,
                compute_dtype=torch.bfloat16, attn_impl="auto"):
    """tokens: (B, 1); returns (logits (B, V), new cache). The cache is
    dense or paged, with a scalar or ``(B,)`` length, as in
    ``transformer.decode_step``; a paged cache routes each row as its own
    group."""
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    length = torch.as_tensor(cache["length"], device=x.device)
    positions = length[None] if length.dim() == 0 else length[:, None]
    per_row = "block_tables" in cache
    for i, lp in enumerate(params["layers"]):
        x, _, _ = _layer(x, lp, cfg, positions, window=window,
                         kv=L.decode_kv(cache, i, length),
                         compute_dtype=compute_dtype, attn_impl=attn_impl,
                         per_row=per_row)
    logits = T.logits_fn(params, x, cfg, compute_dtype)[:, 0]
    return logits, {**L.kv_leaves(cache), "length": length + 1}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *, window=0,
            compute_dtype=torch.bfloat16, attn_impl="auto"):
    """Run the prompt, returning logits and a primed cache (k/v in the
    compute dtype, padded to ``cache_len``)."""
    B, S = tokens.shape
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        x, kv, _ = _layer(x, lp, cfg, positions, window=window, kv=None,
                          compute_dtype=compute_dtype,
                          attn_impl=attn_impl, return_kv=True)
        ks.append(kv["k"].to(compute_dtype))
        vs.append(kv["v"].to(compute_dtype))
    logits = T.logits_fn(params, x, cfg, compute_dtype)
    pad = cache_len - S
    if pad < 0:
        raise ValueError(f"prompt {S} longer than cache {cache_len}")
    widths = (0, 0, 0, 0, 0, pad)          # F.pad order: last dim first
    cache = {
        "k": F.pad(torch.stack(ks), widths),
        "v": F.pad(torch.stack(vs), widths),
        "length": torch.tensor(S, dtype=torch.long, device=x.device),
    }
    return logits, cache
