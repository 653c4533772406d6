"""MoE decoder LM (olmoe / arctic families): GQA attention + MoE FFN (port
of ``repro/models/moe_model.py``), the single-device path.

Params: ``{"embed": {...}, "layers": [{"attn", "moe", "ln1", "ln2"}, ...]}``.
Serving takes the dense family's cache (``init_cache``) and its two
decode forms (``transformer.decode_step``). The decode step routes the
experts in the form's own way: a dense cache is one batch whose tokens
share the experts' capacity, as the reference's batched ``decode_step``
does; a paged cache is the serving engine's, whose rows are independent
requests, so each row is routed as its own group, as the reference's
engine does by vmapping a batch-1 decode. Expert parallelism
(``ep_axis``) comes with the collectives slice; training's ``loss_fn``
with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_block, moe_params


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


def _layer(x, lp, cfg, positions, *, window, kv, ep_axis, compute_dtype,
           attn_impl, return_kv=False, per_row=False):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn, new_kv = L.attention_block(
        h, lp["attn"], cfg, positions, causal=True, window=window,
        kv_cache=kv, return_kv=return_kv, compute_dtype=compute_dtype,
        attn_impl=attn_impl)
    x = x + attn
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    y, aux = moe_block(h, lp["moe"], cfg, ep_axis=ep_axis,
                       compute_dtype=compute_dtype, per_row=per_row)
    return x + y, new_kv, aux


def forward(params, embeds, cfg: ModelConfig, *, window=0,
            ep_axis: Optional[str] = None, compute_dtype=torch.bfloat16,
            attn_impl="auto"):
    """embeds: (B, S, d). Returns (final hidden (B, S, d), aux losses
    averaged over the layers)."""
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    x, auxes = embeds, []
    for lp in params["layers"]:
        x, _, aux = _layer(x, lp, cfg, positions, window=window, kv=None,
                           ep_axis=ep_axis, compute_dtype=compute_dtype,
                           attn_impl=attn_impl)
        auxes.append(aux)
    aux = {n: torch.stack([a[n] for a in auxes]).mean() for n in auxes[0]}
    return x, aux


init_cache = T.init_cache


def decode_step(params, cache, tokens, cfg: ModelConfig, *, window=0,
                ep_axis: Optional[str] = None, compute_dtype=torch.bfloat16,
                attn_impl="auto"):
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
                         kv=L.decode_kv(cache, i, length), ep_axis=ep_axis,
                         compute_dtype=compute_dtype, attn_impl=attn_impl,
                         per_row=per_row)
    logits = T.logits_fn(params, x, cfg, compute_dtype)[:, 0]
    return logits, {**L.kv_leaves(cache), "length": length + 1}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *, window=0,
            ep_axis: Optional[str] = None, compute_dtype=torch.bfloat16,
            attn_impl="auto"):
    """Run the prompt, returning logits and a primed cache (k/v in the
    compute dtype, padded to ``cache_len``)."""
    B, S = tokens.shape
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        x, kv, _ = _layer(x, lp, cfg, positions, window=window, kv=None,
                          ep_axis=ep_axis, compute_dtype=compute_dtype,
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
