"""Zamba2-style hybrid: a Mamba2 backbone with a single *shared* attention
block applied every ``attn_every`` SSM layers (port of
``repro/models/hybrid.py``). [arXiv:2411.15242]

The shared block goes through the port's ``layers.attention_block`` and
``mlp_block``, so its prefill attention runs the flash-attention kernel
on the card. ``decode_step`` takes the cache's ``length`` as a scalar or
a per-row ``(B,)`` tensor and a dense or paged KV cache, as
``transformer.decode_step`` does, and writes the token's k/v into the
cache IN PLACE. Training: ``loss_fn`` (the SSD chunk and flash-attention
kernels' autograd functions with the ``"auto"`` impls). On a ``model``
axis the shared block runs tensor-parallel (its heads and FFN columns
split) and the mamba layers whole on every rank; under FSDP the shared
block is gathered once a forward with the rest of the tree (over the
data ranks of this rank's model coordinate when there is a model axis),
its gradient summed over its uses by autograd before its one
reduce-scatter, and each mamba layer at its own gather point.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T


def n_attn_applications(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_every


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    kw = dict(dtype=dtype, device=device)
    params = S.init_params(gen, cfg, **kw)
    # ONE shared attention+MLP block (zamba weight sharing)
    params["shared"] = {
        "attn": L.attention_params(gen, cfg, **kw),
        "mlp": L.mlp_params(gen, cfg.d_model, cfg.d_ff, gated=True, **kw),
        "ln1": torch.ones((cfg.d_model,), **kw),
        "ln2": torch.ones((cfg.d_model,), **kw),
    }
    return params


def _groups(cfg: ModelConfig):
    """Layer index ranges of the ``n_attn_applications`` mamba groups."""
    ae = cfg.attn_every
    return [range(g * ae, (g + 1) * ae) for g in range(n_attn_applications(cfg))]


def _shared_attn(x, sp, cfg, positions, *, window, kv, compute_dtype,
                 attn_impl, return_kv=False, tp=None):
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    attn, new_kv = L.attention_block(h, sp["attn"], cfg, positions,
                                     causal=True, window=window, kv_cache=kv,
                                     return_kv=return_kv,
                                     compute_dtype=compute_dtype,
                                     attn_impl=attn_impl, tp=tp)
    x = x + attn
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(h, sp["mlp"], gated=True, compute_dtype=compute_dtype,
                        tp=L.split(tp, cfg.d_ff))
    return x, new_kv


def forward(params, embeds, cfg: ModelConfig, *, window=0,
            compute_dtype=torch.bfloat16, ssd_impl="auto", attn_impl="auto",
            remat: bool = False, tp=None):
    """embeds: (B, S, d) already-embedded inputs. Returns final hidden
    (B,S,d). Each mamba layer's params pass the release point
    ``("layers", i)`` with its GLOBAL index i (the reference's per-group
    scan restarts its tags at 0 in every group; the port's streamed sync
    keys layers by tag, so the tags must be unique), so the backward
    releases them deepest first, L-1 ... 0. The shared block is used once
    a group and stays in the residual. ``remat`` recomputes each mamba
    layer in the backward, as the reference checkpoints its scan body.
    Over ``tp`` the shared block is tensor-parallel and the mamba layers
    run whole on every rank (``param_specs`` splits no SSM leaf over
    ``model``)."""
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    x = embeds
    for grp in _groups(cfg):
        x = S.mamba_layers(x, params, cfg, grp, compute_dtype=compute_dtype,
                           ssd_impl=ssd_impl, remat=remat)
        x, _ = _shared_attn(x, params["shared"], cfg, positions,
                            window=window, kv=None,
                            compute_dtype=compute_dtype, attn_impl=attn_impl,
                            tp=tp)
    return x


def loss_fn(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            window=0, ssd_impl="auto", attn_impl="auto",
            remat: bool = False, tp=None):
    """(mean next-token NLL, {}) of ``batch`` (``tokens``, ``labels``), as
    the reference's ``hybrid.loss_fn``; over ``tp``, tensor-parallel."""
    x = T.embed_tokens(params, batch["tokens"], cfg, compute_dtype, tp=tp)
    h = forward(params, x, cfg, window=window, compute_dtype=compute_dtype,
                ssd_impl=ssd_impl, attn_impl=attn_impl, remat=remat, tp=tp)
    loss = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                          compute_dtype=compute_dtype, tp=tp)
    return loss, {}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu"):
    ng = n_attn_applications(cfg)
    KV, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "ssm": S.init_ssm_state(cfg, batch, cfg.num_layers, device=device),
        "k": torch.zeros((ng, batch, cache_len, KV, Dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((ng, batch, cache_len, KV, Dh), dtype=dtype,
                         device=device),
        "length": torch.zeros((), dtype=torch.long, device=device),
    }


def decode_step(params, cache, tokens, cfg: ModelConfig, *, window=0,
                compute_dtype=torch.bfloat16, attn_impl="auto"):
    """tokens: (B, 1); returns (logits (B, V), new cache). ``length`` is a
    scalar or a ``(B,)`` tensor of per-row lengths. The KV part of the
    cache is dense or paged, as in ``transformer.decode_step``, with its
    layer axis counting shared-attention applications."""
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    length = torch.as_tensor(cache["length"], device=x.device)
    positions = length[None] if length.dim() == 0 else length[:, None]
    convs, ssds = [], []
    for g, grp in enumerate(_groups(cfg)):
        for i in grp:
            x, ns = S.mamba_layer(x, params["layers"][i], cfg,
                                  compute_dtype=compute_dtype,
                                  state={"conv": cache["ssm"]["conv"][i],
                                         "ssd": cache["ssm"]["ssd"][i]})
            convs.append(ns["conv"])
            ssds.append(ns["ssd"])
        x, _ = _shared_attn(x, params["shared"], cfg, positions,
                            window=window, kv=L.decode_kv(cache, g, length),
                            compute_dtype=compute_dtype, attn_impl=attn_impl)
    logits = T.logits_fn(params, x, cfg, compute_dtype)[:, 0]
    new_cache = {
        "ssm": {"conv": torch.stack(convs), "ssd": torch.stack(ssds)},
        **L.kv_leaves(cache),
        "length": length + 1,
    }
    return logits, new_cache


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *, window=0,
            compute_dtype=torch.bfloat16, ssd_impl="auto", attn_impl="auto"):
    """Run the prompt, returning logits and a primed cache (k/v in the
    compute dtype, padded to ``cache_len``)."""
    B, S_len = tokens.shape
    S.check_prompt_len(cfg, S_len)
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(S_len, device=x.device)
    convs, ssds, ks, vs = [], [], [], []
    for grp in _groups(cfg):
        for i in grp:
            x, ns = S.mamba_layer(x, params["layers"][i], cfg,
                                  compute_dtype=compute_dtype,
                                  ssd_impl=ssd_impl, return_state=True)
            convs.append(ns["conv"])
            ssds.append(ns["ssd"])
        x, kv = _shared_attn(x, params["shared"], cfg, positions,
                             window=window, kv=None,
                             compute_dtype=compute_dtype, attn_impl=attn_impl,
                             return_kv=True)
        ks.append(kv["k"].to(compute_dtype))
        vs.append(kv["v"].to(compute_dtype))

    logits = T.logits_fn(params, x, cfg, compute_dtype)
    pad = cache_len - S_len
    if pad < 0:
        raise ValueError(f"prompt {S_len} longer than cache {cache_len}")
    widths = (0, 0, 0, 0, 0, pad)          # F.pad order: last dim first
    cache = {
        "ssm": {"conv": torch.stack(convs), "ssd": torch.stack(ssds)},
        "k": F.pad(torch.stack(ks), widths),
        "v": F.pad(torch.stack(vs), widths),
        "length": torch.tensor(S_len, dtype=torch.long, device=x.device),
    }
    return logits, cache
