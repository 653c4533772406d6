"""LLaVA-NeXT-style VLM (port of ``repro/models/vlm.py``): a dense decoder
LM consuming precomputed anyres patch embeddings (vision tower and
projector stubbed, as in the reference).

Sequence layout: [patch embeddings (num_patches) | text tokens]. Labels
over image positions are ignored (-1). Params, cache and decode are the
dense family's; training goes through ``transformer.forward``, so it has
that family's release points, ``remat``, tensor parallelism and FSDP
gather points (also both together).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

init_params = T.init_params
init_cache = T.init_cache
decode_step = T.decode_step  # decoding past the prefix is pure-text


def assemble_embeds(params, batch, cfg: ModelConfig, compute_dtype,
                    tp=None):
    """Concatenate patch embeddings with text token embeddings (over
    ``tp`` the text's vocab-parallel; the patches are the same on every
    rank)."""
    patches = batch["patches"].to(compute_dtype)         # (B, P, d)
    text = T.embed_tokens(params, batch["tokens"], cfg, compute_dtype,
                          tp=tp)
    return torch.cat([patches, text], dim=1)


def loss_fn(params, batch, cfg: ModelConfig, *, window: int = 0,
            compute_dtype=torch.bfloat16, attn_impl: str = "auto",
            remat: bool = False, tp=None):
    x = assemble_embeds(params, batch, cfg, compute_dtype, tp=tp)
    h = T.forward(params, x, cfg, window=window, compute_dtype=compute_dtype,
                  attn_impl=attn_impl, remat=remat, tp=tp)
    # labels: (B, P + S_text); image positions must be -1 (ignored)
    loss = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                          compute_dtype=compute_dtype, tp=tp)
    return loss, {}


def prefill(params, batch, cfg: ModelConfig, cache_len: int, *,
            window: int = 0, compute_dtype=torch.bfloat16,
            attn_impl: str = "auto"):
    """Prefill over [patches | prompt tokens]: logits and a primed dense
    cache (k/v in the compute dtype, padded to ``cache_len``)."""
    x = assemble_embeds(params, batch, cfg, compute_dtype)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        x, kv = T._layer(x, lp, cfg, positions, window=window, kv=None,
                         compute_dtype=compute_dtype, attn_impl=attn_impl,
                         return_kv=True)
        ks.append(kv["k"].to(compute_dtype))
        vs.append(kv["v"].to(compute_dtype))
    logits = T.logits_fn(params, x, cfg, compute_dtype)
    pad = cache_len - S
    if pad < 0:
        raise ValueError(f"prefix {S} longer than cache {cache_len}")
    widths = (0, 0, 0, 0, 0, pad)          # F.pad order: last dim first
    return logits, {
        "k": F.pad(torch.stack(ks), widths),
        "v": F.pad(torch.stack(vs), widths),
        "length": torch.tensor(S, dtype=torch.long, device=x.device),
    }
