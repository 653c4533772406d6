"""Dense decoder-only transformer (llama/GLM/qwen family), port of
``repro/models/transformer.py``.

Params are a dict: ``{"embed": {...}, "layers": [per-layer dict, ...]}``;
the reference's stacked ``(L, ...)`` leaves become a Python list, and its
``lax.scan`` over layers a loop (``remat``: ``torch.utils.checkpoint``
around each layer, as ``jax.checkpoint`` around the scan body; each
layer's params pass a gradient release point, ``("layers", i)``, as in
the reference's unrolled stack). Training:
``loss_fn``, on a ``model`` axis too (``tp``: tensor parallelism, the
blocks' and the vocab-parallel head's collectives in
``models/layers.py``). Serving: ``init_cache``, ``prefill`` and
``decode_step``, whose ``length`` is a scalar or a per-row ``(B,)``
tensor and whose cache is dense or paged (block pools read through the
paged-attention kernel).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    kw = dict(dtype=dtype, device=device)
    embed = L.embed_params(gen, cfg, **kw)
    layers = [{
        "attn": L.attention_params(gen, cfg, **kw),
        "mlp": L.mlp_params(gen, cfg.d_model, cfg.d_ff, **kw),
        "ln1": torch.ones((cfg.d_model,), **kw),
        "ln2": torch.ones((cfg.d_model,), **kw),
    } for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers}


def _layer(x, lp, cfg: ModelConfig, positions, *, window, kv, compute_dtype,
           attn_impl, return_kv=False, tp=None):
    h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
    attn, new_kv = L.attention_block(
        h, lp["attn"], cfg, positions, causal=True, window=window,
        kv_cache=kv, return_kv=return_kv, compute_dtype=compute_dtype,
        attn_impl=attn_impl, tp=tp)
    x = x + attn
    h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(h, lp["mlp"], gated=True, compute_dtype=compute_dtype,
                        tp=L.split(tp, cfg.d_ff))
    return x, new_kv


def forward(params, embeds: torch.Tensor, cfg: ModelConfig, *,
            positions: Optional[torch.Tensor] = None, window: int = 0,
            compute_dtype=torch.bfloat16, attn_impl: str = "auto",
            remat: bool = False, tp=None):
    """embeds: (B, S, d) already-embedded inputs. Returns final hidden
    (B,S,d). ``remat`` recomputes each layer in the backward instead of
    keeping its activations (its collectives over ``tp`` included)."""
    if positions is None:
        positions = torch.arange(embeds.shape[1], device=embeds.device)

    def body(x, lp):
        y, _ = _layer(x, lp, cfg, positions, window=window, kv=None,
                      compute_dtype=compute_dtype, attn_impl=attn_impl,
                      tp=tp)
        return y

    x = embeds
    for i, lp in enumerate(params["layers"]):
        # the release point and the FSDP gather wrap the layer's params
        # outside the checkpoint, so a recompute fires neither again
        lp = L.grad_release(("layers", i), L.gathered(lp))
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return x


def embed_tokens(params, tokens, cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 tp=None):
    # F.embedding, not indexing: the same forward bits, and a CPU backward
    # that sums the rows of repeated tokens in index order (the indexing's
    # accumulating index_put_ sums them in an order that varies between
    # calls when more than one intra-op thread runs); over ``tp`` this
    # rank's vocab rows (`layers.vocab_embedding`)
    return L.vocab_embedding(tokens, params["embed"]["tok"].to(compute_dtype),
                             L.split(tp, L.pad_vocab(cfg.vocab_size)))


def logits_fn(params, hidden, cfg: ModelConfig, compute_dtype=torch.bfloat16):
    return L.unembed(hidden, params["embed"], cfg, compute_dtype)


def loss_fn(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            window: int = 0, attn_impl: str = "auto", remat: bool = False,
            tp=None):
    """(mean next-token NLL, {}) of ``batch`` (``tokens``, ``labels``);
    over ``tp`` (a `group.Axis`), ``params`` are this rank's
    `sharding.tp_shard` slices."""
    x = embed_tokens(params, batch["tokens"], cfg, compute_dtype, tp=tp)
    h = forward(params, x, cfg, window=window, compute_dtype=compute_dtype,
                attn_impl=attn_impl, remat=remat, tp=tp)
    loss = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                          compute_dtype=compute_dtype, tp=tp)
    return loss, {}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu"):
    nl, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((nl, batch, cache_len, KV, Dh), dtype=dtype, device=device),
        "v": torch.zeros((nl, batch, cache_len, KV, Dh), dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.long, device=device),
    }


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                window: int = 0, compute_dtype=torch.bfloat16,
                attn_impl: str = "auto"):
    """tokens: (B, 1) next token ids; returns (logits (B, V), new_cache).

    The cache is dense, ``{k, v, length}`` with ``(L, B, T, KV, Dh)``
    views, or paged, ``{k_pool, v_pool, block_tables, length}`` with
    ``(L, NB, bs, KV, Dh)`` pools and ``(B, nb)`` tables (the serving
    engine's form; see ``layers.attention_block``). ``length`` is a
    scalar (every row at the same position, as in the reference; dense
    only) or a ``(B,)`` tensor of per-row lengths. The token's k/v are
    written into the cache's tensors in place; the new cache holds those
    tensors and ``length + 1``. ``attn_impl`` picks the paged form's
    attention (``ops.paged_attention``); the dense form runs
    ``layers.cache_attention``.
    """
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    length = torch.as_tensor(cache["length"], device=x.device)
    # absolute position of this token: (1,) shared, or (B, 1) per row
    positions = length[None] if length.dim() == 0 else length[:, None]
    for i, lp in enumerate(params["layers"]):
        x, _ = _layer(x, lp, cfg, positions, window=window,
                      kv=L.decode_kv(cache, i, length),
                      compute_dtype=compute_dtype, attn_impl=attn_impl)
    logits = logits_fn(params, x, cfg, compute_dtype)[:, 0]
    return logits, {**L.kv_leaves(cache), "length": length + 1}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *,
            window: int = 0, compute_dtype=torch.bfloat16, attn_impl="auto"):
    """Run the prompt, returning logits and a primed cache (k/v in the
    compute dtype, padded to ``cache_len``)."""
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg, compute_dtype)
    positions = torch.arange(S, device=x.device)
    ks, vs = [], []
    for lp in params["layers"]:
        x, kv = _layer(x, lp, cfg, positions, window=window, kv=None,
                       compute_dtype=compute_dtype, attn_impl=attn_impl,
                       return_kv=True)
        ks.append(kv["k"].to(compute_dtype))
        vs.append(kv["v"].to(compute_dtype))
    logits = logits_fn(params, x, cfg, compute_dtype)
    # place the prompt at the head of a cache_len cache
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
