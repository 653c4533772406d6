"""Whisper-style encoder-decoder transformer backbone (port of
``repro/models/encdec.py``).

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: the model consumes precomputed frame embeddings ``audio`` of
shape (B, encoder_seq, d_model). LayerNorm (scale+bias), learned
positions, GELU MLPs — the whisper recipe.

Params: ``{"embed" (with the decoder's learned ``pos``), "enc_pos",
"encoder": [per-layer dict], "enc_final", "decoder": [per-layer
dict]}``; the reference's two stacked ``(L, ...)`` trees become two
Python lists. The encoder's self-attention and the decoder's causal
self-attention go through ``ops.attention(impl=attn_impl)`` (the flash
kernels on the card); cross-attention is plain, as the reference's
``impl="xla"`` einsums are. Each layer's params pass a gradient release
point, ``("encoder", i)`` or ``("decoder", i)``: the port's streamed
sync keys each stack by its own name (the reference tags both stacks
``("layers", i)``; see ROADMAP.md Queue 3). Under FSDP each layer's
params pass a gather point beside their release point
(``layers.gathered``), which on a ``model`` axis gathers this rank's
tensor-parallel slices whole over the data ranks of its model
coordinate.

Serving: ``prefill(..., audio=...)`` encodes and runs the prompt;
``decode_step`` takes the dense or the paged self-attention cache (as
``transformer.decode_step``), a scalar or per-row ``(B,)`` ``length``,
and the cross KV ``xk``/``xv`` of shape ``(nd, B, encoder_seq, H, Dh)``
in bf16 (the slot on axis 1, where the serving engine keeps opaque
state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import group as grp
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def _ln(d, kw):
    return {"scale": torch.ones((d,), **kw), "bias": torch.zeros((d,), **kw)}


def _apply_ln(x, p, eps):
    return L.layer_norm(x, p["scale"], p["bias"], eps)


def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    kw = dict(dtype=dtype, device=device)
    d = cfg.d_model
    embed = L.embed_params(gen, cfg, **kw)        # includes decoder "pos"
    enc_pos = L.dense_init(gen, (cfg.encoder_seq, d), d, **kw)
    encoder = [{
        "attn": L.attention_params(gen, cfg, **kw),
        "mlp": L.mlp_params(gen, d, cfg.d_ff, gated=False, **kw),
        "ln1": _ln(d, kw),
        "ln2": _ln(d, kw),
    } for _ in range(cfg.encoder_layers)]
    decoder = [{
        "self_attn": L.attention_params(gen, cfg, **kw),
        "cross_attn": L.attention_params(gen, cfg, **kw),
        "mlp": L.mlp_params(gen, d, cfg.d_ff, gated=False, **kw),
        "ln1": _ln(d, kw),
        "ln2": _ln(d, kw),
        "ln3": _ln(d, kw),
    } for _ in range(cfg.num_layers)]
    return {"embed": embed, "enc_pos": enc_pos, "encoder": encoder,
            "enc_final": _ln(d, kw), "decoder": decoder}


def _cross_attn(x, p, kv, compute_dtype, tp=None):
    """x: (B,S,d); kv: precomputed {"k","v"}: (B,T,H,Dh) from the encoder.
    Plain attention, as the reference's ``impl="xla"``. ``tp``: the axis
    ``p``'s heads split over (`layers.split`), kv this rank's heads."""
    cd = compute_dtype
    q = L.split_matmul("bsd,dhk->bshk", x, p["wq"], cd, tp)
    out = ops.attention(q, kv["k"], kv["v"], causal=False, impl="xla")
    return L.split_matmul("bshk,hkd->bsd", out, p["wo"], cd, tp,
                          reduce=True)


def _cross_kv(enc_out, p, compute_dtype, cfg=None, tp=None):
    """The cross-attention's keys and values of ``enc_out``; over ``tp``
    (heads split) this rank's kv heads (`layers.local_heads`), each a
    column-parallel product (`layers.split_matmul`)."""
    cd = compute_dtype
    if tp is not None:
        p = L.local_heads(p, cfg, tp)
    k = L.split_matmul("btd,dhk->bthk", enc_out, p["wk"], cd, tp)
    v = L.split_matmul("btd,dhk->bthk", enc_out, p["wv"], cd, tp)
    return {"k": k, "v": v}


def _stack(params, key, body, x, remat):
    """Run ``body`` over the layers of ``params[key]``, each layer's
    params through its FSDP gather and its release point ``(key, i)``
    (outside the checkpoint, so a recompute fires neither again)."""
    for i, lp in enumerate(params[key]):
        lp = L.grad_release((key, i), L.gathered(lp))
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return x


def encode(params, audio, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
           attn_impl="auto", remat: bool = False, tp=None):
    cd = compute_dtype
    Senc = audio.shape[1]
    x = audio.to(cd) + params["enc_pos"][None, :Senc].to(cd)
    positions = torch.arange(Senc, device=x.device)

    def body(x, lp):
        h = _apply_ln(x, lp["ln1"], cfg.norm_eps)
        attn, _ = L.attention_block(h, lp["attn"], cfg, positions,
                                    causal=False, compute_dtype=cd,
                                    attn_impl=attn_impl, tp=tp)
        x = x + attn
        h = _apply_ln(x, lp["ln2"], cfg.norm_eps)
        return x + L.mlp_block(h, lp["mlp"], gated=False, compute_dtype=cd,
                               tp=L.split(tp, cfg.d_ff))

    x = _stack(params, "encoder", body, x, remat)
    return _apply_ln(x, params["enc_final"], cfg.norm_eps)


def _embed(params, tokens, positions, compute_dtype, tp=None):
    """Token embedding (over ``tp`` vocab-parallel,
    `layers.vocab_embedding`) plus the learned position of each entry of
    ``positions`` ((S,) shared, or (B, 1) per row), modulo the table."""
    pos_tab = params["embed"]["pos"]
    pos = pos_tab[positions % pos_tab.shape[0]].to(compute_dtype)
    tok = L.vocab_embedding(tokens, params["embed"]["tok"].to(compute_dtype),
                            tp)
    return tok + (pos[None] if positions.dim() == 1 else pos)


def decode_train(params, tokens, enc_out, cfg: ModelConfig, *,
                 compute_dtype=torch.bfloat16, attn_impl="auto",
                 remat: bool = False, tp=None):
    """The decoder over ``tokens`` and the encoder's output; over ``tp``
    the blocks and the cross-attention are tensor-parallel."""
    cd = compute_dtype
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = _embed(params, tokens, positions, cd,
               tp=L.split(tp, L.pad_vocab(cfg.vocab_size)))
    xtp = L.split(tp, cfg.num_heads)

    def body(x, lp):
        h = _apply_ln(x, lp["ln1"], cfg.norm_eps)
        attn, _ = L.attention_block(h, lp["self_attn"], cfg, positions,
                                    causal=True, compute_dtype=cd,
                                    attn_impl=attn_impl, tp=tp)
        x = x + attn
        h = _apply_ln(x, lp["ln2"], cfg.norm_eps)
        kv = _cross_kv(enc_out, lp["cross_attn"], cd, cfg, xtp)
        x = x + _cross_attn(h, lp["cross_attn"], kv, cd, xtp)
        h = _apply_ln(x, lp["ln3"], cfg.norm_eps)
        return x + L.mlp_block(h, lp["mlp"], gated=False, compute_dtype=cd,
                               tp=L.split(tp, cfg.d_ff))

    return _stack(params, "decoder", body, x, remat)


def loss_fn(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            attn_impl="auto", remat: bool = False, tp=None):
    """(mean next-token NLL, {}) of ``batch`` (``audio``, ``tokens``,
    ``labels``); over ``tp``, tensor-parallel (`sharding.tp_shard`'s
    params)."""
    enc = encode(params, batch["audio"], cfg, compute_dtype=compute_dtype,
                 attn_impl=attn_impl, remat=remat, tp=tp)
    h = decode_train(params, batch["tokens"], enc, cfg,
                     compute_dtype=compute_dtype, attn_impl=attn_impl,
                     remat=remat, tp=tp)
    loss = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                          compute_dtype=compute_dtype, tp=tp)
    return loss, {}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu"):
    nd, H, KV, Dh = (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads,
                     cfg.resolved_head_dim)
    kw = dict(dtype=dtype, device=device)
    return {
        "k": torch.zeros((nd, batch, cache_len, KV, Dh), **kw),
        "v": torch.zeros((nd, batch, cache_len, KV, Dh), **kw),
        # cross-attention KV is computed once from the encoder at prefill
        "xk": torch.zeros((nd, batch, cfg.encoder_seq, H, Dh), **kw),
        "xv": torch.zeros((nd, batch, cfg.encoder_seq, H, Dh), **kw),
        "length": torch.zeros((), dtype=torch.long, device=device),
    }


def prime_cross(params, audio, cfg: ModelConfig, cache, *,
                compute_dtype=torch.bfloat16, attn_impl="auto"):
    """Encode audio and fill the cross-attention KV entries of the cache
    (bf16, as the reference's)."""
    enc = encode(params, audio, cfg, compute_dtype=compute_dtype,
                 attn_impl=attn_impl)
    kvs = [_cross_kv(enc, lp["cross_attn"], compute_dtype)
           for lp in params["decoder"]]
    return {**cache,
            "xk": torch.stack([kv["k"].to(torch.bfloat16) for kv in kvs]),
            "xv": torch.stack([kv["v"].to(torch.bfloat16) for kv in kvs])}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *, audio,
            compute_dtype=torch.bfloat16, attn_impl="auto"):
    """Encode ``audio`` and run the decoder prompt, returning logits and a
    primed cache (self-attention KV at the head, cross KV filled)."""
    cd = compute_dtype
    S = tokens.shape[1]
    enc = encode(params, audio, cfg, compute_dtype=cd, attn_impl=attn_impl)
    positions = torch.arange(S, device=tokens.device)
    x = _embed(params, tokens, positions, cd)
    ks, vs, xks, xvs = [], [], [], []
    for lp in params["decoder"]:
        h = _apply_ln(x, lp["ln1"], cfg.norm_eps)
        attn, kv = L.attention_block(h, lp["self_attn"], cfg, positions,
                                     causal=True, return_kv=True,
                                     compute_dtype=cd, attn_impl=attn_impl)
        x = x + attn
        h = _apply_ln(x, lp["ln2"], cfg.norm_eps)
        ckv = _cross_kv(enc, lp["cross_attn"], cd)
        x = x + _cross_attn(h, lp["cross_attn"], ckv, cd)
        h = _apply_ln(x, lp["ln3"], cfg.norm_eps)
        x = x + L.mlp_block(h, lp["mlp"], gated=False, compute_dtype=cd)
        ks.append(kv["k"].to(cd))
        vs.append(kv["v"].to(cd))
        xks.append(ckv["k"].to(torch.bfloat16))
        xvs.append(ckv["v"].to(torch.bfloat16))
    logits = T.logits_fn(params, x, cfg, cd)
    pad = cache_len - S
    if pad < 0:
        raise ValueError(f"prompt {S} longer than cache {cache_len}")
    widths = (0, 0, 0, 0, 0, pad)          # F.pad order: last dim first
    return logits, {
        "k": F.pad(torch.stack(ks), widths),
        "v": F.pad(torch.stack(vs), widths),
        "xk": torch.stack(xks),
        "xv": torch.stack(xvs),
        "length": torch.tensor(S, dtype=torch.long, device=x.device),
    }


def _cross_decode(h, p, xk, xv, cfg, cd, tp, seq_axis):
    """The cross-attention of one decode step over the held cross KV
    ``xk``/``xv`` ``(B, T, H or H/tp, Dh)``: split by heads like the
    query heads, whole (this rank's heads read), or split along the
    frames over ``seq_axis`` (`layers.seq_split_attention`, every head's
    query)."""
    if seq_axis is not None:
        q = L.split_matmul("bsd,dhk->bshk", h, p["wq"], cd, tp)
        if tp is not None:
            q = L.heads_whole(q, tp)
        valid = torch.ones((1, xk.shape[1]), dtype=torch.bool,
                           device=xk.device)
        out = L.seq_split_attention(q, xk, xv, valid, seq_axis,
                                    cache_rounding=False)
        if tp is not None:
            hl = p["wo"].shape[0]
            out = out[:, :, grp.rank(tp) * hl:(grp.rank(tp) + 1) * hl]
        return L.split_matmul("bshk,hkd->bsd", out, p["wo"], cd, tp,
                              reduce=True)
    if tp is not None and xk.shape[2] == cfg.num_heads:
        hl = cfg.num_heads // tp.size
        xk = xk[:, :, grp.rank(tp) * hl:(grp.rank(tp) + 1) * hl]
        xv = xv[:, :, grp.rank(tp) * hl:(grp.rank(tp) + 1) * hl]
    return _cross_attn(h, p, {"k": xk, "v": xv}, cd, tp)


def decode_step(params, cache, tokens: torch.Tensor, cfg: ModelConfig, *,
                compute_dtype=torch.bfloat16, attn_impl: str = "auto",
                tp=None, seq_axis=None, cross_seq_axis=None):
    """tokens: (B, 1); returns (logits (B, V), new_cache). The
    self-attention cache is dense or paged and ``length`` a scalar or a
    ``(B,)`` tensor, as in ``transformer.decode_step`` (the token's k/v
    written in place); each row's learned position is ``pos[length %
    max_positions]``. The cross KV ``xk``/``xv`` pass through unchanged.
    Over ``tp`` (``launch/steps.py``'s decode step) the blocks are
    tensor-parallel and the embedding and the logits vocab-parallel, on
    the held cache blocks (`_cross_decode`); ``seq_axis`` as in
    ``transformer.decode_step``, ``cross_seq_axis`` the axis the cross
    KV's frames are split over."""
    cd = compute_dtype
    length = torch.as_tensor(cache["length"], device=tokens.device)
    # absolute position of this token: (1,) shared, or (B, 1) per row
    positions = length[None] if length.dim() == 0 else length[:, None]
    x = _embed(params, tokens, positions, cd,
               tp=L.split(tp, L.pad_vocab(cfg.vocab_size)))
    xtp = L.split(tp, cfg.num_heads)
    for i, lp in enumerate(params["decoder"]):
        lp = L.gathered(lp)
        h = _apply_ln(x, lp["ln1"], cfg.norm_eps)
        attn, _ = L.attention_block(
            h, lp["self_attn"], cfg, positions, causal=True,
            kv_cache=L.decode_kv(cache, i, length, seq_axis),
            compute_dtype=cd, attn_impl=attn_impl, tp=tp)
        x = x + attn
        h = _apply_ln(x, lp["ln2"], cfg.norm_eps)
        x = x + _cross_decode(h, lp["cross_attn"], cache["xk"][i],
                              cache["xv"][i], cfg, cd, xtp, cross_seq_axis)
        h = _apply_ln(x, lp["ln3"], cfg.norm_eps)
        x = x + L.mlp_block(h, lp["mlp"], gated=False, compute_dtype=cd,
                            tp=L.split(tp, cfg.d_ff))
    logits = T.logits_fn(params, x, cfg, cd, tp)[:, 0]
    return logits, {**L.kv_leaves(cache), "xk": cache["xk"],
                    "xv": cache["xv"], "length": length + 1}
