"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions over parameter dicts of tensors, in the reference's
layouts (``wq`` is ``(d, H, Dh)``, ``wo`` is ``(H, Dh, d)``, ``embed.out``
is ``(d, Vp)``), so the JAX package's params cross over unchanged
(``repro_torch.bridge``). The fused loss (``lm_head_loss``) and
``cross_entropy`` are here for training; the gradient release points of
the backward-overlapped sync (ROADMAP.md Queue 1 step 9) and the sharding
constraints, which are identities on one device, are left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
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
    numbers: the draws come from ``gen``, on the generator's device)."""
    fan_in = fan_in if fan_in is not None else shape[0]
    x = torch.randn(tuple(shape), generator=gen, device=gen.device)
    return (x * fan_in ** -0.5).to(device=device, dtype=dtype)


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
):
    """Returns (out, new_kv) — new_kv is None unless kv_cache/return_kv given.

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
    """
    cd = compute_dtype
    xc = x.to(cd)
    q = torch.einsum("bsd,dhk->bshk", xc, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", xc, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", xc, p["wv"].to(cd))
    if "bq" in p:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    if not cfg.learned_pos and cfg.num_heads:
        q = apply_rope(q, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)
        k = apply_rope(k, positions, rotary_pct=cfg.rotary_pct, theta=cfg.rope_theta)

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
        slot = length % T
        rows = torch.arange(B, device=ck.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        new_len = length + 1
        new_kv = {"k": ck, "v": cv, "length": new_len}
        slot_pos = ring_slot_positions(new_len, T)
        out = cache_attention(q, ck, cv, positions, slot_pos, window=window)
    else:
        out = ops.attention(q, k, v, causal=causal, window=window,
                            impl=attn_impl)
        if return_kv:
            new_kv = {"k": k, "v": v}
    out = torch.einsum("bshk,hkd->bsd", out.to(cd), p["wo"].to(cd))
    return out.to(x.dtype), new_kv


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


def decode_kv(cache, i: int, length):
    """Layer ``i``'s decode cache, dense or paged, from a family cache
    whose KV leaves are stacked on a leading layer axis (``k``/``v`` or
    ``k_pool``/``v_pool``; the block tables are shared by the layers)."""
    if "block_tables" in cache:
        return {"k_pool": cache["k_pool"][i], "v_pool": cache["v_pool"][i],
                "block_tables": cache["block_tables"], "length": length}
    return {"k": cache["k"][i], "v": cache["v"][i], "length": length}


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
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    cd = compute_dtype
    xc = x.to(cd)
    up = torch.einsum("bsd,df->bsf", xc, p["w_up"].to(cd))
    if gated:
        gate = torch.einsum("bsd,df->bsf", xc, p["w_gate"].to(cd))
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")      # jax.nn.gelu's default
    out = torch.einsum("bsf,fd->bsd", h, p["w_down"].to(cd))
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
    return {
        "tok": dense_init(gen, (vp, cfg.d_model), cfg.d_model, **kw),
        "out": dense_init(gen, (cfg.d_model, vp), cfg.d_model, **kw),
        "final_norm": torch.ones((cfg.d_model,), **kw),
    }


def unembed(x: torch.Tensor, p: Params, cfg: ModelConfig,
            compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    logits = torch.einsum("bsd,dv->bsv", x.to(compute_dtype),
                          p["out"].to(compute_dtype))
    # mask padded vocab columns so softmax/argmax never pick them
    V = cfg.vocab_size
    if logits.shape[-1] != V:
        logits[..., V:] = NEG_INF
    return logits


def _chunk_nll(x, labels, w, V: int, compute_dtype):
    """(sum of the masked NLL, count of counted labels) of one chunk of
    rows: its logits exist only inside this call."""
    logits = torch.einsum("bsd,dv->bsv", x.to(compute_dtype), w)
    if logits.shape[-1] != V:
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < V, logits,
                             torch.full((), NEG_INF, dtype=logits.dtype,
                                        device=logits.device))
    lf = logits.float()
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    mask = (labels >= 0) & (labels < V)
    picked = torch.gather(lf, -1,
                          torch.where(mask, labels, 0).long()[..., None])
    maskf = mask.float()
    return torch.sum((lse - picked[..., 0]) * maskf), torch.sum(maskf)


def lm_head_loss(hidden: torch.Tensor, p: Params, labels: torch.Tensor,
                 cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
                 chunk: int = 512) -> torch.Tensor:
    """Fused final-norm + unembed + CE, chunked over the sequence with
    recomputation (``torch.utils.checkpoint`` per chunk, as the
    reference's ``jax.checkpoint``): the (tokens x vocab) logits exist
    at most ``chunk`` rows at a time, in the forward and the backward.
    Padded vocab columns are -1e30; labels outside [0, V) count as no
    token."""
    x = rms_norm(hidden, p["final_norm"], cfg.norm_eps)
    B, S, d = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    w = p["out"].to(compute_dtype)
    nlls, cnts = [], []
    for i in range(0, S + pad, c):
        nll, cnt = checkpoint(_chunk_nll, x[:, i:i + c], labels[:, i:i + c],
                              w, cfg.vocab_size, compute_dtype,
                              use_reentrant=False)
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
