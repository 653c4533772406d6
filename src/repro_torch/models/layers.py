"""Shared model building blocks (port of ``repro/models/layers.py``).

Plain functions over parameter dicts of tensors, in the reference's
layouts (``wq`` is ``(d, H, Dh)``, ``wo`` is ``(H, Dh, d)``, ``embed.out``
is ``(d, Vp)``), so the JAX package's params cross over unchanged
(``repro_torch.bridge``). Training-only pieces (gradient release points,
the fused loss) and the sharding constraints, which are identities on
one device, are left out.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

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
    kv_cache=None,                # optional dict(k=(B,T,KV,Dh), v=..., length)
    return_kv: bool = False,      # prefill: return this block's k/v for caching
    compute_dtype=torch.bfloat16,
    attn_impl: str = "auto",
):
    """Returns (out, new_kv) — new_kv is None unless kv_cache/return_kv given.

    Decode (``kv_cache`` given, one new token) takes ``length`` as a
    scalar, as the reference does, or as a ``(B,)`` tensor: each row then
    writes its own ring slot ``length[b] % T`` and sees its own valid
    slots. The token's k/v are written into ``kv_cache``'s tensors IN
    PLACE; the returned dict holds those same tensors.
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
    if kv_cache is not None:
        # decode: insert this step's k/v at slot `length % T` (ring-buffer when
        # T < full context, i.e. sliding-window serving)
        if x.shape[1] != 1:
            raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
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


def ring_slot_positions(length, T: int):
    """Absolute position stored in each ring-buffer slot after `length` writes.

    Slot i holds the greatest position p < length with p % T == i, or -1 if
    slot i has never been written. ``length`` scalar -> (T,); (B,) -> (B, T).
    """
    length = torch.as_tensor(length)
    i = torch.arange(T, device=length.device)
    ln = length[..., None]
    last = i + T * torch.div(ln - 1 - i, T, rounding_mode="floor")
    return torch.where(i < ln, last, torch.full_like(last, -1))


def cache_attention(q, ck, cv, q_pos, slot_pos, *, window=0):
    """Decode attention against a (possibly ring-buffered) KV cache.

    q: (B, 1, H, Dh); ck/cv: (B, T, KV, Dh); q_pos: (1,) or (B, 1)
    absolute; slot_pos: (T,) or (B, T) absolute position stored in each
    slot (-1 = empty).

    GQA is expressed by reshaping q to (KV, group); the cache is never
    repeated. As in the reference, the scaled q is cast to the cache
    dtype, both products accumulate in fp32, and the probabilities are
    cast to the cache dtype before the PV product. A bf16 ``matmul`` in
    PyTorch returns bf16, so both operands are upcast to fp32 for the
    product: the elementwise products of bf16 values are exact in fp32,
    which gives the fp32 result JAX's ``preferred_element_type`` does.
    """
    B, S, H, Dh = q.shape
    KV = ck.shape[2]
    group = H // KV
    qr = (q * (Dh ** -0.5)).reshape(B, S, KV, group, Dh).to(ck.dtype)
    logits = torch.einsum("bskgd,btkd->bkgst", qr.float(), ck.float())
    q_last = q_pos[..., 0]                        # () or (B,)
    valid = (slot_pos >= 0) & (slot_pos <= q_last[..., None])
    if window > 0:
        valid &= slot_pos > q_last[..., None] - window
    if valid.dim() == 1:
        valid = valid[None]
    valid = valid[:, None, None, None, :]         # (B or 1, 1, 1, 1, T)
    logits = torch.where(valid, logits,
                         torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(cv.dtype).float(),
                       cv.float())
    return out.reshape(B, S, H, Dh).to(q.dtype)


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
