"""Plain PyTorch oracles (the port of ``repro.kernels.ref``'s attention).

These are the reference semantics the kernels and the model are held
to. Only attention is here so far; ``ssd`` and ``segment_combine`` come
with the slices that port their kernels.
"""
from __future__ import annotations

import torch


def attention(
    q: torch.Tensor,          # (B, S, H, D)
    k: torch.Tensor,          # (B, T, KV, D)
    v: torch.Tensor,          # (B, T, KV, D)
    *,
    causal: bool = True,
    window: int = 0,          # 0 = full; else sliding window of this many keys
    q_offset: int = 0,        # absolute position of q[0] (for decode: T - S)
    scale: float | None = None,
) -> torch.Tensor:
    """Masked multi-head (GQA) attention, fp32 softmax accumulation."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    group = H // KV
    scale = scale if scale is not None else D ** -0.5

    qf = q.float() * scale
    # broadcast kv heads to q heads (jnp.repeat order: head h reads h // group)
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)

    logits = torch.einsum("bshd,bthd->bhst", qf, kf)
    q_pos = torch.arange(S, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # rows that are fully masked produce NaN from softmax(-inf); zero them
    row_has_key = mask.any(dim=-1)                        # (S,)
    probs = torch.where(row_has_key[None, None, :, None], probs,
                        torch.zeros((), device=q.device))
    out = torch.einsum("bhst,bthd->bshd", probs, vf)
    return out.to(q.dtype)


def attention_xla_chunked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int = 0, q_offset: int = 0,
    scale: float | None = None, chunk: int = 512,
) -> torch.Tensor:
    """Query-chunked attention: same math as ``attention``, one
    ``(B, H, chunk, T)`` score tile at a time instead of the whole
    ``(B, H, S, T)`` score tensor."""
    S = q.shape[1]
    if S <= chunk:
        return attention(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)
    outs = [attention(q[:, c0:c0 + chunk], k, v, causal=causal,
                      window=window, q_offset=q_offset + c0, scale=scale)
            for c0 in range(0, S, chunk)]
    return torch.cat(outs, dim=1)
