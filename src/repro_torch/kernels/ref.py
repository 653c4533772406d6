"""Plain PyTorch oracles (the port of ``repro.kernels.ref``).

These are the reference semantics the kernels and the model are held
to: attention, the SSD scan and the segment combine.
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


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) — quadratic masked oracle
# ---------------------------------------------------------------------------
def ssd(
    x: torch.Tensor,         # (B, S, H, P)  head inputs
    dt: torch.Tensor,        # (B, S, H)     softplus'd step sizes (>0)
    A: torch.Tensor,         # (H,)          negative decay rates (A < 0)
    Bm: torch.Tensor,        # (B, S, N)     input projection (shared across heads)
    Cm: torch.Tensor,        # (B, S, N)     output projection
    D: torch.Tensor,         # (H,)          skip connection
) -> torch.Tensor:
    """y[t] = sum_{s<=t} C_t^T (prod_{r=s+1..t} e^{dt_r A}) dt_s B_s x_s + D x_t.

    O(S^2) masked form — the oracle for the chunked kernel.
    """
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    a = dtf * Af[None, None, :]                      # (B,S,H) log-decay per step
    cum = torch.cumsum(a, dim=1)                     # (B,S,H)
    diff = cum[:, :, None, :] - cum[:, None, :, :]   # (B,S,S,H) t,s
    S_len = x.shape[1]
    tri = torch.tril(torch.ones((S_len, S_len), dtype=torch.bool,
                                device=x.device))
    # mask the upper triangle BEFORE exp: it holds large positive
    # differences whose exp overflows
    diff = diff.masked_fill(~tri[None, :, :, None], float("-inf"))
    decay = torch.exp(diff)
    scores = torch.einsum("btn,bsn->bts", Cf, Bf)[..., None] * decay
    scores = scores * dtf[:, None, :, :]             # weight by dt_s
    y = torch.einsum("btsh,bshp->bthp", scores, xf)
    y = y + xf * D.float()[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
    Cm: torch.Tensor, D: torch.Tensor, *, chunk: int = 128,
) -> torch.Tensor:
    """Chunked linear-time SSD in plain PyTorch (the reference's XLA path)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk

    xf = x.float().reshape(Bsz, nc, chunk, H, P)
    dtf = dt.float().reshape(Bsz, nc, chunk, H)
    Bf = Bm.float().reshape(Bsz, nc, chunk, N)
    Cf = Cm.float().reshape(Bsz, nc, chunk, N)
    Af = A.float()

    a = dtf * Af[None, None, None, :]                # (B,nc,Q,H)
    cum = torch.cumsum(a, dim=2)                     # within-chunk cumulative
    total = cum[:, :, -1, :]                         # (B,nc,H)

    # --- intra-chunk (quadratic within chunk) ---
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    diff = diff.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    decay = torch.exp(diff)
    scores = torch.einsum("bctn,bcsn->bcts", Cf, Bf)[..., None] * decay
    scores = scores * dtf[:, :, None, :, :]
    y_intra = torch.einsum("bctsh,bcshp->bcthp", scores, xf)

    # --- chunk states: contribution of chunk c to the running state ---
    w = torch.exp(total[:, :, None, :] - cum) * dtf          # (B,nc,Q,H)
    chunk_states = torch.einsum("bcsh,bcsn,bcshp->bchnp", w, Bf, xf)

    # --- inter-chunk recurrence (tiny loop over nc), state BEFORE chunk ---
    gamma = torch.exp(total)                                 # (B,nc,H)
    state = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)
        state = state * gamma[:, c, :, None, None] + chunk_states[:, c]
    states_before = torch.stack(before, dim=1)               # (B,nc,H,N,P)

    # --- inter-chunk output: y_inter[t] = exp(cum[t]) C_t . state_before ---
    y_inter = torch.einsum("bcth,bctn,bchnp->bcthp", torch.exp(cum), Cf,
                           states_before)
    y = y_intra + y_inter
    y = y + xf * D.float()[None, None, None, :, None]
    return y.reshape(Bsz, S, H, P).to(x.dtype)


# ---------------------------------------------------------------------------
# segment combine (the ring-pipeline reduction step)
# ---------------------------------------------------------------------------
def segment_combine(acc: torch.Tensor, part: torch.Tensor,
                    op: str = "add") -> torch.Tensor:
    """Fused accumulate of an incoming ring segment into the local shard:
    fp32 math, cast back to ``acc``'s dtype."""
    a = acc.float()
    p = part.float()
    if op == "add":
        r = a + p
    elif op == "max":
        r = torch.maximum(a, p)
    elif op == "min":
        r = torch.minimum(a, p)
    else:
        raise ValueError(f"unknown op {op!r}")
    return r.to(acc.dtype)
