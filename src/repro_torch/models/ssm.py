"""Mamba2 (SSD) block: projections + causal depthwise conv + selective state
space scan, with O(1)-state decode (port of ``repro/models/ssm.py``).
[arXiv:2405.21060]

Params are ``{"embed": {...}, "layers": [{"ssm": {...}, "ln": ...}, ...]}``;
the decode cache keeps the reference's layer-stacked ``(L, B, ...)``
leaves: ``conv`` in bf16 (even at fp32 compute) and ``ssd`` in fp32.
Training: ``loss_fn``, through the SSD chunk kernel's autograd function
(``ssd_scan.SSDChunk``) with ``ssd_impl="auto"``; each layer's params
pass a gradient release point ``("layers", i)``, and ``remat``
recomputes each layer in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_state


def proj_dim(cfg: ModelConfig) -> int:
    # [z (d_inner) | xBC (d_inner + 2N) | dt (H)]
    return 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads


def ssm_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
               device="cpu"):
    """One layer's params (the reference's per-layer slice)."""
    d, H = cfg.d_model, cfg.ssm_heads
    kw = dict(dtype=dtype, device=device)
    # A in [1, 16) as in mamba2 init; dt_bias ~ softplus^-1(dt) left at zeros
    a_init = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
    return {
        "in_proj": L.dense_init(gen, (d, proj_dim(cfg)), d, **kw),
        "conv_w": torch.full((cfg.d_conv, conv_dim(cfg)), 1.0 / cfg.d_conv,
                             **kw),
        "conv_b": torch.zeros((conv_dim(cfg),), **kw),
        "A_log": a_init.to(**kw),
        "D": torch.ones((H,), **kw),
        "dt_bias": torch.zeros((H,), **kw),
        "norm": torch.ones((cfg.d_inner,), **kw),
        "out_proj": L.dense_init(gen, (cfg.d_inner, d), cfg.d_inner, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, S, Cd); w: (W, Cd).

    With ``state`` ((B, W-1, Cd), decode history) returns (y, new_state);
    the history and x are concatenated in their promoted dtype, as
    ``jnp.concatenate`` promotes.
    """
    W = w.shape[0]
    if state is not None:
        common = torch.promote_types(state.dtype, x.dtype)
        xin = torch.cat([state.to(common), x.to(common)], dim=1)  # (B, W-1+S, Cd)
        new_state = xin[:, -(W - 1):, :]
    else:
        xin = F.pad(x, (0, 0, W - 1, 0))
        new_state = None
    y = sum(xin[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(W))
    y = y + b[None, None, :]
    return F.silu(y), new_state


def _split_proj(zxbcdt, cfg: ModelConfig):
    di, N = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * N]
    dt = zxbcdt[..., 2 * di + 2 * N:]
    return z, xBC, dt


def ssm_block(
    x: torch.Tensor,              # (B, S, d)
    p: dict,
    cfg: ModelConfig,
    *,
    compute_dtype=torch.bfloat16,
    ssd_impl: str = "auto",
    state=None,                   # decode: {"conv": (B,W-1,Cd), "ssd": (B,H,N,P)}
    return_state: bool = False,   # prefill: sequence mode + final decode state
):
    """Returns (out, new_state) — new_state None unless ``state`` given or
    ``return_state`` (prefill: sequence-mode outputs plus the conv/ssd state
    a subsequent ``decode_step`` continues from)."""
    cd = compute_dtype
    B_, S, _ = x.shape
    H, N, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    di = cfg.d_inner

    zxbcdt = torch.einsum("bsd,dp->bsp", x.to(cd), p["in_proj"].to(cd))
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    new_state = None
    if state is None:
        if return_state:
            # zero conv state == the zero-padding of the stateless path, so
            # outputs are identical AND we get the final conv history.
            zero = torch.zeros((B_, p["conv_w"].shape[0] - 1, xBC.shape[-1]),
                               dtype=torch.bfloat16, device=x.device)
            xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(cd),
                                           p["conv_b"].to(cd), zero)
        else:
            xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(cd),
                                           p["conv_b"].to(cd))
        xs = xBC[..., :di].reshape(B_, S, H, P)
        Bm = xBC[..., di:di + N]
        Cm = xBC[..., di + N:]
        y = ops.ssd(xs, dt, A, Bm, Cm, p["D"].float(),
                    chunk=min(cfg.ssm_chunk, S), impl=ssd_impl)
        y = y.reshape(B_, S, di)
        if return_state:
            # closed form of the decode recurrence
            #   state_t = state_{t-1} * exp(dt_t A) + dt_t B_t (x) x_t
            # after S steps: state_S = sum_t exp(A (D_S - D_t)) dt_t B_t x_t
            # with D the inclusive cumsum of dt.
            cum = torch.cumsum(dt, dim=1)                      # (B,S,H)
            decay = torch.exp((cum[:, -1:] - cum) * A[None, None, :])
            ssd_state = torch.einsum("bsh,bsn,bshp->bhnp", dt * decay,
                                     Bm.float(), xs.float())
            new_state = {"conv": conv_state, "ssd": ssd_state}
    else:
        xBC, conv_state = _causal_conv(xBC, p["conv_w"].to(cd),
                                       p["conv_b"].to(cd), state["conv"])
        xs = xBC[..., :di].reshape(B_, S, H, P)[:, 0]        # (B,H,P)
        Bm = xBC[:, 0, di:di + N]                            # (B,N)
        Cm = xBC[:, 0, di + N:]
        dt0 = dt[:, 0]                                       # (B,H)
        a = torch.exp(dt0 * A[None, :])                      # (B,H)
        upd = torch.einsum("bh,bn,bhp->bhnp", dt0, Bm.float(), xs.float())
        ssd_state = state["ssd"] * a[..., None, None] + upd
        y = torch.einsum("bn,bhnp->bhp", Cm.float(), ssd_state)
        y = y + xs.float() * p["D"].float()[None, :, None]
        y = y.reshape(B_, 1, di).to(cd)
        new_state = {"conv": conv_state, "ssd": ssd_state}

    # gated RMSNorm then out-projection
    y = y.float() * F.silu(z.float())
    y = L.rms_norm(y.to(cd), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y.to(cd), p["out_proj"].to(cd))
    return out.to(x.dtype), new_state


def init_ssm_state(cfg: ModelConfig, batch: int, layers: int,
                   dtype=torch.float32, device="cpu"):
    return {
        "conv": torch.zeros((layers, batch, cfg.d_conv - 1, conv_dim(cfg)),
                            dtype=torch.bfloat16, device=device),
        "ssd": torch.zeros((layers, batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# full mamba2 model (cfg.family == "ssm")
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                device="cpu"):
    kw = dict(dtype=dtype, device=device)
    embed = L.embed_params(gen, cfg, **kw)
    layers = [{"ssm": ssm_params(gen, cfg, **kw),
               "ln": torch.ones((cfg.d_model,), **kw)}
              for _ in range(cfg.num_layers)]
    return {"embed": embed, "layers": layers}


def mamba_layer(x, lp, cfg, *, compute_dtype, **kw):
    h = L.rms_norm(x, lp["ln"], cfg.norm_eps)
    y, ns = ssm_block(h, lp["ssm"], cfg, compute_dtype=compute_dtype, **kw)
    return x + y, ns


def mamba_layers(x, params, cfg: ModelConfig, indices, *, compute_dtype,
                 ssd_impl, remat: bool = False):
    """Run the mamba layers ``indices`` of ``params["layers"]`` in order.
    Each layer's params pass the FSDP gather and the release point
    ``("layers", i)`` outside the checkpoint, so a recompute fires neither
    again; ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` around the
    reference's scan body)."""
    def body(x, lp):
        y, _ = mamba_layer(x, lp, cfg, compute_dtype=compute_dtype,
                           ssd_impl=ssd_impl)
        return y

    for i in indices:
        lp = L.grad_release(("layers", i),
                            L.gathered(params["layers"][i]))
        x = checkpoint(body, x, lp, use_reentrant=False) if remat \
            else body(x, lp)
    return x


def forward(params, embeds, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            ssd_impl="auto", remat: bool = False):
    """embeds: (B, S, d) already-embedded inputs. Returns final hidden (B,S,d)."""
    return mamba_layers(embeds, params, cfg, range(len(params["layers"])),
                        compute_dtype=compute_dtype, ssd_impl=ssd_impl,
                        remat=remat)


def loss_fn(params, batch, cfg: ModelConfig, *, compute_dtype=torch.bfloat16,
            ssd_impl="auto", remat: bool = False, tp=None):
    """(mean next-token NLL, {}) of ``batch`` (``tokens``, ``labels``), as
    the reference's ``ssm.loss_fn``. Over ``tp`` only the embedding and
    the head are split (vocab-parallel); the mamba layers run whole on
    every rank."""
    x = T.embed_tokens(params, batch["tokens"], cfg, compute_dtype, tp=tp)
    h = forward(params, x, cfg, compute_dtype=compute_dtype,
                ssd_impl=ssd_impl, remat=remat)
    loss = L.lm_head_loss(h, params["embed"], batch["labels"], cfg,
                          compute_dtype=compute_dtype, tp=tp)
    return loss, {}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype=torch.bfloat16, device="cpu"):
    del cache_len, dtype  # O(1) state, in the reference's dtypes
    return init_ssm_state(cfg, batch, cfg.num_layers, device=device)


def decode_step(params, cache, tokens, cfg: ModelConfig, *,
                compute_dtype=torch.bfloat16):
    """tokens: (B, 1); returns (logits (B, V), new cache)."""
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    convs, ssds = [], []
    for i, lp in enumerate(params["layers"]):
        x, ns = mamba_layer(x, lp, cfg, compute_dtype=compute_dtype,
                            state={"conv": cache["conv"][i],
                                   "ssd": cache["ssd"][i]})
        convs.append(ns["conv"])
        ssds.append(ns["ssd"])
    logits = T.logits_fn(params, x, cfg, compute_dtype)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}


def prefill(params, tokens, cfg: ModelConfig, cache_len: int, *,
            compute_dtype=torch.bfloat16, ssd_impl="auto"):
    """Run the prompt in sequence mode, returning (logits, decode state).

    A prompt longer than ``cfg.ssm_chunk`` must be a multiple of it (the
    chunked scan's ``S % chunk`` rule)."""
    del cache_len  # O(1) state
    check_prompt_len(cfg, tokens.shape[1])
    x = T.embed_tokens(params, tokens, cfg, compute_dtype)
    convs, ssds = [], []
    for lp in params["layers"]:
        x, ns = mamba_layer(x, lp, cfg, compute_dtype=compute_dtype,
                            ssd_impl=ssd_impl, return_state=True)
        convs.append(ns["conv"])
        ssds.append(ns["ssd"])
    logits = T.logits_fn(params, x, cfg, compute_dtype)
    return logits, {"conv": torch.stack(convs), "ssd": torch.stack(ssds)}


def check_prompt_len(cfg: ModelConfig, S: int) -> None:
    """The chunked scan runs ``min(ssm_chunk, S)``-step chunks, so a prompt
    longer than the chunk must be a multiple of it."""
    if S > cfg.ssm_chunk and S % cfg.ssm_chunk:
        lo = cfg.ssm_chunk * (S // cfg.ssm_chunk)
        raise ValueError(
            f"prompt of {S} tokens: an SSM prompt longer than the chunk "
            f"({cfg.ssm_chunk}) must be a multiple of it (e.g. {lo} or "
            f"{lo + cfg.ssm_chunk})")
