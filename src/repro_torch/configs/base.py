"""Model config dataclass (a copy of ``repro.configs.base.ModelConfig``).

The port keeps its own copy so that it imports nothing of the JAX
package; the fields, ``resolved_head_dim`` and ``reduced()`` are the
reference's, so a config names the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (transformer backbone scope only)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    source: str = ""   # citation for the config

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0
    capacity_factor: float = 1.25

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    d_conv: int = 4
    expand: int = 2

    # --- hybrid (zamba2) ---
    attn_every: int = 0  # apply the shared attention block every N ssm blocks

    # --- position / attention flavour ---
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0  # chatglm/glm4 use partial ("2d") rotary
    qkv_bias: bool = False
    learned_pos: bool = False  # whisper
    sliding_window: int = 0    # 0 = full attention (training default)

    # --- enc-dec (whisper backbone) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed source frame count (precomputed conv features)

    # --- VLM (llava) ---
    num_patches: int = 0  # precomputed anyres patch-embedding count (stub frontend)

    max_positions: int = 4096  # learned-pos table size (whisper decoder)
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Can serve 500k-token contexts (SSM state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        head_dim = min(self.resolved_head_dim, 64)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep the GQA ratio when possible
        if self.num_kv_heads < self.num_heads:
            num_kv = max(1, num_heads // max(1, self.num_heads // self.num_kv_heads))
        kw = dict(
            num_layers=2,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
        )
        if self.num_experts:
            kw.update(num_experts=4, experts_per_token=min(2, self.experts_per_token))
        if self.dense_d_ff:
            kw.update(dense_d_ff=min(self.dense_d_ff, 512))
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=1)
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=min(self.encoder_seq, 64))
        if self.num_patches:
            kw.update(num_patches=16)
        return self.replace(**kw)
