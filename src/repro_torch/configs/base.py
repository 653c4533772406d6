"""Config dataclasses (copies of ``repro.configs.base``): ``ModelConfig``,
``ShapeConfig``, ``CollectiveConfig`` with ``validate_collectives``,
``ParallelConfig`` and ``TrainConfig``.

The port keeps its own copy so that it imports nothing of the JAX
package; the fields, ``resolved_head_dim`` and ``reduced()`` are the
reference's, so a config names the same model in both packages, and
``Communicator.from_config`` reads a ``CollectiveConfig`` by attribute
as the reference's does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Union


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


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclass(frozen=True)
class CollectiveConfig:
    """How collectives are implemented/tuned — the paper's technique.

    algorithm: "xla" uses the backend's built-in collective (baseline, =
    MPI's hardcoded default in the survey); otherwise one of the
    registered algorithm names ("ring", "recursive_halving", ...).
    segment_bytes: 0 = unsegmented.
    decision: optional tuned DecisionTable that overrides the static fields
    per (op, bytes, axis size) — either a path to the serialized JSON
    artifact or an already-loaded DecisionTable instance.
    """

    algorithm: str = "xla"
    segment_bytes: int = 0
    decision: Optional[Union[str, Any]] = None
    a2a_algorithm: str = "xla"     # MoE expert-dispatch all-to-all algorithm
    overlap_microbatches: int = 1  # >1 accumulates over k microbatches (§4.1)
    bucket_bytes: Optional[int] = None  # fusion-bucket budget for the
    # bucketed, overlap-pipelined gradient sync; None = adopt the
    # artifact's tuned schedule (sequential per-leaf when it carries
    # none), 0 = force the per-leaf path even over a schedule-carrying
    # artifact
    overlap_backward: bool = False  # backward-overlapped streamed sync
    # (--overlap-backward on the train CLI)


class CollectiveConfigError(ValueError):
    """An unsupported collective-config combination, detected at
    config/CLI parse time (not mid-step) with the flags to change."""


def validate_collectives(coll: "CollectiveConfig",
                         parallel: "ParallelConfig",
                         tuned: Optional[bool] = None) -> None:
    """Reject collective/parallel combinations the step builder cannot
    execute, naming the flags that conflict. ``tuned`` is whether the
    resolved communicator takes the explicit tuned-sync path (defaults
    to what the config alone implies: a non-xla algorithm, a decision
    artifact, or a fusion-bucket budget)."""
    if tuned is None:
        tuned = (coll.algorithm != "xla" or coll.decision is not None
                 or bool(coll.bucket_bytes))
    if tuned and parallel.shard_params_over_data:
        raise CollectiveConfigError(
            "tuned gradient sync and FSDP param sharding are mutually "
            "exclusive (DESIGN.md §3): tuned sync all-reduces full "
            "gradients inside shard_map, FSDP reduce-scatters per-shard. "
            "Drop --fsdp (ParallelConfig.shard_params_over_data) or run "
            "the XLA path (--collective xla, no --tuning-table / "
            "--bucket-mb).")
    if coll.overlap_backward and parallel.shard_params_over_data:
        raise CollectiveConfigError(
            "--overlap-backward requires non-FSDP params: release points "
            "sync full per-layer gradients, FSDP shards them. Drop "
            "--fsdp (ParallelConfig.shard_params_over_data) or "
            "--overlap-backward.")
    if coll.overlap_backward and not tuned:
        raise CollectiveConfigError(
            "--overlap-backward needs the tuned gradient-sync path to "
            "issue release-point collectives: pass --tuning-table, "
            "--collective <algorithm>, or --bucket-mb (the plain XLA "
            "path has no explicit sync to overlap).")
    if coll.overlap_backward and coll.overlap_microbatches > 1:
        raise CollectiveConfigError(
            "--overlap-backward and --overlap-microbatches are mutually "
            "exclusive: release points would sync partial gradients once "
            "per microbatch (k x the communication). Set "
            "--overlap-microbatches 1 or drop --overlap-backward.")


@dataclass(frozen=True)
class ParallelConfig:
    data_axes: tuple = ("data",)   # ("pod","data") on multi-pod meshes
    model_axis: str = "model"
    remat: str = "none"            # none | full | selective
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # beyond-paper knobs exercised during hillclimbing:
    shard_params_over_data: bool = False  # ZeRO-3 style (FSDP) param sharding
    seq_shard_activations: bool = True    # shard long sequences over "model"
    gather_in_compute_dtype: bool = False  # cast fp32 master params to bf16
    # BEFORE the FSDP all-gather (halves gather bytes; grads still fp32)


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    collectives: CollectiveConfig = field(default_factory=CollectiveConfig)
    lr: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    seed: int = 0
