"""arctic-480b [moe] — 128 experts top-2 with dense residual MLP.
[hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,               # per-expert FFN width
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    dense_residual=True,     # dense MLP in parallel with the MoE (Arctic design)
    dense_d_ff=4864,
    source="hf:Snowflake/snowflake-arctic-base",
)
