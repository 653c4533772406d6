"""olmoe-1b-7b [moe] — 64 experts, top-8. [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,               # per-expert FFN width
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    source="arXiv:2409.02060",
)
