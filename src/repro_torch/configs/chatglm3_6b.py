"""chatglm3-6b [dense] — RoPE 2d (partial rotary), GQA kv=2. [arXiv:2406.12793]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    rotary_pct=0.5,          # ChatGLM's 2D RoPE: rotary on half of head_dim
    qkv_bias=True,
    source="arXiv:2406.12793",
)
