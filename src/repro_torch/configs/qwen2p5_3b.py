"""qwen2.5-3b [dense] — GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)
