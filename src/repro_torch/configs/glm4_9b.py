"""glm4-9b [dense] — RoPE (partial), GQA kv=2. [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rotary_pct=0.5,  # GLM applies rotary to half the head dim ("2d" RoPE family)
    rope_theta=10000.0,
    qkv_bias=True,   # GLM-4 uses bias on QKV only
    source="hf:THUDM/glm-4-9b",
)
