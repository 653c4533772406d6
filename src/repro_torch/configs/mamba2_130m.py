"""mamba2-130m [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,             # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,         # d_inner=1536 -> 24 SSD heads
    expand=2,
    source="arXiv:2405.21060",
)
