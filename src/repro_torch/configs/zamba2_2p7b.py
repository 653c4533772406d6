"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,           # mamba2 blocks
    d_model=2560,
    num_heads=32,            # the shared attention block (GQA kv=32 i.e. MHA)
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,              # shared block MLP
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    expand=2,
    attn_every=6,            # shared attention block interleaved every 6 mamba blocks
    source="arXiv:2411.15242",
)
