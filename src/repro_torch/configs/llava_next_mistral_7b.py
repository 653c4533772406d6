"""llava-next-mistral-7b [vlm] — Mistral-7B language backbone consuming precomputed
anyres patch embeddings (vision tower + projector stubbed).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    num_patches=2880,        # anyres tiling: 5 tiles x 576 patch tokens (stub)
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
