"""whisper-large-v3 [audio] — enc-dec transformer backbone; conv/mel frontend is a
stub supplying precomputed frame embeddings. [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,           # decoder layers
    encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    learned_pos=True,
    encoder_seq=1500,        # 30 s of audio at 50 Hz after the (stubbed) conv frontend
    source="arXiv:2212.04356",
)
