"""Architecture registry of the port: ``get_config("<arch-id>")`` and the
four shapes.

The dense, MoE, SSM and hybrid families are here so far; the encoder-
decoder and vision-language configs arrive with the slice that ports
their families (see ROADMAP.md Queue 1). arctic-480b does not fit one
card; it is here for its reduced variant (a dense residual MLP beside
the experts).
"""
from repro_torch.configs.base import (
    CollectiveConfig,
    ModelConfig,
    ParallelConfig,
    ShapeConfig,
    TrainConfig,
)
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.configs import (  # noqa: E402
    arctic_480b,
    chatglm3_6b,
    glm4_9b,
    mamba2_130m,
    olmoe_1b_7b,
    qwen2p5_3b,
    smollm_135m,
    zamba2_2p7b,
)

ARCHITECTURES = {
    m.CONFIG.name: m.CONFIG
    for m in (glm4_9b, smollm_135m, zamba2_2p7b, chatglm3_6b, mamba2_130m,
              qwen2p5_3b, olmoe_1b_7b, arctic_480b)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHITECTURES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[name]


__all__ = ["ARCHITECTURES", "CollectiveConfig", "ModelConfig",
           "ParallelConfig", "SHAPES", "ShapeConfig", "TrainConfig",
           "get_config", "get_shape"]
