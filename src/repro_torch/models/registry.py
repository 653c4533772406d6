"""Uniform model API (port of ``repro/models/registry.py``): the dense,
MoE, SSM and hybrid families, and the training batches.

Training (``ModelAPI.loss``) is ported for the dense family; the other
families' ``loss`` raises ``NotImplementedError`` naming the ROADMAP.md
Queue 1 step that brings it."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import hybrid, moe_model, ssm, transformer

_FAMILY = {"dense": transformer, "moe": moe_model, "ssm": ssm,
           "hybrid": hybrid}

# families the port does not have yet, and the ROADMAP.md Queue 1 slice
# that brings each
_LATER = {
    "encdec": "slice (e): the remaining families",
    "vlm": "slice (e): the remaining families",
}

# families the port cannot train yet, and the ROADMAP.md Queue 1 step
# that brings each
_TRAIN_LATER = {
    "moe": "step 8 (MoE expert parallelism inside the training step)",
    "ssm": "step 9 (the SSD backward for SSM/hybrid training)",
    "hybrid": "step 9 (the SSD backward for SSM/hybrid training)",
    "vlm": "step 10 (the remaining families)",
    "encdec": "step 10 (the remaining families)",
}


def check_trainable(family: str) -> None:
    """Raise ``NotImplementedError`` naming the step that brings the
    family's training, unless the port trains it (dense)."""
    if family != "dense":
        raise NotImplementedError(
            f"training the {family} family is not ported yet: it comes "
            f"with ROADMAP.md Queue 1 {_TRAIN_LATER[family]}")


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]             # generator -> params
    init_cache: Callable[..., dict]                    # (batch, cache_len) -> cache
    decode_step: Callable[..., tuple]                  # (params, cache, tokens)
    prefill: Callable[..., tuple]                      # (params, tokens, cache_len)
    loss: Callable[..., tuple] = None                  # (params, batch)


def resolve_device(device) -> torch.device:
    """``cuda`` (the default everywhere) or ``cpu``; asking for cuda on a
    machine without a GPU raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def build_model(
    cfg: ModelConfig,
    *,
    window: int = 0,
    compute_dtype=torch.bfloat16,
    param_dtype=torch.float32,
    attn_impl: str = "auto",
    ssd_impl: str = "auto",
    device="cuda",
    remat: bool = False,
) -> ModelAPI:
    if cfg.family not in _FAMILY:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: it comes with "
            f"{_LATER.get(cfg.family, 'a later slice')} (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    mod = _FAMILY[cfg.family]
    # the per-family keywords, as the reference passes them
    dkw: dict = {"compute_dtype": compute_dtype}
    if cfg.family in ("dense", "moe", "hybrid"):
        dkw["window"] = window
    pkw = dict(dkw)
    if cfg.family in ("dense", "moe", "hybrid"):
        pkw["attn_impl"] = attn_impl
    if cfg.family in ("ssm", "hybrid"):
        pkw["ssd_impl"] = ssd_impl
    if cfg.family == "dense":
        loss = functools.partial(mod.loss_fn, cfg=cfg, remat=remat, **pkw)
    else:
        loss = functools.partial(_loss_later, cfg.family)
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=functools.partial(mod.init_params, cfg=cfg, dtype=param_dtype,
                               device=dev),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev),
        decode_step=functools.partial(mod.decode_step, cfg=cfg, **dkw),
        prefill=lambda params, tokens, cache_len: mod.prefill(
            params, tokens, cfg, cache_len, **pkw),
        loss=loss,
    )


def _loss_later(family, *args, **kw):
    check_trainable(family)


# ---------------------------------------------------------------------------
# batch construction
# ---------------------------------------------------------------------------
def train_batch_shapes(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Shapes/dtypes of a global training (or prefill) batch: tokens and
    labels. The VLM and enc-dec batches (patches, audio) come with their
    families' training, ROADMAP.md Queue 1 step 10."""
    if cfg.family in ("vlm", "encdec"):
        check_trainable(cfg.family)
    B, S = shape.global_batch, shape.seq_len
    return {
        "tokens": ((B, S), torch.int32),
        "labels": ((B, S), torch.int32),
    }


def make_train_batch(cfg: ModelConfig, shape: ShapeConfig,
                     seed: int = 0) -> dict:
    """A random global batch from numpy's generator seeded with ``seed``
    (the reference's draws), as int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return {name: rng.integers(0, cfg.vocab_size, size=shp, dtype=np.int32)
            for name, (shp, _) in train_batch_shapes(cfg, shape).items()}
