"""Uniform model API (port of ``repro/models/registry.py``): the dense,
MoE, SSM and hybrid families."""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hybrid, moe_model, ssm, transformer

_FAMILY = {"dense": transformer, "moe": moe_model, "ssm": ssm,
           "hybrid": hybrid}

# families the port does not have yet, and the ROADMAP.md Queue 1 slice
# that brings each
_LATER = {
    "encdec": "slice (e): the remaining families",
    "vlm": "slice (e): the remaining families",
}


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: torch.device
    init: Callable[[torch.Generator], Any]             # generator -> params
    init_cache: Callable[..., dict]                    # (batch, cache_len) -> cache
    decode_step: Callable[..., tuple]                  # (params, cache, tokens)
    prefill: Callable[..., tuple]                      # (params, tokens, cache_len)


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
    return ModelAPI(
        cfg=cfg,
        device=dev,
        init=functools.partial(mod.init_params, cfg=cfg, dtype=param_dtype,
                               device=dev),
        init_cache=functools.partial(mod.init_cache, cfg, device=dev),
        decode_step=functools.partial(mod.decode_step, cfg=cfg, **dkw),
        prefill=lambda params, tokens, cache_len: mod.prefill(
            params, tokens, cfg, cache_len, **pkw),
    )
